"""The flagship model built on the framework."""
