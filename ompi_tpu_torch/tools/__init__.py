"""Command-line tools: ``mpirun``."""
