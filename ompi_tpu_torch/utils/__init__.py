"""Utilities shared by the port's planes (profiling hooks, host
locality)."""
