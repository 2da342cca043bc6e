"""Runtime: init/finalize and world binding."""
