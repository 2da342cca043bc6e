"""Public API surface (the ``ompi/mpi/c`` equivalent)."""
