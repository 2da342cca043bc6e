"""Command-line tools: ``mpirun``, ``mpitop``, ``tracedump``, ``info``,
``comm_method``, ``mpisync``, ``profile``, ``debuggers``, ``peruse``,
``mpilint``, ``checkparity`` and ``checkall``."""
