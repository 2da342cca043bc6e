"""Command-line tools: ``mpirun``, ``mpitop``, ``tracedump``, ``info``,
``comm_method``, ``mpisync``, ``profile``, ``debuggers``, ``peruse``,
``mpilint``, ``checkparity``, ``checkall``, ``mpicc`` (the C ABI's
compiler wrapper) and ``mpmd_exec`` (the MPMD spawn shim)."""
