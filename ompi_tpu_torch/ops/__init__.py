"""Hot-op kernels: hand-written CUDA (``csrc/``) behind torch wrappers,
each beside its plain torch version."""
