"""MPI extensions — mirrors ``ompi/mpiext`` (the MPIX_* namespace).

The port of ``ompi_tpu/mpiext``: each extension is a module exporting
MPIX-style functions over the core. The fault-tolerance extension
(ftmpi, ULFM) is ported; the JAX package's accel, affinity and
shortfloat extensions are not yet.
"""
from ompi_tpu_torch.mpiext import ftmpi  # noqa: F401
