"""MPI extensions — mirrors ``ompi/mpiext`` (the MPIX_* namespace).

The port of ``ompi_tpu/mpiext``: each extension is a module exporting
MPIX-style functions over the core — fault tolerance (ftmpi, ULFM), the
accelerator support queries (accel), locality strings (affinity) and
the half-precision datatypes (shortfloat).
"""
from ompi_tpu_torch.mpiext import accel, affinity, ftmpi, shortfloat  # noqa: F401
