"""mpiext/shortfloat — half-precision datatypes (the port of
``ompi_tpu/mpiext/shortfloat.py``).

Behavioral spec: ``ompi/mpiext/shortfloat`` — exposes
``MPIX_SHORT_FLOAT`` / ``MPIX_C_SHORT_FLOAT`` (and, where the compiler
supports it, bfloat16) as predefined datatypes usable in reductions.

Half precision is not an extension here — torch has float16 and
bfloat16 tensors on the card — so these are aliases into the core
datatype registry, provided for source parity with portable apps.
"""
from ompi_tpu_torch.core.datatype import BFLOAT16, FLOAT16

SHORT_FLOAT = FLOAT16          # MPIX_SHORT_FLOAT
C_SHORT_FLOAT = FLOAT16        # MPIX_C_SHORT_FLOAT
C_BF16 = BFLOAT16              # MPIX_C_BF16
