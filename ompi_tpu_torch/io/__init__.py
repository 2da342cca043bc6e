"""MPI-IO and checkpointing (the port of ``ompi_tpu/io``): ``File`` over
the fs, fbtl, fcoll and sharedfp sub-frameworks, ``perrank.RankFile``
for one process per rank, and ``checkpoint``."""
from ompi_tpu_torch.io.file import File, MODE_APPEND  # noqa: F401
from ompi_tpu_torch.io.file import (MODE_CREATE, MODE_RDONLY,  # noqa: F401
                                    MODE_RDWR, MODE_WRONLY, MODE_EXCL)
