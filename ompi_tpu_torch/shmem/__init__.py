"""OpenSHMEM over the port's RMA windows (the port of
``ompi_tpu/shmem``): ``ShmemCtx`` on the stacked single-controller
``Win``, ``perrank.ShmemRankCtx`` on the per-rank ``RankWindow``."""
from ompi_tpu_torch.shmem.api import ShmemCtx  # noqa: F401
