"""ompi_tpu_torch.osc — the one-sided communication framework.

Two execution models, one chapter of the standard:

- ``framework.Win`` — the stacked single-controller window (every
  rank's row in one ``(nranks, size)`` buffer on the communicator's
  device, updated in place);
- ``window.RmaWindow`` + ``win_allocate``/``win_create`` — the
  per-rank framework: component selection (``decision``), the shm
  segment component (``shm``), the active-message emulation
  (``pt2pt``), epoch/FT/telemetry policy (``window``, ``base``).
"""
from ompi_tpu_torch.osc.framework import Win  # noqa: F401
from ompi_tpu_torch.osc.window import (RmaWindow, win_allocate,  # noqa: F401
                                       win_create)
