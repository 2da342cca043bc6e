"""ompi_tpu_torch.ft — the resilience plane (the port of ``ompi_tpu/ft``).

Two halves:

- :mod:`ompi_tpu_torch.ft.inject` — a deterministic fault-injection plane
  (the test surface Open MPI never shipped):
  drop/delay/corrupt btl frames, sever a peer connection, kill a rank
  at a named program point — all behind MCA vars and a
  zero-cost-when-off module gate.
- :mod:`ompi_tpu_torch.ft.detector` — a ring heartbeat failure detector
  (the PRRTE-daemon liveness role) feeding epoch-ordered failure
  events into :mod:`ompi_tpu_torch.runtime.ft`'s registry.

The consumption side (revoke/shrink/agree, request-level error
completion, elastic grad sync) lives where the state lives:
``core/rankcomm.py``, ``pml/perrank.py``, ``coll/ftagree.py``,
``models/transformer.py``.
"""
