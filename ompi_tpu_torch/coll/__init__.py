"""Collective framework — mirrors ``ompi/mca/coll``.

Components:
- ``torch`` — the device component: collectives as tensor operations over
              the rank axis of the stacked tensor (the ``coll/xla`` role).
- ``basic`` — host/NumPy linear algorithms (fallback + correctness
              oracle, mirrors coll/basic).
- ``self``  — size-1 communicators (mirrors coll/self).
- ``nbc``   — nonblocking collectives as round schedules driven by the
              progress engine (mirrors coll/libnbc).
- ``compressed`` — quantized allreduce/allgather/reduce_scatter_block
              above ``torch``, selected while ``mpi_base_compress`` is on.
- ``han``   — two-level composition over low/up sub-communicators
              (priority 35; ``coll_han_split``).
- ``xhc``   — n-level ladder over the stacked rows (priority 25;
              ``coll_xhc_levels``).
- ``adapt`` — segmented event-driven ``ibcast_adapt``/``ireduce_adapt``
              over ``nbc`` schedules (extension entry points only).
- ``acoll`` — device-kind tuning hints; never a module.

``decision`` holds the per-collective algorithm tables the ``torch``
component selects its schedules from; ``tuned`` the dynamic-rules file
that overrides them, the probe-earned staging switch point, and the
``tuned`` component (priority 60) that routes numpy stacks between
``basic`` and ``torch``; and ``persistent`` the pre-bound
persistent-collective plans and the DDP-style bucket fuser behind
``*_init``/``Startall``.
"""
