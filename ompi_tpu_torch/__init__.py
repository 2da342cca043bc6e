"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu.

The same communication framework with MPI semantics, on torch tensors:
a stacked ``(nranks, *local)`` tensor holds one row per rank on the
communicator's device (an NVIDIA card, or the CPU when the caller binds
the world there), and collectives lower to tensor operations over the
rank axis. The package keeps ``ompi_tpu``'s module layout, so each
module's counterpart sits at the same path:

- ``mca``         — framework/component selection, typed MCA vars
                    (env prefix ``OMPI_TPU_TORCH_MCA_``).
- ``core``        — communicators, groups, datatypes (predefined and
                    derived) and the convertor, ops, errhandlers,
                    requests (CUDA-event completion).
- ``coll``        — priority-selected collective components: ``torch``
                    (device), ``basic`` (host oracle), ``self``, ``nbc``
                    (nonblocking schedules); ``persistent`` plans and
                    bucket fusion.
- ``accelerator`` — buffer locus, H2D/D2H copies, CUDA streams/events.
- ``runtime``     — init/finalize, world binding (single-controller and
                    per-rank), the progress engine.
- ``pml``         — the stacked point-to-point matching engine and its
                    pessimist message-logging variant (vprotocol),
                    partitioned pt2pt on both tiers, and the per-rank
                    matching engine.
- ``btl``         — the per-rank byte planes: tcp, shared-memory rings,
                    their multiplexer, and the device payload plane over
                    IPC handles.
- ``tools``       — ``mpirun`` (``--per-rank -n N`` launches N rank
                    processes).
- ``topo``        — cartesian/graph/dist-graph topologies, device
                    neighbor collectives, treematch placement.
- ``ops``         — hand-written CUDA kernels (``csrc/``) behind torch
                    wrappers, with their plain torch versions.
- ``models``      — the flagship transformer.
- ``trace``, ``utils.hooks``, ``runtime.spc`` — spans with Perfetto
                    export and late-arrival attribution, profiling hooks
                    and software performance counters (with
                    ``coll/monitoring`` and ``coll/sync``).
- ``telemetry``   — histogram pvars, the straggler health monitor, the
                    fault flight recorder and the Prometheus exporter.
- ``runtime.ft``, ``ft``, ``coll/ftagree``, ``mpiext`` — ULFM: the
                    failure registry, fault injection, the heartbeat
                    detector, agreement and the MPIX_* surface.

It imports torch, numpy and the standard library — never JAX, and never
``ompi_tpu``.
"""

from ompi_tpu_torch.api.mpi import (  # noqa: F401
    # constants
    IN_PLACE, UNDEFINED, ANY_SOURCE, ANY_TAG, PROC_NULL, ROOT,
    KEYVAL_INVALID, MAX_ERROR_STRING, MAX_PROCESSOR_NAME,
    SUCCESS, ERR_COMM, ERR_TYPE, ERR_OP, ERR_ARG, ERR_COUNT, ERR_BUFFER,
    ERR_RANK, ERR_ROOT, ERR_TRUNCATE, ERR_OTHER, ERR_PENDING, ERR_TOPOLOGY,
    ERR_PROC_FAILED, ERR_REVOKED,
    CONGRUENT, IDENT, SIMILAR, UNEQUAL,
    THREAD_SINGLE, THREAD_FUNNELED, THREAD_SERIALIZED, THREAD_MULTIPLE,
    COMM_TYPE_SHARED, COMM_TYPE_HWTHREAD, COMM_TYPE_NUMA,
    # datatypes
    FLOAT, DOUBLE, INT, LONG, CHAR, BYTE, SHORT, UNSIGNED, UNSIGNED_LONG,
    INT8_T, INT16_T, INT32_T, INT64_T, UINT8_T, UINT16_T, UINT32_T, UINT64_T,
    C_BOOL, FLOAT16, BFLOAT16, C_FLOAT_COMPLEX, C_DOUBLE_COMPLEX,
    FLOAT_INT, DOUBLE_INT, LONG_INT, SHORT_INT, TWOINT,
    Datatype,
    # ops
    SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR, MAXLOC, MINLOC, Op,
    # objects
    Communicator, Group, Errhandler, Info, Request, Status, Grequest,
    ERRORS_ARE_FATAL, ERRORS_RETURN, ERRORS_ABORT,
    MPIError,
    # lifecycle
    Init, Init_thread, Finalize, Initialized, Finalized, Wtime, Wtick,
    get_comm_world, get_comm_self, COMM_NULL, Get_processor_name,
    Query_thread, Abort, Get_version, Get_library_version,
    # point-to-point (per-rank)
    Send, Ssend, Isend, Recv, Irecv, Sendrecv, Probe,
    # collectives (both communicator kinds)
    Barrier, Bcast, Reduce, Allreduce, Allgather,
    # ULFM resilience surface (mpiext/ftmpi)
    MPIX_Comm_agree, MPIX_Comm_get_failed, MPIX_Comm_is_revoked,
    MPIX_Comm_revoke, MPIX_Comm_shrink,
    # request completion
    Wait, Start, Startall, Test, Waitall, Waitany, Waitsome, Testall,
    Testany, Testsome,
    # helpers
    op_create, create_keyval, free_keyval, error_string, from_numpy_dtype,
    from_torch_dtype, INFO_ENV, INFO_NULL, Comm_set_errhandler,
    Comm_get_errhandler, Comm_call_errhandler,
    # local reduction + pack/external32
    reduce_local, Pack, Unpack, Pack_external, Unpack_external, Pack_size,
)
from ompi_tpu_torch.runtime.init import _reset_for_tests  # noqa: F401

__version__ = "0.1.0"
