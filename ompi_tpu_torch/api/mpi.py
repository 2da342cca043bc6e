"""The MPI-flavored public API (the ``ompi/mpi/c`` binding layer).

MPI-style names over the core objects. Single-controller note: buffer
arguments are *stacked* tensors — leading axis is the rank — and results
are returned as new tensors (nonblocking and persistent calls return a
``Request`` whose ``get()`` gives them). ``IN_PLACE`` keeps its MPI meaning: "use
recvbuf as the send buffer". In a per-rank job (``mpirun --per-rank``)
``get_comm_world()`` is a ``RankCommunicator``: the caller is one rank and
passes its own buffer, as in textbook MPI.
"""
from __future__ import annotations

from typing import Optional

from ompi_tpu_torch.core.communicator import (IN_PLACE,  # noqa: F401
                                              Communicator, create_keyval,
                                              free_keyval)
from ompi_tpu_torch.core.convertor import (  # noqa: F401
    mpi_pack as Pack, mpi_unpack as Unpack, pack_external as Pack_external,
    pack_size as Pack_size, unpack_external as Unpack_external)
from ompi_tpu_torch.core.datatype import (  # noqa: F401
    BFLOAT16, BYTE, C_BOOL, C_DOUBLE_COMPLEX, C_FLOAT_COMPLEX, CHAR, DOUBLE,
    DOUBLE_INT, Datatype, FLOAT, FLOAT16, FLOAT_INT, INT, INT8_T, INT16_T,
    INT32_T, INT64_T, LONG, LONG_INT, SHORT, SHORT_INT, TWOINT, UINT8_T,
    UINT16_T, UINT32_T, UINT64_T, UNSIGNED, UNSIGNED_LONG,
    from_numpy_dtype, from_torch_dtype)
from ompi_tpu_torch.core.errhandler import (  # noqa: F401
    ERR_ARG, ERR_BASE, ERR_BUFFER, ERR_COMM, ERR_COUNT, ERR_LOCKTYPE,
    ERR_NAME, ERR_OP, ERR_OTHER, ERR_PENDING, ERR_PORT, ERR_PROC_FAILED,
    ERR_RANK, ERR_REVOKED, ERR_RMA_CONFLICT, ERR_RMA_SYNC, ERR_ROOT,
    ERR_SERVICE, ERR_SPAWN, ERR_TOPOLOGY, ERR_TRUNCATE, ERR_TYPE, ERR_WIN,
    ERRORS_ABORT,
    ERRORS_ARE_FATAL,
    ERRORS_RETURN, Errhandler, MPIError, SUCCESS, error_string)
from ompi_tpu_torch.core.group import (CONGRUENT, Group, IDENT,  # noqa: F401
                                       SIMILAR, UNDEFINED, UNEQUAL)
from ompi_tpu_torch.core.info import INFO_ENV, INFO_NULL, Info  # noqa: F401
from ompi_tpu_torch.core.op import (BAND, BOR, BXOR, LAND, LOR, LXOR,  # noqa: F401
                                    MAX, MAXLOC, MIN, MINLOC, NO_OP, Op,
                                    PROD, REPLACE, SUM, op_create,
                                    reduce_local)
from ompi_tpu_torch.core.request import (Grequest, Request,  # noqa: F401
                                         Status, startall, testall,
                                         testany, testsome, waitall,
                                         waitany, waitsome)
from ompi_tpu_torch.runtime import init as _rt

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2
ROOT = -4
KEYVAL_INVALID = -1
MAX_ERROR_STRING = 256
MAX_PROCESSOR_NAME = 256

COMM_TYPE_SHARED = 1
COMM_TYPE_HWTHREAD = 2
COMM_TYPE_NUMA = 3

THREAD_SINGLE = _rt.THREAD_SINGLE
THREAD_FUNNELED = _rt.THREAD_FUNNELED
THREAD_SERIALIZED = _rt.THREAD_SERIALIZED
THREAD_MULTIPLE = _rt.THREAD_MULTIPLE

COMM_NULL = None

# one-sided RMA: the stacked single-controller window, and the per-rank
# framework (MPI_Win_allocate/Win_create with component selection —
# osc/shm same-host windows, osc/pt2pt emulation)
from ompi_tpu_torch.osc.framework import (LOCK_EXCLUSIVE,  # noqa: F401,E402
                                          LOCK_SHARED, Win)
from ompi_tpu_torch.osc.window import (RmaWindow,  # noqa: F401,E402
                                       win_allocate as Win_allocate,
                                       win_create as Win_create)


# lifecycle ---------------------------------------------------------------
def Init(devices=None) -> None:
    _rt.init(THREAD_SINGLE, devices=devices)


def Init_thread(required: int = THREAD_SINGLE, devices=None) -> int:
    return _rt.init(required, devices=devices)


def Finalize() -> None:
    _rt.finalize()


def Initialized() -> bool:
    return _rt.initialized()


def Finalized() -> bool:
    return _rt.finalized()


def Query_thread() -> int:
    return _rt.query_thread()


def Abort(comm: Optional[Communicator] = None, errorcode: int = 1):
    (comm or _rt.comm_world()).abort(errorcode)


def Get_version():
    return (4, 0)      # MPI standard level this surface tracks


def Get_library_version() -> str:
    from ompi_tpu_torch import __version__
    return f"ompi_tpu_torch {__version__} (PyTorch/CUDA port of ompi_tpu)"


def Wtime() -> float:
    return _rt.wtime()


def Wtick() -> float:
    return _rt.wtick()


def get_comm_world() -> Communicator:
    return _rt.comm_world()


def get_comm_self() -> Communicator:
    return _rt.comm_self()


def Get_processor_name() -> str:
    return _rt.processor_name()


def Comm_set_errhandler(comm, errhandler: Errhandler) -> None:
    comm.set_errhandler(errhandler)


def Comm_get_errhandler(comm) -> Errhandler:
    return comm.get_errhandler()


def Comm_call_errhandler(comm, error_class: int, message: str = ""):
    return comm.errhandler.invoke(comm, error_class, message)


def _guard(comm, fn, *args, **kw):
    """The OMPI_ERRHANDLER_INVOKE role (errhandler.h:389-401): an
    MPIError goes to the communicator's errhandler, so ERRORS_RETURN
    surfaces it and ERRORS_ARE_FATAL aborts."""
    try:
        return fn(*args, **kw)
    except MPIError as e:
        return comm.errhandler.invoke(comm, e.error_class, str(e))


# point-to-point, textbook signatures (the per-rank world: the caller is
# the sending or receiving rank) -----------------------------------------
def Send(comm, data, dest: int, tag: int = 0) -> None:
    _guard(comm, comm.send, data, dest, tag)


def Ssend(comm, data, dest: int, tag: int = 0) -> None:
    _guard(comm, comm.ssend, data, dest, tag)


def Isend(comm, data, dest: int, tag: int = 0) -> Request:
    return _guard(comm, comm.isend, data, dest, tag)


def Recv(comm, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    return _guard(comm, comm.recv, source, tag)


def Irecv(comm, source: int = ANY_SOURCE, tag: int = ANY_TAG) -> Request:
    return _guard(comm, comm.irecv, source, tag)


def Sendrecv(comm, senddata, dest: int, source: int = ANY_SOURCE,
             sendtag: int = 0, recvtag: int = ANY_TAG):
    return _guard(comm, comm.sendrecv, senddata, dest, source,
                  sendtag, recvtag)


def Probe(comm, source: int = ANY_SOURCE, tag: int = ANY_TAG):
    return _guard(comm, comm.probe, source, tag)


# collectives: the same call on both communicator kinds (a stacked buffer
# on the single-controller world, the caller's own buffer per rank) ------
def Barrier(comm) -> None:
    _guard(comm, comm.barrier)


def Bcast(comm, data, root: int = 0):
    return _guard(comm, comm.bcast, data, root)


def Reduce(comm, data, op: Op = SUM, root: int = 0):
    return _guard(comm, comm.reduce, data, op, root)


def Allreduce(comm, data, op: Op = SUM):
    return _guard(comm, comm.allreduce, data, op)


def Allgather(comm, data):
    return _guard(comm, comm.allgather, data)


# -- ULFM (the MPIX_* surface, mpiext/ftmpi) ------------------------------
from ompi_tpu_torch.mpiext.ftmpi import (  # noqa: E402,F401
    Comm_agree as MPIX_Comm_agree,
    Comm_get_failed as MPIX_Comm_get_failed,
    Comm_is_revoked as MPIX_Comm_is_revoked,
    Comm_revoke as MPIX_Comm_revoke,
    Comm_shrink as MPIX_Comm_shrink)


# -- MPI-4 Sessions (runtime/session) -------------------------------------
from ompi_tpu_torch.runtime.session import Session  # noqa: E402,F401

# -- dynamic process management (ompi/dpm) --------------------------------
from ompi_tpu_torch.core import dpm as _dpm  # noqa: E402
from ompi_tpu_torch.core.intercomm import (  # noqa: E402,F401
    Intercomm, intercomm_create as Intercomm_create)


def Open_port(info=None) -> str:
    return _dpm.open_port(info)


def Close_port(port: str) -> None:
    _dpm.close_port(port)


def Publish_name(service: str, port: str, info=None) -> None:
    _dpm.publish_name(service, port, info)


def Lookup_name(service: str, info=None) -> str:
    return _dpm.lookup_name(service, info)


def Unpublish_name(service: str, info=None) -> None:
    _dpm.unpublish_name(service, info)


def Comm_accept(port: str, comm) -> "Intercomm":
    return _dpm.accept(port, comm)


def Comm_connect(port: str, comm) -> "Intercomm":
    return _dpm.connect(port, comm)


def Comm_iaccept(port: str, comm):
    return _dpm.iaccept(port, comm)


def Comm_iconnect(port: str, comm):
    return _dpm.iconnect(port, comm)


def Comm_spawn(fn, maxprocs: int, comm, **kw) -> "Intercomm":
    return _dpm.spawn(fn, maxprocs, comm, **kw)


def Comm_spawn_multiple(apps, comm, **kw) -> "Intercomm":
    return _dpm.spawn_multiple(apps, comm, **kw)


def Comm_get_parent(comm):
    return _dpm.get_parent(comm)


def Comm_join(fd, comm):
    return _dpm.join(fd, comm)


def Comm_disconnect(comm) -> None:
    _dpm.disconnect(comm)


# request completion (MPI_Wait/Test families) -----------------------------
def Wait(request: Request) -> Status:
    return request.wait()


def Start(request: Request) -> Request:
    return request.start()


def Startall(requests) -> None:
    """MPI_Startall: bucketable persistent collectives fuse — they
    enqueue into their communicator's BucketFuser and flush once at the
    startall boundary (coll/persistent)."""
    startall(requests)


def Test(request: Request):
    return request.test()


def Waitall(requests) -> list:
    return waitall(requests)


def Waitany(requests):
    return waitany(requests)


def Waitsome(requests):
    return waitsome(requests)


def Testall(requests):
    return testall(requests)


def Testany(requests):
    return testany(requests)


def Testsome(requests):
    return testsome(requests)
