"""The MPI-flavored public API (the ``ompi/mpi/c`` binding layer).

MPI-style names over the core objects. Single-controller note: buffer
arguments are *stacked* tensors — leading axis is the rank — and results
are returned as new tensors (nonblocking and persistent calls return a
``Request`` whose ``get()`` gives them). ``IN_PLACE`` keeps its MPI meaning: "use
recvbuf as the send buffer".
"""
from __future__ import annotations

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
    ERR_ARG, ERR_BUFFER, ERR_COMM, ERR_COUNT, ERR_OP, ERR_OTHER, ERR_PENDING,
    ERR_RANK, ERR_ROOT, ERR_TOPOLOGY, ERR_TRUNCATE, ERR_TYPE, ERRORS_ABORT,
    ERRORS_ARE_FATAL,
    ERRORS_RETURN, Errhandler, MPIError, SUCCESS, error_string)
from ompi_tpu_torch.core.group import (CONGRUENT, Group, IDENT,  # noqa: F401
                                       SIMILAR, UNDEFINED, UNEQUAL)
from ompi_tpu_torch.core.info import INFO_ENV, INFO_NULL, Info  # noqa: F401
from ompi_tpu_torch.core.op import (BAND, BOR, BXOR, LAND, LOR, LXOR,  # noqa: F401
                                    MAX, MAXLOC, MIN, MINLOC, Op, PROD, SUM,
                                    op_create, reduce_local)
from ompi_tpu_torch.core.request import (Grequest, Request,  # noqa: F401
                                         Status, startall, testall,
                                         testany, testsome, waitall,
                                         waitany, waitsome)
from ompi_tpu_torch.runtime import init as _rt

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2
KEYVAL_INVALID = -1

COMM_TYPE_SHARED = 1
COMM_TYPE_HWTHREAD = 2
COMM_TYPE_NUMA = 3

THREAD_SINGLE = _rt.THREAD_SINGLE
THREAD_FUNNELED = _rt.THREAD_FUNNELED
THREAD_SERIALIZED = _rt.THREAD_SERIALIZED
THREAD_MULTIPLE = _rt.THREAD_MULTIPLE

COMM_NULL = None


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


def Wtime() -> float:
    return _rt.wtime()


def Wtick() -> float:
    return _rt.wtick()


def get_comm_world() -> Communicator:
    return _rt.comm_world()


def get_comm_self() -> Communicator:
    return _rt.comm_self()


def Comm_set_errhandler(comm, errhandler: Errhandler) -> None:
    comm.set_errhandler(errhandler)


def Comm_get_errhandler(comm) -> Errhandler:
    return comm.get_errhandler()


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
