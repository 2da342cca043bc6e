"""Error handlers — mirrors ``ompi/errhandler``.

MPI error classes surface as ``MPIError`` exceptions; a communicator's
errhandler decides whether an error aborts the job (ERRORS_ARE_FATAL,
the MPI default for communicators), raises to the caller (ERRORS_RETURN —
the Pythonic 'return code'), or runs a user callback.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_GROUP = 9
ERR_OP = 10
ERR_TOPOLOGY = 11
ERR_DIMS = 12
ERR_ARG = 13
ERR_UNKNOWN = 14
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_INTERN = 17
ERR_PENDING = 18
ERR_IN_STATUS = 19
ERR_WIN = 45          # one-sided RMA (MPI-3 ch. 11)
ERR_BASE = 46
ERR_LOCKTYPE = 47
ERR_RMA_CONFLICT = 49
ERR_SPAWN = 50        # dynamic process management
ERR_PORT = 51
ERR_SERVICE = 52
ERR_NAME = 53
ERR_RMA_SYNC = 54     # RMA call outside its epoch discipline
ERR_REVOKED = 72      # ULFM: the communicator was revoked
ERR_PROC_FAILED = 75  # ULFM: a peer process died

_CLASS_NAMES = {
    SUCCESS: "MPI_SUCCESS", ERR_BUFFER: "MPI_ERR_BUFFER",
    ERR_COUNT: "MPI_ERR_COUNT", ERR_TYPE: "MPI_ERR_TYPE",
    ERR_TAG: "MPI_ERR_TAG", ERR_COMM: "MPI_ERR_COMM",
    ERR_RANK: "MPI_ERR_RANK", ERR_REQUEST: "MPI_ERR_REQUEST",
    ERR_ROOT: "MPI_ERR_ROOT", ERR_GROUP: "MPI_ERR_GROUP",
    ERR_OP: "MPI_ERR_OP", ERR_TOPOLOGY: "MPI_ERR_TOPOLOGY",
    ERR_DIMS: "MPI_ERR_DIMS", ERR_ARG: "MPI_ERR_ARG",
    ERR_UNKNOWN: "MPI_ERR_UNKNOWN", ERR_TRUNCATE: "MPI_ERR_TRUNCATE",
    ERR_OTHER: "MPI_ERR_OTHER", ERR_INTERN: "MPI_ERR_INTERN",
    ERR_PENDING: "MPI_ERR_PENDING", ERR_IN_STATUS: "MPI_ERR_IN_STATUS",
    ERR_SPAWN: "MPI_ERR_SPAWN", ERR_PORT: "MPI_ERR_PORT",
    ERR_SERVICE: "MPI_ERR_SERVICE", ERR_NAME: "MPI_ERR_NAME",
    ERR_WIN: "MPI_ERR_WIN", ERR_BASE: "MPI_ERR_BASE",
    ERR_LOCKTYPE: "MPI_ERR_LOCKTYPE",
    ERR_RMA_CONFLICT: "MPI_ERR_RMA_CONFLICT",
    ERR_RMA_SYNC: "MPI_ERR_RMA_SYNC",
    ERR_REVOKED: "MPIX_ERR_REVOKED",
    ERR_PROC_FAILED: "MPIX_ERR_PROC_FAILED",
}


class MPIError(Exception):
    def __init__(self, error_class: int, message: str = ""):
        self.error_class = error_class
        super().__init__(
            f"{_CLASS_NAMES.get(error_class, f'MPI_ERR({error_class})')}"
            f"{': ' + message if message else ''}")


def error_string(error_class: int) -> str:
    return _CLASS_NAMES.get(error_class, f"MPI_ERR({error_class})")


class Errhandler:
    def __init__(self, fn: Optional[Callable] = None, name: str = "user"):
        self.fn = fn
        self.name = name

    def invoke(self, comm, error_class: int, message: str = ""):
        if self.fn is not None:
            return self.fn(comm, error_class, message)
        raise MPIError(error_class, message)


def _fatal(comm, error_class, message):
    # User-facing diagnostics ride the show_help catalogs (the
    # opal_show_help pattern); the terse line stays for logs.
    try:
        from ompi_tpu_torch.utils import show_help
        topic = {ERR_REVOKED: ("comm:revoked",
                               (getattr(comm, "name", "?"),)),
                 ERR_PROC_FAILED: ("comm:proc-failed",
                                   (getattr(comm, "name", "?"), message))
                 }.get(error_class)
        if topic is not None:
            show_help.show_help("help-mpi-errors.txt", topic[0],
                                *topic[1])
    except Exception:
        pass
    sys.stderr.write(
        f"*** An error occurred: {error_string(error_class)} {message}\n"
        f"*** MPI_ERRORS_ARE_FATAL (job will abort)\n")
    raise SystemExit(error_class or 1)


def _abort(comm, error_class, message):
    sys.stderr.write(f"*** {error_string(error_class)}: aborting\n")
    raise SystemExit(error_class or 1)


ERRORS_ARE_FATAL = Errhandler(_fatal, "MPI_ERRORS_ARE_FATAL")
ERRORS_RETURN = Errhandler(None, "MPI_ERRORS_RETURN")
ERRORS_ABORT = Errhandler(_abort, "MPI_ERRORS_ABORT")
