"""dpm/perrank — dynamic process management across separate jobs. The
port of ``ompi_tpu/core/dpm_perrank.py``.

Behavioral spec: ``ompi/dpm`` — ``MPI_Open_port`` publishes a network
address, ``MPI_Comm_accept``/``MPI_Comm_connect`` rendezvous two
independent MPI jobs into an intercommunicator, over which ordinary
point-to-point addresses the remote group (``dpm_dpm.c`` connect/accept
over PMIx).

Two per-rank jobs own two separate coordination stores, so the bridge is
its own TCP link between the accept root and the connect root, framed as
``btl/tcp`` frames are. Cross-job traffic is root-relayed: a non-root
sender ships an envelope to its root's Router (handled on a reader
thread, so the root's application thread never participates), the root
forwards it over the bridge, and the remote root re-injects it into its
job's engine registry, where it matches like any local frame.
``BridgeInterComm`` says so in its ``repr``. A CUDA tensor sent across
the bridge takes one device-to-host copy and arrives as a numpy array
(``btl/tcp.encode_payload``).

Surface: ``open_port() -> "host:port"``; ``comm_accept(port, comm)`` /
``comm_connect(port, comm)`` (collective over the local comm) return a
:class:`BridgeInterComm` with ``remote_size``, ``send``/``recv``/
``irecv``/``iprobe`` addressing remote ranks, and ``disconnect``.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional

from ompi_tpu_torch.btl.tcp import MAGIC, _LEN, encode_payload
from ompi_tpu_torch.core.errhandler import ERR_ARG, ERR_PORT, MPIError
from ompi_tpu_torch.pml.perrank import ANY_SOURCE, ANY_TAG, PerRankEngine


class _Port:
    """An open MPI port: a listening socket bound to an ephemeral
    loopback address (MPI_Open_port)."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        host, port = self.sock.getsockname()
        self.name = f"{host}:{port}"

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


_ports = {}


def open_port() -> str:
    p = _Port()
    _ports[p.name] = p
    return p.name


def close_port(name: str) -> None:
    p = _ports.pop(name, None)
    if p is not None:
        p.close()


def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class _ICView:
    """Engine-comm shim for the intercomm's receive side: frames carry
    remote-group source ranks; delivery happens into the local rank's
    private engine registered under the intercomm cid. ``no_peer_map``
    tells the failure path that local peer deaths have no rank mapping
    here (the remote group's liveness is the bridge's story)."""

    no_peer_map = True

    def __init__(self, icid, local_comm, remote_size: int):
        self.cid = ("ic", icid, local_comm.rank())
        self._comm = local_comm
        self.size = remote_size      # source-rank bound (remote group)

    def rank(self):
        return self._comm.rank()

    def world_rank_of(self, local):
        return self._comm.world_rank_of(self._comm.rank())


class BridgeInterComm:
    """An intercommunicator spanning two independently launched jobs."""

    def __init__(self, local_comm, icid: str, remote_size: int,
                 bridge: Optional[socket.socket], root: int):
        self.local_comm = local_comm
        self.icid = icid
        self.remote_size = remote_size
        self.root = root
        self._bridge = bridge                     # root only
        self._blk = threading.Lock()
        self._disconnected = False
        router = local_comm.router
        self._router = router
        # my receive engine: remote frames land here
        self._engine = PerRankEngine(
            _ICView(icid, local_comm, remote_size), router)
        if bridge is not None:
            # the root registers (a) the outbound relay handler other
            # local ranks target and (b) the bridge reader that fans
            # inbound remote frames out to local ranks; both run on
            # reader threads
            router.register_rma(("icrelay", icid), self._relay_out)
            t = threading.Thread(target=self._bridge_reader, daemon=True,
                                 name=f"ic-bridge-{icid}")
            t.start()

    @property
    def size(self) -> int:
        return self.local_comm.size

    # -- send path -----------------------------------------------------
    def send(self, data: Any, remote_rank: int, tag: int = 0) -> None:
        if self._disconnected:
            raise MPIError(ERR_ARG, "intercomm is disconnected")
        if not (0 <= remote_rank < self.remote_size):
            raise MPIError(ERR_ARG, f"bad remote rank {remote_rank}")
        desc, raw = encode_payload(data)
        env = {"dest": remote_rank, "src": self.local_comm.rank(),
               "tag": tag, "desc": desc}
        if self._bridge is not None:
            self._bridge_write(env, raw)
        else:
            # relay through my root's Router (a reader-thread handler)
            header = {"rma": True, "wid": ("icrelay", self.icid),
                      "env": env, "origin": self._router.rank}
            self._router.endpoint.send_frame(
                self.local_comm.world_rank_of(self.root), header, raw)

    # -- receive path (remote-group sources) ---------------------------
    def recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             timeout: Optional[float] = None):
        return self._engine.recv(source, tag, timeout)

    def irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        return self._engine.irecv(source, tag)

    def iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG):
        return self._engine.iprobe(source, tag)

    # -- plumbing ------------------------------------------------------
    def _bridge_write(self, env: dict, raw) -> None:
        hraw = pickle.dumps(env)
        with self._blk:
            self._bridge.sendall(_LEN.pack(MAGIC, len(hraw), len(raw))
                                 + hraw)
            if len(raw):
                self._bridge.sendall(raw)

    def _relay_out(self, header: dict, raw) -> None:
        """Root handler for local non-root senders (reader thread)."""
        self._bridge_write(header["env"], raw)

    def _bridge_reader(self) -> None:
        """Root: fan inbound remote frames out to the addressed local
        rank's intercomm engine, re-wrapped as a local frame."""
        conn = self._bridge
        while not self._disconnected:
            try:
                head = _read_exact(conn, _LEN.size)
                if head is None:
                    return
                magic, hlen, plen = _LEN.unpack(head)
                if magic != MAGIC:
                    return
                env = pickle.loads(_read_exact(conn, hlen))
                raw = _read_exact(conn, plen) if plen else b""
                dest = env["dest"]
                local_header = {"cid": ("ic", self.icid, dest),
                                "src": env["src"], "tag": env["tag"],
                                "desc": env["desc"]}
                self._router.endpoint.send_frame(
                    self.local_comm.world_rank_of(dest), local_header, raw)
            except OSError:
                return

    def disconnect(self) -> None:
        """MPI_Comm_disconnect: collective over the local comm."""
        self.local_comm.barrier()
        self._disconnected = True
        if self._bridge is not None:
            self._router.unregister_rma(("icrelay", self.icid))
            try:
                self._bridge.close()
            except OSError:
                pass
        self._engine.close()

    def __repr__(self):
        return (f"BridgeInterComm(local={self.local_comm.size}, "
                f"remote={self.remote_size}, root-relayed)")


def _handshake(sock: socket.socket, my_size: int) -> int:
    sock.sendall(struct.pack("!I", my_size))
    raw = _read_exact(sock, 4)
    if raw is None:
        raise MPIError(ERR_PORT, "bridge handshake failed")
    return struct.unpack("!I", raw)[0]


def comm_accept(port_name: str, comm, root: int = 0,
                timeout: Optional[float] = None) -> BridgeInterComm:
    """MPI_Comm_accept: collective over ``comm``; the root accepts one
    connection on its open port and the jobs exchange group sizes.
    ``timeout`` bounds the root's accept wait (None = block)."""
    icid = port_name
    if comm.rank() == root:
        p = _ports.get(port_name)
        if p is None:
            raise MPIError(ERR_PORT, f"port {port_name!r} is not open "
                                     f"in this process")
        if timeout is not None:
            p.sock.settimeout(timeout)
        try:
            conn, _ = p.sock.accept()
        except socket.timeout:
            # the accept is collective: non-roots wait in the bcast
            # below, so broadcast the failure sentinel and every rank
            # raises
            comm.bcast(-1, root=root)
            raise MPIError(ERR_PORT,
                           f"no connection arrived on {port_name!r} "
                           f"within {timeout}s") from None
        finally:
            # the listener persists for later accepts, which must see
            # their own timeout, not this call's
            if timeout is not None:
                p.sock.settimeout(None)
        conn.settimeout(None)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            remote = _handshake(conn, comm.size)
        except BaseException:
            # a connector that dies mid-handshake must not leave the
            # non-roots parked in the bcast below, nor leak the socket
            try:
                conn.close()
            except OSError:
                pass
            comm.bcast(-1, root=root)
            raise
        comm.bcast(remote, root=root)
        return BridgeInterComm(comm, icid, remote, conn, root)
    remote = comm.bcast(None, root=root)
    if remote == -1:                     # the root's accept failed
        raise MPIError(ERR_PORT,
                       "comm_accept failed at the root (timeout or "
                       "handshake error)")
    return BridgeInterComm(comm, icid, remote, None, root)


def comm_connect(port_name: str, comm, root: int = 0,
                 timeout: float = 60) -> BridgeInterComm:
    """MPI_Comm_connect: collective over ``comm``; the root dials the
    advertised port."""
    icid = port_name
    if comm.rank() == root:
        host, port = port_name.rsplit(":", 1)
        conn = socket.create_connection((host, int(port)),
                                        timeout=timeout)
        conn.settimeout(None)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        remote = _handshake(conn, comm.size)
        comm.bcast(remote, root=root)
        return BridgeInterComm(comm, icid, remote, conn, root)
    remote = comm.bcast(None, root=root)
    return BridgeInterComm(comm, icid, remote, None, root)


def _reset_for_tests() -> None:
    for name in list(_ports):
        close_port(name)
