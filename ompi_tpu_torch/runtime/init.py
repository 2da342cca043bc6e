"""ompi_mpi_init / finalize — world bring-up.

Behavioral spec: ``ompi/runtime/ompi_mpi_init.c:397`` through
``ompi/instance/instance.c:361-720``: OPAL up -> wire-up -> COMM_WORLD/SELF
creation -> per-communicator coll selection.

Single-controller: wire-up is device enumeration. ``init()`` binds one
rank to each visible CUDA device; ``init(devices=[...])`` binds one rank
to each listed device, repeats allowed, so ``[torch.device("cuda:0")] *
8`` puts 8 ranks on one card and ``["cpu"] * 8`` puts them on the CPU
(the counterpart of the JAX package's 8 virtual CPU devices). Without a
CUDA device and without an explicit list, ``init`` raises: it never moves
to the CPU on its own.

Per-rank (``mpi_base_per_rank``, set by ``mpirun --per-rank``): one OS
process is one rank, ``rank()`` is the process index, and the job's
``torch.distributed.TCPStore``, hosted by the launcher, is the
coordination KV (the PMIx modex and fence of
``ompi/instance/instance.c:508-569``). Each rank binds
``cuda:(local_rank % device_count)``; with no CUDA device it raises unless
the job asked for the CPU (``mpi_base_device=cpu``). The router's bml
builds the rank's byte planes, the zero-copy segment plane (btl/shmseg)
among them, and ``finalize`` closes them. Unless the user set
``coll_tuned_stage_min_bytes``, rank 0 runs the staging probe on its
device at Init and publishes the result through the KV; every rank adopts
the same value.

Multi-controller (``mpi_base_distributed``, set by ``mpirun --coordinator
host:port --num-hosts H --host-id I``): one controller process per host,
each binding its own rows (``init(devices=[...])``), together one world.
Host 0 hosts the job's ``TCPStore`` at the coordinator address and every
host opens a client on it (the role of ``jax.distributed.initialize``);
each controller publishes its rows' devices, waits at the init fence, and
the controllers wire up the per-rank tier among themselves
(``pml/perrank.Router``, rank = host id), over which the collectives of a
communicator spanning controllers cross (``core/multictl``). World rank
order is controller order. ``finalize`` fences, closes the tier and, on
host 0, sweeps the job's shared-memory files once every host has left.

The resilience and telemetry planes arm here too: the tracer and the
telemetry plane before any communicator exists (the composers wrap only
while they are on), and on the per-rank tier the ring heartbeat detector
(``mpi_base_ft_hb_period`` > 0), the straggler health monitor and the
flight recorder. Finalize skips the drain barrier and the fini fence
once a rank has failed, and shuts telemetry down first.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import time
from typing import List, Optional

import torch

from ompi_tpu_torch import accelerator, compress
# imported with the package, so the witness captures the interpreter's
# lock factories before anything can rebind them
from ompi_tpu_torch.analyze import lockwitness
from ompi_tpu_torch.btl import shmseg
from ompi_tpu_torch.coll import persistent, tuned
from ompi_tpu_torch.core.communicator import Communicator
from ompi_tpu_torch.core.errhandler import ERR_OTHER, MPIError
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.core.info import INFO_ENV
from ompi_tpu_torch.io import fcoll, sharedfp
from ompi_tpu_torch.mca import base, var
from ompi_tpu_torch.pml import pipeline, stacked, vprotocol
from ompi_tpu_torch.runtime import progress
from ompi_tpu_torch.tools import comm_method
from ompi_tpu_torch.utils import memchecker

THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3

_state = {
    "initialized": False,
    "finalized": False,
    "world": None,
    "self": None,
    "thread_level": THREAD_SINGLE,
    "router": None,
    "kv": None,
    "store_server": None,            # host 0 of a multi-controller job
}

# the parent job's intercommunicator in a spawned per-rank world (the
# MPI_Comm_spawn child side); None in a directly launched job
_parent_intercomm = None


def _register_base_vars() -> None:
    var.var_register("mpi", "base", "num_ranks", vtype="int", default=0,
                     help="Number of ranks of a single-controller world "
                          "(0 = one per visible CUDA device)")
    var.var_register("mpi", "base", "per_rank", vtype="bool", default=False,
                     help="Per-rank model: one OS process is one MPI rank "
                          "(set by mpirun --per-rank)")
    var.var_register("mpi", "base", "coordinator", vtype="str", default="",
                     help="host:port of the job's TCPStore (the "
                          "coordination KV, hosted by mpirun, or by host 0 "
                          "of a multi-controller job)")
    var.var_register("mpi", "base", "process_id", vtype="int", default=-1,
                     help="This process's rank in a per-rank job, or its "
                          "host id in a multi-controller job")
    var.var_register("mpi", "base", "num_processes", vtype="int",
                     default=0, help="Ranks in a per-rank job, or "
                                     "controllers in a multi-controller "
                                     "job")
    var.var_register("mpi", "base", "distributed", vtype="bool",
                     default=False,
                     help="Multi-controller world: one controller process "
                          "per host, each binding its local rows, together "
                          "one COMM_WORLD (set by mpirun --coordinator)")
    var.var_register("mpi", "base", "device", vtype="str", default="",
                     help="Per-rank device: empty = "
                          "cuda:(local_rank % device_count), 'cpu' = "
                          "bind the rank to the CPU")


def _register_component_vars() -> None:
    persistent.register_vars()
    tuned.register_vars()
    compress._register_vars()
    stacked._register_vars()
    vprotocol._register_vars()
    pipeline.register_params()
    shmseg.register_params()
    memchecker.register_vars()
    fcoll.register_vars()
    sharedfp.register_vars()
    comm_method.register_params()


def init(requested: int = THREAD_SINGLE,
         devices: Optional[List] = None) -> int:
    """MPI_Init / MPI_Init_thread. Returns the provided thread level."""
    if _state["initialized"]:
        raise MPIError(ERR_OTHER, "MPI already initialized")
    _register_base_vars()
    # arm the lock-order witness before transport and progress bring-up,
    # so endpoint locks are created wrapped; off = threading.Lock untouched
    lockwitness.maybe_install_from_var()
    # arm the tracer when the MCA var (env/param file) asks for it,
    # before any communicator exists: the coll composer and the per-rank
    # interposer wrap only while it is on
    from ompi_tpu_torch import trace
    trace.maybe_enable_from_var()
    # the same timing contract for the telemetry plane (histogram pvars,
    # health monitor, flight recorder): armed before the composers run
    from ompi_tpu_torch import telemetry
    telemetry.maybe_enable_from_var()
    if var.var_get("mpi_base_per_rank", False):
        return _init_per_rank(requested)
    if devices is None:
        if not torch.cuda.is_available():
            raise MPIError(ERR_OTHER,
                           "no CUDA device is visible; pass devices=[...] "
                           "(e.g. ['cpu'] * 8) to run ranks elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        nr = var.var_get("mpi_base_num_ranks", 0)
        if nr and nr <= len(devices):
            devices = devices[:nr]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise MPIError(ERR_OTHER, "Init needs at least one device")
    accelerator.select_for_devices(devices)
    _register_component_vars()
    if var.var_get("mpi_base_distributed", False):
        devices, first = _init_controllers(devices)
    else:
        first = 0
    n = len(devices)

    world = Communicator(Group(range(n)), devices, name="MPI_COMM_WORLD")
    self_comm = Communicator(Group([first]), [devices[first]],
                             name="MPI_COMM_SELF")

    INFO_ENV.set("command", os.environ.get("_", ""))
    INFO_ENV.set("maxprocs", str(n))
    INFO_ENV.set("soft", str(n))
    INFO_ENV.set("host", socket.gethostname())
    INFO_ENV.set("arch", devices[0].type)

    _state.update(initialized=True, finalized=False, world=world,
                  self=self_comm,
                  thread_level=min(requested, THREAD_MULTIPLE))
    return _state["thread_level"]


# how long a KV get or fence waits for the job's other ranks (the
# reference's bound, runtime/init.py:188); a rank that dies ends the job
# through the launcher long before
KV_TIMEOUT = 120.0


def _init_controllers(local: List[torch.device]):
    """Multi-controller bring-up (``jax.distributed.initialize`` plus the
    modex and init fence of instance.c:547-569): host 0 hosts the store,
    every controller publishes its rows' devices, fences, and wires the
    controller tier. Returns the world's devices in rank order and this
    controller's first world rank."""
    from ompi_tpu_torch.core import multictl
    from ompi_tpu_torch.pml.perrank import Router
    me = int(var.var_get("mpi_base_process_id", -1))
    hosts = int(var.var_get("mpi_base_num_processes", 0))
    addr = var.var_get("mpi_base_coordinator", "")
    if me < 0 or hosts <= 0 or me >= hosts or not addr:
        raise MPIError(ERR_OTHER, "multi-controller Init needs the "
                                  "coordinator address, this host's id and "
                                  "the host count (launch through mpirun "
                                  "--coordinator host:port --num-hosts H "
                                  "--host-id I)")
    server = None
    if me == 0:
        from torch.distributed import TCPStore
        host, port = addr.rsplit(":", 1)
        server = TCPStore(host, int(port), is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=KV_TIMEOUT))
    kv = _Kv(addr)
    kv.set(f"ompi_tpu_torch/mc/rows/{me}",
           json.dumps([str(d) for d in local]))
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    router = Router(me, hosts, kv.set, kv.get, local[0])
    kv.fence("init", hosts)
    router.wire_up()
    rows = [json.loads(kv.get(f"ompi_tpu_torch/mc/rows/{h}"))
            for h in range(hosts)]
    kinds = {torch.device(d).type for r in rows for d in r}
    if len(kinds) != 1:
        raise MPIError(ERR_OTHER, f"controllers bind different device kinds "
                                  f"{sorted(kinds)}; a world is all CUDA or "
                                  f"all CPU")
    ctl = [h for h in range(hosts) for _ in rows[h]]
    devices = [torch.device(d) for r in rows for d in r]
    multictl.configure(ctl, me, router, local[0])
    # the staged host path is collective across controllers: host 0's
    # probe decides the switch point for every controller
    _adopt_stage_probe(kv, router, me, hosts, local[0])
    _state.update(router=router, kv=kv, store_server=server)
    return devices, sum(len(r) for r in rows[:me])


class _Kv:
    """The coordination KV over the job's TCPStore: ``set``, a blocking
    ``get`` bounded by ``KV_TIMEOUT``, and a fence built on
    ``add``/``wait``."""

    def __init__(self, addr: str):
        from torch.distributed import TCPStore
        host, port = addr.rsplit(":", 1)
        self.store = TCPStore(host, int(port), is_master=False,
                              timeout=datetime.timedelta(seconds=KV_TIMEOUT))

    def set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def get(self, key: str) -> str:
        try:
            return self.store.get(key).decode()
        except RuntimeError as e:        # the store's DistStoreError
            raise MPIError(ERR_OTHER, f"KV get {key!r}: {e}") from e

    def fence(self, name: str, n: int) -> None:
        """Nobody leaves until all ``n`` ranks have arrived."""
        done = f"ompi_tpu_torch/fence/{name}/done"
        if self.store.add(f"ompi_tpu_torch/fence/{name}", 1) == n:
            self.store.set(done, "1")
        try:
            self.store.wait([done])
        except RuntimeError as e:        # the store's DistStoreError
            raise MPIError(ERR_OTHER, f"fence {name!r}: {e}") from e


def _bind_device(local_rank: int) -> torch.device:
    """The rank's device: cuda:(local_rank % device_count), or the CPU
    when the job asked for it. Never the CPU on its own."""
    want = str(var.var_get("mpi_base_device", "") or "").strip()
    if want == "cpu":
        return torch.device("cpu")
    if want and want != "cuda":
        raise MPIError(ERR_OTHER, f"mpi_base_device={want!r}: expected "
                                  f"'cpu' or empty")
    if not torch.cuda.is_available():
        raise MPIError(ERR_OTHER,
                       "per-rank Init found no CUDA device; set "
                       "mpi_base_device=cpu (mpirun --mca mpi_base_device "
                       "cpu) to bind the ranks to the CPU")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _init_per_rank(requested: int) -> int:
    """Per-rank bring-up: bind the device, open the KV, publish the
    endpoints, build COMM_WORLD and COMM_SELF, fence, then wire every
    pair (the add_procs + modex + fence of instance.c:508-569)."""
    from ompi_tpu_torch.core.rankcomm import RankCommunicator
    from ompi_tpu_torch.pml.perrank import Router
    rank = int(var.var_get("mpi_base_process_id", -1))
    nprocs = int(var.var_get("mpi_base_num_processes", 0))
    addr = var.var_get("mpi_base_coordinator", "")
    if rank < 0 or nprocs <= 0 or not addr:
        raise MPIError(ERR_OTHER, "per-rank Init needs the job's store "
                                  "address, rank and size (launch through "
                                  "mpirun --per-rank)")
    device = _bind_device(rank)          # one host: local rank == rank
    # every span this process records carries its world rank: the
    # exporter's pid and the attribution layer's participant identity
    from ompi_tpu_torch import trace
    trace.set_process_rank(rank)
    accelerator.select_for_devices([device])
    _register_component_vars()
    kv = _Kv(addr)
    router = Router(rank, nprocs, kv.set, kv.get, device)
    world = RankCommunicator(Group(range(nprocs)), rank, router, device,
                             cid="w", name="MPI_COMM_WORLD")
    self_comm = RankCommunicator(Group([rank]), rank, router, device,
                                 cid=("self", rank), name="MPI_COMM_SELF")
    # init fence (ompi_mpi_init.c:434-447): nobody proceeds until every
    # rank's endpoints are published; then wire every pair eagerly
    kv.fence("init", nprocs)
    router.wire_up()
    _arm_resilience(router, rank, nprocs)
    _adopt_stage_probe(kv, router, rank, nprocs, device)
    INFO_ENV.set("command", os.environ.get("_", ""))
    INFO_ENV.set("maxprocs", str(nprocs))
    INFO_ENV.set("host", socket.gethostname())
    INFO_ENV.set("arch", device.type)
    _state.update(initialized=True, finalized=False, world=world,
                  self=self_comm, router=router, kv=kv,
                  thread_level=min(requested, THREAD_MULTIPLE))
    # a spawned world dials back to its parent job through the dpm port
    # plane (MPI_Comm_spawn's parent-nspace handshake, dpm.c:108-170);
    # MPI_Comm_get_parent returns the resulting intercommunicator
    parent_port = os.environ.get("OMPI_TPU_TORCH_PARENT_PORT")
    if parent_port:
        from ompi_tpu_torch.core import dpm_perrank
        global _parent_intercomm
        _parent_intercomm = dpm_perrank.comm_connect(parent_port, world,
                                                     root=0)
    return _state["thread_level"]


def _arm_resilience(router, rank: int, nprocs: int) -> None:
    """The per-rank resilience and telemetry wiring, after wire_up (the
    first heartbeat tick finds identified connections, not connect
    storms). The ring heartbeat detector is off unless
    ``mpi_base_ft_hb_period`` > 0; its beats ride the unsequenced tcp
    ctl path, so they take no ``_sq`` slot of the ordered data plane and
    never queue behind data. With telemetry on, the health monitor
    samples from the progress loop and the pml recv ingress, and the
    flight recorder listens for proc failures."""
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.ft.detector import Detector
    from ompi_tpu_torch.runtime import ft

    def send_hb(peer: int) -> None:
        hb = {"ctl": "hb", "peer": router.rank}
        if telemetry.active:
            # RTT stamp, only while telemetry is on: the receiver echoes
            # it back as "hbr"; with the plane off the frame is unchanged
            hb["ht"] = time.perf_counter()
        router.endpoint.tcp.send_frame(peer, hb)

    det = Detector(rank, nprocs, send_hb, ft.default_registry())
    det.departed = lambda r: r in router._departed
    if det.start():
        router.detector = det
    if telemetry.active:
        from ompi_tpu_torch.telemetry import flightrec, health
        health.install(rank, nprocs)
        flightrec.arm(rank)


def _adopt_stage_probe(kv: "_Kv", router, rank: int, nprocs: int,
                       device: torch.device) -> None:
    """The staging switch point, earned by a probe: rank 0 measures on its
    device (with the bml probe's transport rate as the host tier's wire
    cost) and publishes; every rank adopts the same value, since the
    staging decision is collective. A user-set
    ``coll_tuned_stage_min_bytes`` skips it. A probe that fails on CUDA
    raises; on the CPU it is advisory and 1 MiB stands."""
    if var.var_overridden("coll_tuned_stage_min_bytes"):
        return
    key = "ompi_tpu_torch/coll/stage_probe"
    if rank == 0:
        pb = dict(getattr(router.endpoint, "probe_basis", {}) or {})
        g = None
        if pb.get("ran"):
            g = pb.get("sm_gbps") if not pb.get("sm_demoted") \
                else pb.get("tcp_gbps")
        g = g or pb.get("rail_gbps")
        try:
            value, basis = tuned.staging_probe(
                transport_bps=g * 1e9 if g else None, nranks=nprocs,
                device=device)
        except Exception as e:           # noqa: BLE001
            if device.type == "cuda":
                kv.set(key, json.dumps({"error": f"{type(e).__name__}: "
                                                 f"{e}"}))
                raise MPIError(ERR_OTHER, f"staging probe on {device} "
                                          f"failed: {e}") from e
            value, basis = 1 << 20, {"ran": False, "error": True}
        kv.set(key, json.dumps({"v": value, **basis}))
    d = json.loads(kv.get(key))
    if "v" not in d:
        raise MPIError(ERR_OTHER, f"rank 0's staging probe failed: "
                                  f"{d.get('error')}")
    tuned.adopt_probed_stage_min(int(d.pop("v")), d)


def finalize() -> None:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI not initialized or already finalized")
    # "all communication is complete at finalize": drain the device.
    # With a known-dead peer the drain barrier can never complete (a live
    # peer may itself be blocked on the dead one), and a revoked world
    # refuses it: skip it then.
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.runtime import ft
    w = _state["world"]
    if not ft.any_failed() and not w.is_revoked():
        w.barrier()
    # telemetry teardown first: the health monitor's progress callback
    # and the flight recorder's registry listener must not outlive the
    # world they observe
    telemetry.shutdown()
    router = _state["router"]
    if router is not None:
        from ompi_tpu_torch.core import multictl, rankcomm
        controllers = multictl.active()
        if controllers:
            # the hidden controller tiers fence as they free their slots
            multictl.close()
        # later EOFs are departures, not deaths; after the fini fence no
        # peer reads this rank's slots any more, so they are freed last
        router.begin_shutdown()
        if not ft.any_failed():      # a dead rank never reaches the fence
            _state["kv"].fence("fini", router.nprocs)
        rankcomm.close_device_tiers()
        router.close()
        if router.device.type == "cuda":
            torch.cuda.ipc_collect()
        if controllers:
            _leave_controllers(router.nprocs)
    global _parent_intercomm
    _parent_intercomm = None
    _state.update(finalized=True, world=None, self=None, router=None,
                  kv=None, store_server=None)


def _leave_controllers(hosts: int) -> None:
    """The multi-controller job's last step: every host says it left;
    host 0, whose process serves the store, waits for them all before
    sweeping the job's shared-memory files (every host has closed its
    own by then) and returning, so no host loses the store mid-fence."""
    store = _state["kv"].store
    store.add("ompi_tpu_torch/mc/left", 1)
    if _state.get("store_server") is None:
        return
    deadline = time.monotonic() + KV_TIMEOUT
    while store.add("ompi_tpu_torch/mc/left", 0) < hosts:
        if time.monotonic() > deadline:
            break                        # a host is gone: sweep anyway
        time.sleep(0.01)
    from ompi_tpu_torch.tools.mpirun import sweep_shm
    sweep_shm(var.var_get("mpi_base_coordinator", ""))


def initialized() -> bool:
    return _state["initialized"]


def finalized() -> bool:
    return _state["finalized"]


def query_thread() -> int:
    """MPI_Query_thread: the level ``init`` granted."""
    return _state["thread_level"]


def comm_world() -> Communicator:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI is not active (call Init first)")
    return _state["world"]


def comm_self() -> Communicator:
    if not _state["initialized"] or _state["finalized"]:
        raise MPIError(ERR_OTHER, "MPI is not active (call Init first)")
    return _state["self"]


def processor_name() -> str:
    """MPI_Get_processor_name: host and the rank's device."""
    a = accelerator.device_attrs(comm_world().device)
    return f"{socket.gethostname()}/{a['platform']}:{a['id']}"


def wtime() -> float:
    return time.perf_counter()


def wtick() -> float:
    return 1e-9


def _reset_for_tests() -> None:
    """Forget the world, the var store and the framework opens, so the
    next ``init`` starts as a fresh process would (re-reading the
    environment); empty the progress engine's callback lists, zero the
    persistent-collective counters, drop the live bucket fusers, and zero
    the compression counters and error-feedback residuals. A per-rank
    world left open is torn down too: its device-tier slots and mappings,
    the router with its endpoints and devxfer slots, and the store
    client. The tracer is disabled and emptied, and the SPC counters,
    the monitoring table, the hooks' drop count and the skew watermarks
    are zeroed. The failure registry is emptied, the telemetry plane is
    disarmed with its histograms dropped, and the injection plane's gate
    is closed, and the lock witness is uninstalled and emptied. The
    sessions' refcount and per-rank create ordinals, the
    DPM registry and the open per-rank ports are emptied. The
    multi-controller table and its tiers are forgotten, and the device
    tier's byte counters zeroed."""
    global _parent_intercomm
    from ompi_tpu_torch import telemetry, trace
    from ompi_tpu_torch.coll import acoll
    from ompi_tpu_torch.core import dpm, dpm_perrank
    from ompi_tpu_torch.runtime import session
    from ompi_tpu_torch.ft import inject
    from ompi_tpu_torch.runtime import ft
    from ompi_tpu_torch.telemetry import flightrec
    from ompi_tpu_torch.coll import monitoring
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.runtime import spc
    from ompi_tpu_torch.utils import hooks
    lockwitness.uninstall()
    lockwitness.reset()
    trace.disable()
    trace.reset()
    trace.set_process_rank(-1)
    trace.attribution.reset_watermarks()
    spc.reset()
    monitoring.reset()
    hooks._reset_drops_for_tests()
    router = _state["router"]
    from ompi_tpu_torch.core import multictl
    multictl._reset_for_tests()
    if router is not None:           # a test that never finalized
        rankcomm.close_device_tiers()
        router.close()
    for k in rankcomm.counters:
        rankcomm.counters[k] = 0
    for k in rankcomm.tier_bytes:
        rankcomm.tier_bytes[k] = 0
    tuned._reset_for_tests()
    pipeline.reset_stats()
    shmseg._reset_for_tests()
    _state.update(initialized=False, finalized=False, world=None, self=None,
                  router=None, kv=None, store_server=None)
    _parent_intercomm = None
    session._reset_for_tests()
    acoll._reset_for_tests()
    dpm._reset_for_tests()
    dpm_perrank._reset_for_tests()
    ft._reset_for_tests()
    telemetry._reset_for_tests()
    flightrec._reset_for_tests()
    var._reset_for_tests()
    inject.refresh()
    progress._reset_for_tests()
    persistent._reset_for_tests()
    compress._reset_for_tests()
    for fw in base.all_frameworks().values():
        fw.close()
    accelerator.framework._reset_for_tests()
