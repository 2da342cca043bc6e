"""The port's accelerator surface against the reference's (the
accelerator cases of ``tests/test_treematch_accel.py``): streams, events,
in-process IPC handles, host registration, allocation, device queries,
and the message queues a debugger reads.

Each case runs the same steps on the port's 8-rank CPU world (the ``cpu``
accelerator module) and on the reference's 8-device world; the
observations must be identical and results exact. Where the two surfaces
differ by design it is said at the case: a port stream is a CUDA stream
(ordered work, no array list to count), a port event marks a stream
position, and a port ``host_register`` pins pages (counted on the CPU)
instead of marking the array read-only.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch as P
from ompi_tpu.accelerator import current_module as r_module
from ompi_tpu_torch.accelerator import current_module as p_module

N = 8
PORT = SimpleNamespace(name="port", MPI=P, mod=p_module)
REF = SimpleNamespace(name="ref", MPI=ompi_tpu, mod=r_module)


@pytest.fixture()
def worlds(world):
    P._reset_for_tests()
    P.Init(devices=["cpu"] * N)
    yield [(PORT, P.get_comm_world()), (REF, world)]
    P._reset_for_tests()


def _both(worlds, fn):
    (pp, pw), (rp, rw) = worlds
    port, ref = fn(pp, pw), fn(rp, rw)
    assert port == ref, (port, ref)
    return port


def _host(y):
    return (y.cpu().numpy() if isinstance(y, torch.Tensor)
            else np.asarray(y))


def test_stream_ordering_and_sync(worlds):
    def run(pkg, world):
        m = pkg.mod()
        s = m.create_stream()
        a = world.alloc((8,), np.float32, fill=1.0)
        b = world.allreduce(a, pkg.MPI.SUM)
        if pkg is REF:
            s.enqueue(a)
            s.enqueue(b)
        s.sync()
        return _host(b).tolist(), getattr(s, "depth", 0)
    assert _both(worlds, run)[1] == 0


def test_event_record_query_synchronize(worlds):
    def run(pkg, world):
        m = pkg.mod()
        ev = m.create_event()
        fresh = ev.query()                   # nothing recorded
        y = world.allreduce(world.alloc((4,), np.float32, fill=2.0),
                            pkg.MPI.SUM)
        ev.record([y] if pkg is REF else None)
        ev.synchronize()
        return fresh, ev.query(), _host(y).tolist()
    assert _both(worlds, run)[:2] == (True, True)


def test_event_records_stream(worlds):
    def run(pkg, world):
        m = pkg.mod()
        s = m.create_stream()
        y = world.allreduce(world.alloc((4,), np.float32, fill=1.0),
                            pkg.MPI.SUM)
        if pkg is REF:
            s.enqueue(y)
        ev = m.create_event()
        ev.record(s)
        ev.synchronize()
        return ev.query(), _host(y).tolist()
    assert _both(worlds, run)[0] is True


def test_ipc_handles(worlds):
    def run(pkg, world):
        m = pkg.mod()
        buf = world.alloc((16,), np.float32, fill=3.0)
        h = m.get_ipc_handle(buf)
        opened = m.open_ipc_handle(h)
        same = (getattr(opened, "tensor", opened) is buf)
        m.close_ipc_handle(h)
        try:
            m.open_ipc_handle(h)
            raised = False
        except (KeyError, P.MPIError):
            raised = True
        return same, raised
    assert _both(worlds, run) == (True, True)


def test_host_register_pins_and_protects(worlds):
    """Registration is observed alike; the reference also marks the
    array read-only while it is pinned, which the port does not (its
    ``host_register`` pins pages for DMA and leaves numpy's flags)."""
    def run(pkg, world):
        m = pkg.mod()
        buf = np.arange(10, dtype=np.float32)
        m.host_register(buf)
        obs = [m.is_host_registered(buf)]
        m.host_unregister(buf)
        obs.append(m.is_host_registered(buf))
        buf[0] = 99.0                        # writable after unregister
        obs.append(float(buf[0]))
        return obs
    assert _both(worlds, run) == [True, False, 99.0]
    m = r_module()
    buf = np.arange(4, dtype=np.float32)
    m.host_register(buf)
    with pytest.raises(ValueError):
        buf[0] = 1.0                         # the reference's pin
    m.host_unregister(buf)


def test_host_register_refcounts(worlds):
    def run(pkg, world):
        m = pkg.mod()
        buf = np.arange(4, dtype=np.float32)
        m.host_register(buf)
        m.host_register(buf)                 # double register
        m.host_unregister(buf)               # one unregister: still pinned
        obs = [m.is_host_registered(buf)]
        m.host_unregister(buf)               # matched
        obs += [m.is_host_registered(buf), bool(buf.flags.writeable)]
        return obs
    assert _both(worlds, run) == [True, False, True]


def test_host_register_restores_prior_state(worlds):
    def run(pkg, world):
        m = pkg.mod()
        ro = np.frombuffer(b"12345678", dtype=np.uint8)   # born read-only
        m.host_register(ro)
        m.host_unregister(ro)
        return m.is_host_registered(ro), bool(ro.flags.writeable)
    assert _both(worlds, run) == (False, False)


def test_message_queue_dst_filter(worlds):
    """The posted receives a debugger's message-queue view shows for one
    destination rank: the reference's ``tools/debuggers`` view against
    the port's matching engine, which holds the same records (in the C++
    core's request registry, as the reference's does, when the native
    library is loaded; else in its Python queue)."""
    from ompi_tpu.tools import debuggers

    def posted(pkg, c, dst=None):
        if pkg is REF:
            # the native engine's view adds its request handle
            return [{k: v for k, v in p.items() if k != "handle"}
                    for p in debuggers.message_queues(c, dst=dst)["posted"]]
        eng = c._pml
        reqs = (list(eng._reqs.values()) if eng._lib is not None
                else [pr.req for pr in eng.posted])
        return [{"dest": q.dest, "source": q.status.source,
                 "tag": q.status.tag}
                for q in reqs if dst is None or q.dest == dst]

    def run(pkg, world):
        c = world.dup()
        c.irecv(source=1, tag=5, dst=0)
        c.irecv(source=2, tag=6, dst=3)
        shown = posted(pkg, c, dst=3)
        c.send(np.ones(1, np.float32), src=1, dest=0, tag=5)
        c.send(np.ones(1, np.float32), src=2, dest=3, tag=6)
        return shown, len(posted(pkg, c))
    assert _both(worlds, run) == ([{"dest": 3, "source": 2, "tag": 6}], 0)


def test_device_attributes_and_peers(worlds):
    def run(pkg, world):
        m = pkg.mod()
        attrs = m.get_device_attributes(world.devices[0])
        return (attrs["platform"], "coords" in attrs,
                "memory_stats" in attrs,
                m.device_can_access_peer(world.devices[0],
                                         world.devices[1]),
                m.get_device_info()[0])
    assert _both(worlds, run) == ("cpu", True, True, True, "cpu")


def test_mem_alloc(worlds):
    def run(pkg, world):
        m = pkg.mod()
        z = m.mem_alloc((4, 4), np.float32)
        m.event_synchronize([z])
        return tuple(z.shape), float(_host(z).sum()), str(_host(z).dtype)
    assert _both(worlds, run) == ((4, 4), 0.0, "float32")
