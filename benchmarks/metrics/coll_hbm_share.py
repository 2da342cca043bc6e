"""coll_hbm_share (%, device trace): the least bytes of every call in the
window (``benchlib/least_bytes``: each send buffer that carries data read
once, each receive buffer MPI defines written once) over the calls'
device time from CUDA events around each call, against the card's
published HBM bandwidth. Nothing where the card has no entry in the
table of peaks."""
from benchlib import device


def read(rec):
    t = rec.get("call_device_s")
    peak = device.peak(rec.get("device_kind", ""), "hbm_bytes_per_s")
    if rec.get("kind") != "collectives" or not t or not peak:
        return None
    return 100.0 * sum(rec["call_least_bytes"]) / sum(t) / peak
