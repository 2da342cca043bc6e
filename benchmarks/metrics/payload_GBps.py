"""payload_GBps (GB/s, host clock): the per-rank payload of every call
completed in the window over the whole window, which ends with a
``synchronize``. A call's payload is its nccl-tests size (the mix's
``bytes_per_rank``, the larger of a rank's send and receive buffers), as
nccl-tests' algbw counts it."""


def read(rec):
    if rec.get("kind") != "collectives" or not rec.get("window_s"):
        return None
    return rec["calls"] * rec["payload_bytes"] / rec["window_s"] / 1e9
