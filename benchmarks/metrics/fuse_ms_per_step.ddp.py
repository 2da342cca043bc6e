"""fuse_ms_per_step.ddp (ms, program span): the host's time in
``coll.bucket_flush`` spans (``coll/persistent.BucketFuser``: pack, the
fused allreduce's launch, unpack) inside a step's ``ddp.sync`` span,
summed per step and averaged over the steps of the first profiled pass
(the device-only one, whose host cost is lowest): the first
``profile_steps`` ``ddp.sync`` spans in time order. The program's
tracer records while the profiler does. None for another kind of
record, an untraced run, no spans, or a ring that dropped any."""


def read(rec):
    if rec.get("kind") != "grad_sync" or not rec.get("profile"):
        return None
    from ompi_tpu_torch import trace
    k = int(rec.get("profile_steps") or 0)
    spans = sorted(trace.spans(), key=lambda s: s.ts)
    steps = [s for s in spans if s.name == "ddp.sync"][:k]
    if trace.stats()["dropped"] or k < 1 or len(steps) < k:
        return None
    flushes = [s for s in spans if s.name == "coll.bucket_flush"]
    total = sum(f.dur for st in steps for f in flushes
                if st.ts <= f.ts and f.ts + f.dur <= st.ts + st.dur)
    return total / k * 1e3
