"""wait_ms_per_step.ddp (ms, program span): the host's time in
``coll.request_wait`` spans (``coll/persistent``: a wait on a start's
completion event that blocked) inside a step's ``ddp.sync`` span, summed
per step and averaged over the steps of the first profiled pass (the
device-only one, whose host cost is lowest): the first
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
    waits = [s for s in spans if s.name == "coll.request_wait"]
    total = sum(w.dur for st in steps for w in waits
                if st.ts <= w.ts and w.ts + w.dur <= st.ts + st.dur)
    return total / k * 1e3
