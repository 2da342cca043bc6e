"""entry_self_ms_per_step.ddp (ms, program span): a step's ``ddp.sync``
span (``models/transformer.BucketedGradSync.__call__``) less the union
of the ``coll.bucket_flush`` and ``coll.request_wait`` spans inside it:
the copy-in and mean launches and the Python around them. Averaged over
the steps of the first profiled pass (the device-only one, whose host
cost is lowest): the first ``profile_steps`` ``ddp.sync`` spans in time
order. The program's tracer records while the profiler does. None for
another kind of record, an untraced run, no spans, or a ring that
dropped any."""

CHILDREN = ("coll.bucket_flush", "coll.request_wait")


def _covered(iv):
    """Length of the union of intervals ``(start, end)``."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(iv):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def read(rec):
    if rec.get("kind") != "grad_sync" or not rec.get("profile"):
        return None
    from ompi_tpu_torch import trace
    k = int(rec.get("profile_steps") or 0)
    spans = sorted(trace.spans(), key=lambda s: s.ts)
    steps = [s for s in spans if s.name == "ddp.sync"][:k]
    if trace.stats()["dropped"] or k < 1 or len(steps) < k:
        return None
    kids = [s for s in spans if s.name in CHILDREN]
    total = 0.0
    for st in steps:
        end = st.ts + st.dur
        total += st.dur - _covered([(c.ts, c.ts + c.dur) for c in kids
                                    if st.ts <= c.ts and c.ts + c.dur <= end])
    return total / k * 1e3
