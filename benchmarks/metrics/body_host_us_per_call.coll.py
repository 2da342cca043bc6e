"""body_host_us_per_call.coll (us, program span): the median host time
of a ``coll.body`` span (``coll/torch_``: the launches of the selected
schedule, after its selection) over the first profiled pass (the
device-only one, whose host cost is lowest): the first half, in time
order, of the ``coll.body`` spans of the run's two equal profiled
passes. The program's tracer records while the profiler does. None for
another kind of record, an untraced run, no spans, or a ring that
dropped any."""
import statistics


def read(rec):
    if rec.get("kind") != "collectives" or not rec.get("profile"):
        return None
    from ompi_tpu_torch import trace
    bodies = sorted((s for s in trace.spans() if s.name == "coll.body"),
                    key=lambda s: s.ts)
    first = bodies[:len(bodies) // 2]
    if trace.stats()["dropped"] or not first:
        return None
    return statistics.median(s.dur for s in first) * 1e6
