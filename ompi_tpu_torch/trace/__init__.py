"""ompi_tpu_torch.trace — per-rank collective/pt2pt tracing, the port of
``ompi_tpu/trace``.

Counters (SPC, pvars, monitoring tables) answer "how many / how much";
this subsystem answers "when / who was late": a fixed-capacity span
ring fed by begin/end instrumentation at the collective entry points
(coll composer + per-rank interposition), pt2pt (pml/perrank), the btl
flush paths (tcp/sm), the pipeline's segments and rails and progress
wakeups — exported as Perfetto JSON and attributed per collective
(arrival skew, critical rank, blocked vs in-op time). A span is host
time (``time.perf_counter``, ``CLOCK_MONOTONIC``, shared by every
process of one host, so per-rank dumps there align with zero offsets).
A span on a CUDA path ends when the call returns: at enqueue on the
single-controller tier, after the host fences on the per-rank device
tier. No instrumentation point synchronizes the card.

Armed by the MCA var ``mpi_base_trace_enable``, by ``enable()``, or by
a recording ``torch.profiler`` session, for its length; while a
profiler records, every span is mirrored as a profiler range of its
name, on the profiler's clock beside the device operations. The spans
inside the data-parallel sync and the device collectives (``ddp.*``,
``coll.startall``, ``coll.bucket_*``, ``coll.fused_allreduce``,
``coll.request_wait``, ``coll.body``) are recorded
whichever way it is armed.

Hot-path contract: every point is gated on ``core.active or
torch.autograd.profiler._is_profiler_enabled`` (two module-attribute
reads when both are off: no span allocation, no range, no locking
beyond the existing SPC path).
"""
from ompi_tpu_torch.trace import attribution, perfetto    # noqa: F401
from ompi_tpu_torch.trace.core import (                    # noqa: F401
    begin, disable, dump, enable, end, instant, load_dump,
    maybe_enable_from_var, process_rank, reset, set_process_rank, span,
    span_dicts, spans, stats, tracing_enabled, wrap_coll_vtable,
)
from ompi_tpu_torch.trace.ring import Span, SpanRing      # noqa: F401
