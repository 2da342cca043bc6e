"""host_ms_per_step.ddp (ms, host clock): the mean host time of
``BucketedGradSync.__call__`` in the window, up to its return, before
the step's synchronize."""


def read(rec):
    c = rec.get("call_s")
    if rec.get("kind") != "grad_sync" or not c:
        return None
    return sum(c) / len(c) * 1e3
