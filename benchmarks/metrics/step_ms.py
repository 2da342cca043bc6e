"""step_ms (ms, host clock): the whole window over the steps it
completed."""


def read(rec):
    if rec.get("kind") != "grad_sync" or not rec.get("steps"):
        return None
    return rec["window_s"] / rec["steps"] * 1e3
