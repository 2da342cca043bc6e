"""step_p95_ms (ms, host clock): the 95th percentile of every step's time
in the window, each from handing in the gradients to the synchronised
result."""
import numpy as np


def read(rec):
    if rec.get("kind") != "grad_sync" or not rec.get("step_s"):
        return None
    return float(np.percentile(np.asarray(rec["step_s"]), 95)) * 1e3
