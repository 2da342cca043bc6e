"""step_hbm_share.ddp (%, device trace): each rank's gradients read once
and its mean written once, over the device's busy time per step in the
traced steps (torch.profiler, device activity only), against the card's
published HBM bandwidth. Nothing where the profiler saw no device
activity or the card has no entry in the table of peaks."""
from benchlib import device, least_bytes


def read(rec):
    p = rec.get("profile") or {}
    peak = device.peak(rec.get("device_kind", ""), "hbm_bytes_per_s")
    if (rec.get("kind") != "grad_sync" or not p.get("busy_s")
            or not rec.get("profile_steps") or not peak):
        return None
    busy_per_step = p["busy_s"] / rec["profile_steps"]
    n = rec["ranks"]
    return 100.0 * least_bytes.grad_sync(n, rec["grad_bytes"] // n) \
        / peak / busy_per_step
