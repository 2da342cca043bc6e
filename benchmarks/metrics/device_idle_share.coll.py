"""device_idle_share.coll (%, device trace): the share of the traced
window in which no operation ran on the card (torch.profiler)."""


def read(rec):
    p = rec.get("profile") or {}
    if rec.get("kind") != "collectives" or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
