"""bucket_flushes_per_step (count, program counter): the change of
``coll/persistent.counters()["coll_bucket_flushes"]`` over the window's
steps, per step (0 with the bucket off)."""


def read(rec):
    if rec.get("kind") != "grad_sync" or not rec.get("steps"):
        return None
    return rec["flushes"] / rec["steps"]
