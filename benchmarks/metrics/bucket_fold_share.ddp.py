"""bucket_fold_share.ddp (%, program counter): the share of bucket
flushes that ran as one bucket fold (``ops/bucket_fold``) in the run,
``100 * coll_bucket_folds / coll_bucket_flushes`` from
``coll/persistent.counters()``. None for another kind of record, where
either counter is missing (a program without the fold) or where no
flush ran."""


def read(rec):
    if rec.get("kind") != "grad_sync":
        return None
    from ompi_tpu_torch.coll import persistent
    c = persistent.counters()
    folds, flushes = c.get("coll_bucket_folds"), c.get("coll_bucket_flushes")
    if folds is None or not flushes:
        return None
    return 100.0 * folds / flushes
