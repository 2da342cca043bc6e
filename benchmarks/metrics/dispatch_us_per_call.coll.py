"""dispatch_us_per_call.coll (us, host clock): the median host time of
one collective call, from the call to its return with no sync inside
(api/mpi -> core/communicator -> coll/framework -> coll/tuned ->
coll/torch_'s launches), over the traced run's dispatch rounds, each
call made with the device's queue drained (in the window the queue is
full, so a call's return waits for the device)."""
import statistics


def read(rec):
    d = rec.get("dispatch_s")
    if rec.get("kind") != "collectives" or not d:
        return None
    return statistics.median(d) * 1e6
