"""device_idle_share.train: the share of a round in which no operation ran
on the device: 1 - the device's busy time in the profiled round (the
union of its intervals) over the median wall time of the untraced
rounds' ``round`` spans.

Not over the profiled round's own length: the profiler's bookkeeping on
the host stretches a host-bound round (Mamba2's profiled round takes
6.1-7.0 s against ~4.6 s untraced) and opens gaps that an untraced round
does not have, while the device's own busy time stays as it is."""
import statistics


def read(rec):
    w, walls = rec.window, rec.extra.get("round_walls_s")
    if w is None or not walls:
        return None
    return 100.0 * (1.0 - w.busy_s() / statistics.median(walls))
