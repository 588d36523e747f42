"""device_idle_share.serve: the share of the profiled engine steps in which no
operation ran on the device (1 - the union of the device's intervals
over the profiled window)."""


def read(rec):
    w = rec.window
    if w is None or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.seconds)
