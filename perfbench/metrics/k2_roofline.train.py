"""k2_roofline.train: K2's share of its byte roofline — Eq. 8c-8d's bytes
over (replicas, parameters) f32 and one x̄ (``roofline.k2_bytes``) at
3.35 TB/s, over K2's mean device time a launch in the profiled rounds."""
from perfbench import roofline


def read(rec):
    w = rec.window
    if w is None:
        return None
    t, n = w.kernel_time("parle_sync_kernel")
    if n == 0:
        return None
    need = roofline.k2_bytes(rec.extra["replicas"], rec.extra["params"])
    return 100.0 * need / roofline.PEAK_BYTES_PER_S / (t / n)
