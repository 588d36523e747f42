"""k1_roofline.train: K1's share of its byte roofline — Eq. 8a-8b's bytes
over (replicas, parameters) f32 (``roofline.k1_bytes``) at 3.35 TB/s,
over K1's mean device time a launch in the profiled rounds."""
from perfbench import roofline


def read(rec):
    w = rec.window
    if w is None:
        return None
    t, n = w.kernel_time("parle_inner_kernel")
    if n == 0:
        return None
    need = roofline.k1_bytes(rec.extra["replicas"], rec.extra["params"])
    return 100.0 * need / roofline.PEAK_BYTES_PER_S / (t / n)
