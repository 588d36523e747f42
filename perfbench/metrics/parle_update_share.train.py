"""parle_update_share.train: the device time of the Parle updates, K1
(``parle_inner_kernel``) and K2 (``parle_sync_kernel``), over the time
the device was busy in the profiled rounds."""


def read(rec):
    w = rec.window
    if w is None:
        return None
    t, n = w.kernel_time("parle_inner_kernel", "parle_sync_kernel")
    busy = w.busy_s()
    if n == 0 or busy <= 0:
        return None
    return 100.0 * t / busy
