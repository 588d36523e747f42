"""decode_mfu.serve: the whole decode step's share of the card's peak —
each step's least time, max(operations / 495 TFLOP/s, bytes / 3.35
TB/s) over the slot batch as the step was asked for it
(``roofline.decode_step_cost``: the weights read once, the live keys and
values or states read and written), summed over the window's decode
chunks, over the chunks' ``decode_chunk`` spans."""
from perfbench import roofline


def read(rec):
    durs = [d for name, d, _ in rec.spans if name == "decode_chunk"]
    chunks = rec.extra["decode_chunks"]
    if not durs or len(durs) != len(chunks):
        return None
    least = sum(roofline.least_time_s(*roofline.decode_step_cost(rec.cfg, ln))
                for c in chunks for ln in c["lengths"])
    return 100.0 * least / sum(durs)
