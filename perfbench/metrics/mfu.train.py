"""mfu.train: the whole training step's share of the card's TF32 peak —
the benchmark's model FLOPs of a round (forward and backward of every
replica's every step, ``roofline.train_step_flops``) over the wall time
of the program's ``round`` spans (each blocks on its round's result),
the profiled rounds left out."""
from perfbench import roofline


def read(rec):
    walls = rec.extra.get("round_walls_s")
    if not walls:
        return None
    return (100.0 * rec.extra["flops_per_round"] * len(walls) / sum(walls)
            / roofline.PEAK_FLOPS["tf32"])
