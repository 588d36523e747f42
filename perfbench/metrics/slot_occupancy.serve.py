"""slot_occupancy.serve: the decode tokens kept over the decode capacity
(decode steps times slots) in the window, from the engine's counts —
``Engine.throughput()``'s ``slot_utilization`` taken over the window
alone."""


def read(rec):
    cap = rec.extra["capacity"]
    if cap <= 0:
        return None
    return 100.0 * rec.extra["kept_tokens"] / cap
