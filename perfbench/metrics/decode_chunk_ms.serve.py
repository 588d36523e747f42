"""decode_chunk_ms.serve: the engine's mean ``decode_chunk`` span in the
window (the graph's replay and the host copy of its tokens that ends
it) over the decode steps a chunk holds: milliseconds a decode step."""


def read(rec):
    durs = [d for name, d, _ in rec.spans if name == "decode_chunk"]
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs) / rec.extra["decode_chunk"]
