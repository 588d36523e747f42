"""prefill_chunk_ms.serve: the engine's mean ``prefill_chunk`` span in
the window (one slot's chunk of its prompt, its graph's replay, and the
wait for it or the host copy of the first token)."""


def read(rec):
    durs = [d for name, d, _ in rec.spans if name == "prefill_chunk"]
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs)
