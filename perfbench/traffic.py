"""The one traffic generator: it reads a mix file's parameters and makes a
run's inputs from its seed.

Serving (``"kind": "serve"``): an open loop.  Requests are due at
Poisson arrivals of ``arrivals.rate_per_s`` over the window, with prompt
and output lengths from the mix's distributions and prompts of random
token ids (unique, so no prefix is shared).  The gaps and lengths are the
quantiles of the distributions at (i + 1/2) / n, each set in a free
permutation drawn from the mix's ``order_seed``: runs of short gaps or of
long prompts come as often as independent draws would bring them, and
every run of the mix offers the same requests at the same times.  The
run's seed draws the prompts' token ids; it does not move the work (a
p95 over some hundred requests swings with where the long prompts land,
far more than two runs of one order differ).

Training (``"kind": "train"``): each round's batches, every row of every
step and replica drawn apart from the seed and the round.
"""
from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import numpy as np

from perfbench.reference.weights import derive


class Due(NamedTuple):
    due_s: float             # seconds after the window opens
    prompt: np.ndarray       # (T,) int32
    max_new: int


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The distribution's quantiles at (i + 1/2) / n, i < n, as whole
    numbers inside [min, max].  ``lognormal``: ``median`` and ``sigma``
    of the log."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    z = np.array([statistics.NormalDist().inv_cdf(p) for p in u])
    vals = dist["median"] * np.exp(dist["sigma"] * z)
    lo, hi = dist.get("min", 1), dist.get("max", math.inf)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def token_vocab(cfg: dict) -> int:
    """The token ids a prompt draws from: the tokenizer's vocabulary."""
    return int(cfg["vocab_size"])


def serve_schedule(mix: dict, cfg: dict, seed: int, seconds: float) -> list:
    """The requests due in a window of ``seconds``, by due time."""
    rate = float(mix["arrivals"]["rate_per_s"])
    if mix["arrivals"]["process"] != "poisson":
        raise ValueError("arrivals: only 'poisson' is generated")
    n = max(1, round(rate * seconds))
    order = np.random.default_rng(derive(int(mix["order_seed"]), "order"))
    u = (np.arange(n) + 0.5) / n
    gaps = order.permutation(-np.log1p(-u) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    prompts = order.permutation(quantiles(mix["prompt_len"], n))
    outputs = order.permutation(quantiles(mix["output_len"], n))
    rng = np.random.default_rng(derive(seed, "serve"))
    V = token_vocab(cfg)
    return [Due(float(t), rng.integers(0, V, int(p), dtype=np.int32),
                int(g)) for t, p, g in zip(due, prompts, outputs)]


def warmup_requests(mix: dict, cfg: dict, seed: int) -> list:
    """The set-up's requests: the mix's ``warmup`` list of prompt and
    output lengths, with their own token ids."""
    rng = np.random.default_rng(derive(seed, "warmup"))
    V = token_vocab(cfg)
    return [Due(0.0, rng.integers(0, V, w["prompt"], dtype=np.int32),
                w["output"]) for w in mix["warmup"]]


def max_len(mix: dict) -> int:
    """The longest prompt plus the longest output a request can have."""
    return int(mix["prompt_len"]["max"] + mix["output_len"]["max"])


def train_batches(mix: dict, cfg: dict, seed: int, device):
    """``batches(r)``: round r's {"tokens", "labels"} of (L, n, B, T)
    int32 on ``device``, the labels the next token of each row."""
    import torch
    shape = (mix["L"], mix["replicas"], mix["batch"], mix["seq"] + 1)
    V = token_vocab(cfg)

    def batches(r: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(
            derive(seed, "round", int(r)))
        seq = torch.randint(0, V, shape, generator=gen, device=device,
                            dtype=torch.int64).to(torch.int32)
        return {"tokens": seq[..., :-1].contiguous(),
                "labels": seq[..., 1:].contiguous()}

    return batches
