"""The one traffic generator: it repeats for a seed, offers every seed the
same requests at the same times in the order the mix draws, and gives the
distributions the mix states."""
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from perfbench import traffic

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CHAT = json.loads((ROOT / "perfbench" / "mixes" / "{}.json".format(
    [w["traffic"] for w in MAN["workloads"]
     if w["name"] == "mamba2-1.3b.serve.chat"][0])).read_text())
TRAIN = json.loads((ROOT / "perfbench" / "mixes" / "train.seq2048.json")
                   .read_text())
QWEN = json.loads((ROOT / "perfbench" / "configs" / "qwen2.5-3b.json")
                  .read_text())


def schedule(seed, seconds=50.0, order_seed=None):
    mix = CHAT if order_seed is None else dict(CHAT, order_seed=order_seed)
    return traffic.serve_schedule(mix, QWEN, seed, seconds)


def test_repeats_for_a_seed():
    a, b = schedule(2**31 + 11), schedule(2**31 + 11)
    assert [r.due_s for r in a] == [r.due_s for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new for r in a] == [r.max_new for r in b]


def test_seeds_move_the_tokens_not_the_work():
    """The run's seed draws the prompts' token ids; the requests' times
    and lengths are the mix's, the same for every seed."""
    a, b = schedule(7), schedule(8)
    assert [r.due_s for r in a] == [r.due_s for r in b]
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new for r in a] == [r.max_new for r in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_stated_distributions():
    seconds = 200.0
    reqs = schedule(3, seconds)
    rate = CHAT["arrivals"]["rate_per_s"]
    assert len(reqs) == round(rate * seconds)
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and due[0] == 0.0 and due[-1] < seconds
    gaps = np.diff(due)
    assert abs(gaps.mean() * rate - 1.0) < 0.05          # Poisson: mean 1/rate
    assert abs(np.median(gaps) * rate - np.log(2)) < 0.05
    p = [len(r.prompt) for r in reqs]
    g = [r.max_new for r in reqs]
    pl, ol = CHAT["prompt_len"], CHAT["output_len"]
    assert min(p) >= pl["min"] and max(p) <= pl["max"]
    assert min(g) >= ol["min"] and max(g) <= ol["max"]
    assert abs(statistics.median(p) / pl["median"] - 1) < 0.05
    assert abs(statistics.median(g) / ol["median"] - 1) < 0.05
    # the log's spread is the stated sigma inside the clipping
    mid = np.log(np.sort(p)[len(p) // 4:3 * len(p) // 4])
    assert abs((mid[-1] - mid[0]) / (2 * 0.6745) - pl["sigma"]) < 0.1


def test_prompts_unique_and_in_vocab():
    reqs = schedule(5)
    heads = {tuple(r.prompt[:16]) for r in reqs}
    assert len(heads) == len(reqs)
    assert all(r.prompt.dtype == np.int32 for r in reqs)
    assert max(int(r.prompt.max()) for r in reqs) < QWEN["vocab_size"]


def test_train_batches_repeat_and_rows_differ():
    mix = dict(TRAIN, seq=32)
    cfg = {"vocab_size": 1000}
    b = traffic.train_batches(mix, cfg, 2**33 + 1, torch.device("cpu"))
    x, y = b(4), b(4)
    assert torch.equal(x["tokens"], y["tokens"])
    assert x["tokens"].shape == (mix["L"], mix["replicas"], mix["batch"], 32)
    assert torch.equal(x["labels"][..., :-1], x["tokens"][..., 1:])
    rows = x["tokens"].reshape(-1, 32)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert not torch.equal(b(5)["tokens"], x["tokens"])


def test_every_order_gets_the_same_gaps():
    """The gaps are the exponential's quantiles at (i + 1/2) / n, the
    same set for every order the mix can draw, in another order."""
    a, b = schedule(21, 51.0, order_seed=1), schedule(21, 51.0, order_seed=2)
    ga, gb = np.diff([r.due_s for r in a]), np.diff([r.due_s for r in b])
    rate, n = CHAT["arrivals"]["rate_per_s"], len(a)
    u = (np.arange(n) + 0.5) / n
    full = np.sort(-np.log1p(-u) / rate)
    for g in (ga, gb):          # n - 1 gaps: all of the set but the last
        assert np.isin(np.round(g, 9), np.round(full, 9)).all()
    assert not np.array_equal(ga, gb)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_free_order_lets_long_prompts_and_short_gaps_cluster():
    """The order is a free permutation: over the orders a mix can draw,
    16 consecutive requests sometimes hold more than four of the longest
    tenth of the prompts, or of the shortest tenth of the gaps, as
    independent arrivals would."""
    most_p = most_g = 0
    for k in range(40):
        reqs = schedule(5, 51.0, order_seed=1000 + k)
        p = np.array([len(r.prompt) for r in reqs])
        gaps = np.diff([r.due_s for r in reqs])
        win = np.ones(16, int)
        most_p = max(most_p, np.convolve(p >= np.quantile(p, 0.9), win,
                                         "valid").max())
        most_g = max(most_g, np.convolve(gaps <= np.quantile(gaps, 0.1),
                                         win, "valid").max())
    assert most_p > 4 and most_g > 4
