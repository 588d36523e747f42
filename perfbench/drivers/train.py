"""A training cell: the program's fused Parle round, as ``launch/train.py``
builds it (``RoundRunner.run_rounds`` over ``make_algorithm_round``, the
updates through K1 and K2), on the benchmark's weights and batches.

Set-up builds the one training object (state, round program, runner)
and drives it through the mix's ``check_rounds`` first rounds on their
own batches; their readings (each step's loss, the first sync's g_x and
the change of x) are taken then.  The same object then runs whole rounds
until the window has passed: ``train_tokens_per_s`` is every token of
the rounds completed, over the time to the end of the last of them.
After the window the program's state is freed and the plain reference
follows the checked rounds from the same weights and batches.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from perfbench import check, devtrace, roofline, traffic
from perfbench.harness import Outcome, Record
from perfbench.reference import lm
from perfbench.reference import parle as ref_parle
from perfbench.reference.products import Products
from perfbench.reference.weights import leaf_items, make_params


def parle_hp(mix: dict) -> dict:
    """The mix's Parle hyper-parameters, as both sides read them."""
    return {k: mix[k] for k in (
        "replicas", "L", "lr", "lr_inner", "momentum", "alpha", "gamma0",
        "rho0", "gamma_min", "rho_min", "batches_per_epoch",
        "scale_lr_by_gamma")}


class Job:
    """The one training object of a run: the program's state, its round
    program and runner, the batches, and what set-up read."""

    def __init__(self, cell):
        from repro_torch.configs.base import ParleConfig
        from repro_torch.core import registry
        from repro_torch.core.parle import dealias_state
        from repro_torch.launch.steps import make_algorithm_round
        from repro_torch.obs import Obs, Tracer
        from repro_torch.runtime import RoundRunner
        from repro_torch.runtime.precision import pin_float32

        cfg, mix, dev = cell.cfg, cell.mix, cell.device
        hp = parle_hp(mix)
        self.cell, self.L = cell, mix["L"]
        self.tokens_per_round = (mix["L"] * mix["replicas"] * mix["batch"]
                                 * mix["seq"])
        pin_float32()
        x0 = make_params(cell.reference.leaves(cfg), cell.seed, dev)
        algo = registry.get("parle")
        pcfg = algo.canonicalize_cfg(ParleConfig(
            n_replicas=hp["replicas"], L=hp["L"], alpha=hp["alpha"],
            gamma0=hp["gamma0"], rho0=hp["rho0"],
            gamma_min=hp["gamma_min"], rho_min=hp["rho_min"],
            momentum=hp["momentum"], lr=hp["lr"], lr_inner=hp["lr_inner"],
            batches_per_epoch=hp["batches_per_epoch"],
            scale_lr_by_gamma=hp["scale_lr_by_gamma"]))
        self.state = dealias_state(algo.init(x0, pcfg))
        self.round_fn = make_algorithm_round(
            "parle", cell.adapter.port_config(cfg), pcfg,
            use_kernel=mix["use_kernel"])
        self.obs = Obs()
        if cell.trace:
            self.obs.tracer = Tracer(enabled=True, collect=True)
            self.obs.enabled = True
        self.runner = RoundRunner(self.obs, ns="train")
        self.batches = traffic.train_batches(mix, cfg, cell.seed, dev)
        self.logged, self.at = [], 0

        # set-up: the checked rounds, which also warm every shape up
        n, step = hp["replicas"], hp["lr"] * (1.0 + hp["momentum"])
        for r in range(mix["check_rounds"]):
            self.one_round()
            if r == 0:
                grad = _norms(x0, self.state.tree()["x"], n,
                              lambda a, b: (a - b) / step)
        self.readings = {
            "losses": [float(v) for m in self.logged for v in m["losses"]],
            "grad": grad,
            "change": _norms(x0, self.state.tree()["x"], n,
                             lambda a, b: b - a)}
        del x0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_round(self):
        L = self.L
        self.state, _ = self.runner.run_rounds(
            self.state, self.round_fn, lambda s: self.batches(s // L),
            start=self.at, rounds=1, L=L,
            tokens_per_round=self.tokens_per_round,
            on_round=lambda r, g, m: self.logged.append(m))
        self.at += L


def run(cell) -> Outcome:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    job = Job(cell)
    setup_s = time.perf_counter() - cell.t_start

    # the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window = devtrace.Window() if cell.trace else None
    profiled, failed, rounds = set(), 0, 0
    t0 = time.perf_counter()
    while True:
        tracing = (cell.trace and rounds == mix["profile_after_rounds"]
                   and dev.type == "cuda")
        ctx = (devtrace.traced(window, dev) if tracing
               else contextlib.nullcontext())
        with ctx:
            job.one_round()
            loss = float(job.logged[-1]["loss"])  # waits for the round
        if tracing:
            profiled.add(job.at)
        failed += not math.isfinite(loss)
        rounds += 1
        t_end = time.perf_counter()
        if t_end - t0 >= cell.seconds:
            break
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    record = None
    if cell.trace:
        t_open = (t0 - job.obs.tracer.t0) * 1e6
        spans = [(e["name"], e["dur"] / 1e6, e["args"])
                 for e in job.obs.tracer.events if e["ts"] >= t_open]
        walls = [d for name, d, a in spans
                 if name == "round" and a.get("step") not in profiled]
        n, L, B, T = mix["replicas"], mix["L"], mix["batch"], mix["seq"]
        record = Record(cfg=cfg, mix=mix, spans=spans,
                        window=window if window and window.device else None,
                        extra={"round_walls_s": walls,
                               "flops_per_round": L * n * roofline.
                               train_step_flops(cfg, B, T),
                               "params": roofline.param_count(cfg),
                               "replicas": n})

    # the program's state goes before the reference runs
    prog, batches, tokens = job.readings, job.batches, job.tokens_per_round
    del job
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, batches, Products(tf32=False))
    numbers = check.train_numbers(prog, ref)
    correct, checks = check.verdict(numbers, cell.limits)
    return Outcome(correct=correct and failed == 0, attempted=rounds,
                   failed=failed,
                   metrics={"train_tokens_per_s":
                            rounds * tokens / window_s,
                            "setup_s": setup_s},
                   memory_peak_bytes=peak, checks=checks, record=record,
                   readings={"prog": prog, "ref": ref, "batches": batches})


def _norms(x0: dict, tree, n: int, fn) -> list:
    """Each replica's leaf norms of ``fn(x0 leaf, that replica's leaf of
    tree)``, in the param tree's order."""
    out = []
    for a in range(n):
        row = []
        for path, v0 in leaf_items(x0):
            t = tree
            for k in path:
                t = t[k]
            row.append(float(torch.linalg.vector_norm(fn(v0, t[a]))))
        out.append(row)
    return out


def reference_readings(cell, batches, products) -> dict:
    """The plain reference's readings over the checked rounds, from the
    weights made again from the seed."""
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    params = make_params(cell.reference.leaves(cfg), cell.seed, dev)
    model = cell.reference

    def loss_fn(tree, tokens, labels):
        return lm.loss(model, tree, cfg, tokens, labels, products)

    with products.active():
        out = ref_parle.run_rounds(loss_fn, params, parle_hp(mix),
                                   batches, mix["check_rounds"])
    del params
    return out
