"""Rank-side helpers of the port's distributed tests (not a test module).

It imports no JAX, so a spawned rank starts quickly: :func:`spawn` runs a
function in W processes (spawn, never fork) that join one gloo
``torch.distributed`` world through a ``FileStore``, each on one torch
thread, and returns their results in rank order.  :func:`run_case` runs
one training case of the port — Parle, Elastic-SGD or SGD, rounds or
steps — on a ``ReplicaGroup``'s rows (or, with the trivial group, all of
them in one process) and returns what the tests compare.
"""
from __future__ import annotations

import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 240


def _rank_main(fn, rank, world, store_path, out_q, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        out_q.put((rank, fn(rank, world, *args), None))
    except BaseException:          # reported to the parent, then re-raised
        out_q.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, store_path: str, *args, timeout=TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` spawned ranks of one gloo
    world; returns their results in rank order, or raises with the first
    failing rank's traceback.  Every rank is ended before it returns."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, out_q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):       # drain before joining
            rank, res, err = out_q.get(timeout=timeout)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
    except queue.Empty:
        errors.append(f"ranks timed out after {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]


class ThreadColumns:
    """M "model" ranks of one process, one thread each: the collectives
    of ``sharding/partition.py::MeshGroups`` that
    ``models/megatron.py::TensorParallel`` calls (the conjugate
    copy / reduce pair, the gather, the max), exchanged through a
    barrier and summed in rank order.  ``run(fn)`` runs ``fn(tp)`` on
    each column's ``TensorParallel`` in its own thread (forward and
    backward) and returns the M results."""

    def __init__(self, M: int):
        import threading
        self.M = M
        self._barrier = threading.Barrier(M, timeout=60)
        self._slots = [None] * M

    def exchange(self, m: int, t):
        """Every column's ``t`` (no grad), in column order."""
        self._slots[m] = t.detach()
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out

    def run(self, fn):
        import threading
        from repro_torch.models import megatron
        out, errs = [None] * self.M, []

        def work(m):
            try:
                tp = megatron.TensorParallel(self.M, m, _Column(self, m))
                out[m] = fn(tp)
            except BaseException as e:       # re-raised by the caller
                self._barrier.abort()
                errs.append(e)

        threads = [threading.Thread(target=work, args=(m,))
                   for m in range(self.M)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        if errs:
            raise errs[0]
        assert not any(t.is_alive() for t in threads), "columns timed out"
        return out


class _Column:
    """Column ``m`` of a :class:`ThreadColumns`, as a ``MeshGroups``."""

    def __init__(self, cols, m):
        self.cols, self.m = cols, m

    def sum(self, t):
        parts = self.cols.exchange(self.m, t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def copy_to_model(self, x):
        return _ThreadCopy.apply(x, self)

    def reduce_from_model(self, x):
        return _ThreadReduce.apply(x, self)

    def gather_from_model(self, x, dim):
        return _ThreadGather.apply(x, self, dim)

    def gather_summed_from_model(self, x, dim):
        return _ThreadGatherSummed.apply(x, self, dim)

    def model_max_(self, t):
        parts = self.cols.exchange(self.m, t)
        return t.copy_(torch.stack(parts).amax(0))


class _ThreadCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col):
        ctx.col = col
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.col.sum(g), None


class _ThreadReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col):
        return col.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ThreadGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col, dim):
        parts = col.cols.exchange(col.m, x)
        ctx.col, ctx.dim = col, dim
        ctx.lo = sum(p.shape[dim] for p in parts[:col.m])
        ctx.size = x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.size), None, None


class _ThreadGatherSummed(_ThreadGather):
    @staticmethod
    def backward(ctx, g):
        return (ctx.col.sum(g).narrow(ctx.dim, ctx.lo, ctx.size), None,
                None)


FIELDS = {"parle": ("x", "e", "c"), "entropy_sgd": ("x",),
          "elastic_sgd": ("x", "v", "ref"), "sgd": ("params", "v")}


def run_case(case: dict, group, cfg_fields: dict, np_params, batches):
    """One case on ``group``'s rows: ``case`` names the algo, n, L,
    sync_compress, sync_overlap, use_kernel and the mode ("round" or
    "step"); ``batches``: numpy (R, L, n, B, T) token batches.  Returns
    the per-step losses, the state's fields as numpy (local rows), the
    gathered per-replica losses of step mode, and the group's collective
    counts after each round (or step)."""
    from repro_torch.configs import ParleConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import registry
    from repro_torch.core.parle import dealias_state
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import build_model

    model = build_model(ModelConfig(**cfg_fields))
    algo = registry.get(case["algo"])
    pcfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=case["n"], L=case["L"], lr=0.05, lr_inner=0.05,
        batches_per_epoch=1, sync_compress=case.get("compress", "none"),
        sync_overlap=case.get("overlap", False)))
    mesh = None if group.trivial else group
    state = dealias_state(algo.init(params_from_numpy(np_params, "cpu"),
                                    pcfg, mesh))
    rows = group.rows
    take = lambda b: {"tokens": torch.from_numpy(np.ascontiguousarray(b)),
                      "labels": torch.from_numpy(np.ascontiguousarray(b))}
    losses, per_replica, counts = [], [], []
    if case.get("mode", "round") == "round":
        fn = algo.make_round_fn(model.loss, pcfg, mesh=mesh,
                                use_kernel=case.get("use_kernel", False))
        for b in batches:
            state, m = fn(state, take(b[:, rows]))
            losses.append(m["losses"].numpy())
            counts.append(group.counts())
        flush = algo.make_round_flush_fn(pcfg)
        if flush is not None:
            state = flush(state)
    else:
        kw = dict(use_kernel=case.get("use_kernel", False))
        fn = (algo.make_step(model.loss, pcfg, **kw) if mesh is None
              else algo.make_sharded_step(model.loss, pcfg, mesh, **kw))
        for b in batches.reshape((-1,) + batches.shape[2:]):
            state, m = fn(state, take(b[rows]))
            losses.append(m["loss"].reshape(1).numpy())
            per_replica.append(m["loss_per_replica"].numpy())
            counts.append(group.counts())
    fields = {f: getattr(state, f).numpy().copy()
              for f in FIELDS[case["algo"]] if getattr(state, f) is not None}
    return {"losses": np.concatenate(losses), "fields": fields,
            "per_replica": per_replica, "counts": counts}


def run_cases(rank, world, cases, cfg_fields, np_params, batches_by_n):
    """The rank side of a pod: every case on this rank's rows."""
    from repro_torch.sharding.partition import ReplicaGroup
    return [run_case(c, ReplicaGroup(c["n"], rank, world), cfg_fields,
                     np_params, batches_by_n[c["n"]]) for c in cases]


def gather_orders(rank, world):
    """``all_gather_rows`` of f32, bf16 and int8 rows in one collective,
    and ``mean_rows`` / ``replica_means``: values that name their rank and
    row, so the test can read the order back."""
    from repro_torch.sharding.partition import ReplicaGroup
    group = ReplicaGroup(2 * world, rank, world)
    base = torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32)
    f32 = base[:, None] * 10 + torch.arange(3.0)
    b16 = f32.to(torch.bfloat16)
    i8 = f32.to(torch.int8)
    g = group.all_gather_rows(f32, b16, i8)
    mean = group.mean_rows(f32)
    means = group.replica_means(f32)
    return {"gathered": [t.float().numpy() for t in g],
            "mean": mean.numpy(), "means": means.numpy(),
            "counts": group.counts(), "rows": (group.rows.start,
                                               group.rows.stop)}


def train_cli(argv):
    """One run of the train CLI's ``run()`` (smoke width, on the CPU) in
    this process, under the ``--mesh`` of ``argv``: each round's per-step
    losses (without ``--round-fused``: the progress records'), the eval
    loss, the final state's fields as numpy (this rank's rows; ``c``,
    ``ref`` and SGD's whole on every rank) and the rank's collective
    counts (summed, and by axis)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import train
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import (collective_counts,
                                                collective_counts_by_axis)
    args = train.parse_args(argv)
    obs = Obs()
    losses = []
    state, history, eval_loss = train.run(
        args, smoke_variant(get_config(args.arch)), torch.device("cpu"),
        obs, on_round=lambda r, gstep, m: losses.append(
            m["losses"].detach().clone()))
    if not losses:          # the step loop: its progress records' losses
        losses = [torch.tensor([h["loss"] for h in history])]
    fields = {f: getattr(state, f).numpy().copy()
              for f in ("x", "e", "c", "v", "ref", "params")
              if isinstance(getattr(state, f, None), torch.Tensor)}
    return {"losses": torch.cat(losses).numpy(), "eval_loss": eval_loss,
            "fields": fields, "counts": collective_counts(obs.registry),
            "by_axis": collective_counts_by_axis(obs.registry)}


def train_cli_jobs(rank, world, jobs):
    """The rank side of a pod of train CLI runs: {name: train_cli(argv)}
    in the order of ``jobs`` ({name: argv})."""
    return {name: train_cli(argv) for name, argv in jobs.items()}


# ------------------------------------------------------------------
# axes inside a replica (tests/test_torch_fsdp_tp.py)
# ------------------------------------------------------------------

def family_batches(cfg, stream, step: int, n: int, rows=slice(None)):
    """:func:`~repro_torch.data.synthetic.replica_batches` of ``stream``
    with the conditioning the vlm and audio families read (which the
    token stream does not draw): each replica's ``patch_embeds`` /
    ``cond`` drawn with numpy from ``step``, the same on every rank."""
    from repro_torch.data.synthetic import replica_batches
    batch = replica_batches(stream, step, stream.batch_size, n, rows=rows)
    for name, draw in conditioning(cfg, step, n, stream.batch_size).items():
        batch[name] = torch.from_numpy(np.ascontiguousarray(draw[rows]))
    return batch


def conditioning(cfg, step: int, n: int, batch_size: int) -> dict:
    """{key: (n, batch_size, length, d) float32} of the conditioning the
    vlm (``patch_embeds``) and audio (``cond``) families read at
    ``step``, drawn with numpy (either package's config); {} for the
    other families."""
    extra = {"vlm": ("patch_embeds", cfg.num_patches),
             "audio": ("cond", cfg.cond_len)}.get(cfg.family)
    if extra is None:
        return {}
    name, length = extra
    return {name: np.random.default_rng(1000 + step).standard_normal(
        (n, batch_size, length, cfg.d_model)).astype(np.float32)}


def run_mesh_case(case: dict, group, cfg_fields: dict, np_params,
                  stream_kw: dict):
    """One case of the composed mesh on ``group`` (a ``MeshGroups``, or
    None: all n replicas in this process): ``case`` names the algo, n, L,
    steps, mode ("step" or "round"), sync_compress, sync_overlap and
    use_kernel; the batches are the token stream of ``stream_kw``.
    Returns the per-step losses, each step's (or round's) collective
    counts by axis, the final state's model rows gathered into full
    FlatLayout rows (x of each local replica; SGD's params), the
    deployable tree as numpy, the layout's sizes, the local block of
    ``blocks/attn/wq`` in the initial x (None without one), the
    elements of the rank's compute row beside the whole row's, and
    (Parle) the eval loss of the deployable (``parle.evaluate``, split as
    training is).  Every family runs (:func:`family_batches`; steps
    only for vlm and audio)."""
    from repro_torch.configs import ParleConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import registry
    from repro_torch.core import parle
    from repro_torch.core.parle import dealias_state
    from repro_torch.data.synthetic import TokenStream, make_round_batch_fn
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import build_model
    from repro_torch.sharding.partition import (collective_counts_by_axis,
                                                in_replica)
    from repro_torch.utils.pytree import tree_leaves_with_paths

    cfg = ModelConfig(**cfg_fields)
    model = build_model(cfg)
    algo = registry.get(case["algo"])
    pcfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=case["n"], L=case["L"], lr=0.1, lr_inner=0.1,
        batches_per_epoch=5, sync_compress=case.get("compress", "none"),
        sync_overlap=case.get("overlap", False)))
    state = dealias_state(algo.init(params_from_numpy(np_params, "cpu"),
                                    pcfg, group))
    lay = state.layout
    model_field = "params" if case["algo"] == "sgd" else "x"
    first = getattr(state, model_field)
    wq = [i for i, p in enumerate(lay.paths)
          if p == ("blocks", "attn", "wq")]
    wq_block = lay.views(first)[wq[0]].numpy().copy() if wq else None
    stream = TokenStream(**{**stream_kw, "vocab_size": cfg.vocab_size,
                            "num_codebooks": cfg.num_codebooks
                            if cfg.family == "audio" else 0})
    rows = group.rows if group is not None else slice(None)
    n, L, kw = case["n"], case["L"], dict(use_kernel=case.get("use_kernel",
                                                                False))
    losses, counts = [], []
    if case.get("mode", "round") == "round":
        fn = algo.make_round_fn(model.loss, pcfg, mesh=group, **kw)
        stage = make_round_batch_fn(stream, L, stream.batch_size, n,
                                    rows=rows)
        for r in range(case["steps"] // L):
            state, m = fn(state, stage(r * L))
            losses.append(m["losses"].numpy())
            counts.append(collective_counts_by_axis(group.obs.registry)
                          if group is not None else {})
        flush = algo.make_round_flush_fn(pcfg)
        if flush is not None:
            state = flush(state)
    else:
        fn = (algo.make_step(model.loss, pcfg, **kw) if group is None
              else algo.make_sharded_step(model.loss, pcfg, group, **kw))
        for i in range(case["steps"]):
            state, m = fn(state, family_batches(cfg, stream, i, n, rows))
            losses.append(m["loss"].reshape(1).numpy())
            counts.append(collective_counts_by_axis(group.obs.registry)
                          if group is not None else {})
    rows_t = getattr(state, model_field)
    rows_t = rows_t if rows_t.dim() == 2 else rows_t[None]
    mesh = in_replica(group)
    full = []
    for r in rows_t:
        if mesh is None:
            full.append(r.numpy().copy())
        else:
            f = r.new_zeros(lay.full.numel)
            full.append(mesh.gather_blocks(r, f, lay).numpy().copy())
    deploy = {"/".join(p): t.numpy().copy() for p, t in
              tree_leaves_with_paths(algo.deployable(state, group))}
    eval_loss = None
    if case["algo"] == "parle":
        held = {k: v[0] for k, v in
                family_batches(cfg, stream, 10_000_019, 1).items()}
        eval_loss = float(parle.evaluate(
            model.loss, algo.deployable_row(state, group), lay, group,
            held))
    # the rank's compute row under the Megatron split: its elements, and
    # those of the whole row
    column = (mesh.column_layout(lay, model.cfg).data_numel
              if mesh is not None else None)
    return {"losses": np.concatenate(losses), "counts": counts,
            "full_rows": np.stack(full), "deploy": deploy,
            "numel": lay.numel, "wq_block": wq_block, "column": column,
            "row": sum(lay.full.sizes) if mesh is not None else None,
            "eval_loss": eval_loss}


def fsdp_tp_cases(rank, world, cases, models, stream_kw):
    """The rank side of the composed-mesh world: every case on a
    ``MeshGroups`` of its spec (each with a registry of its own), on the
    model its ``"model"`` key names in ``models`` ({name: (cfg fields,
    numpy params)}; default "dense")."""
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import MeshGroups
    out = []
    for c in cases:
        group = MeshGroups(parse_mesh_spec(c["mesh"]), c["n"], rank,
                           obs=Obs())
        res = run_mesh_case(c, group, *models[c.get("model", "dense")],
                            stream_kw)
        res["coords"] = group.coords
        out.append(res)
    return out


# ------------------------------------------------------------------
# checkpoints under a composed mesh (tests/test_torch_checkpoint_mesh.py)
# ------------------------------------------------------------------

def _numpy_tree(tree) -> dict:
    from repro_torch.utils.pytree import tree_leaves_with_paths
    return {"/".join(p): t.detach().numpy().copy()
            for p, t in tree_leaves_with_paths(tree)}


def checkpoint_contract(rank, world, argv, restore_mesh):
    """The reference's sharded-checkpoint contract on this rank: the
    train CLI's ``run()`` under ``argv``'s mesh, checkpointing at its last
    step; that file restored under ``restore_mesh`` (a ``MeshGroups`` of
    the same world); the deployable of both states, one more step's loss
    after the restore, whether a wrong ``algo`` stamp raised
    ValueError, and the rank's checkpoint gathers by axis."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import registry
    from repro_torch.core.parle import dealias_state
    from repro_torch.data.synthetic import TokenStream, replica_batches
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import collective_counts_by_axis

    args = train.parse_args(argv)
    cfg = smoke_variant(get_config(args.arch))
    obs = Obs()
    state, _, _ = train.run(args, cfg, torch.device("cpu"), obs)
    algo = registry.get(args.algo)
    pcfg = train.parle_config(args, algo)
    n = pcfg.n_replicas
    saved = _numpy_tree(algo.deployable(
        state, mesh_mod.groups_from_spec(args.mesh, n, Obs())))
    path = ckpt.resolve(args.checkpoint_dir)
    group = mesh_mod.groups_from_spec(restore_mesh, n, Obs())
    model = build_model(cfg)
    like = algo.init(model.init(torch.Generator().manual_seed(1)), pcfg,
                     group)
    pspecs = algo.state_pspecs(group.axis, pcfg)
    refused = False
    try:
        ckpt.restore(path, like, algo="elastic_sgd", group=group,
                     pspecs=pspecs)
    except ValueError:
        refused = True
    restored = dealias_state(ckpt.restore(path, like, algo=args.algo,
                                          group=group, pspecs=pspecs))
    deploy = _numpy_tree(algo.deployable(restored, group))
    step = algo.make_sharded_step(model.loss, pcfg, group)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed)
    _, m = step(restored, replica_batches(stream, ckpt.latest_step(path),
                                          args.batch, n, rows=group.rows))
    by_axis = collective_counts_by_axis(obs.registry)
    return {"saved": saved, "deploy": deploy, "loss": float(m["loss"]),
            "refused": refused, "coords": group.coords,
            "gathers": {a: ops["gather"] for a, ops in by_axis.items()
                        if "gather" in ops}}


# ------------------------------------------------------------------
# the dry run's collectives and the expert-parallel MoE
# (tests/test_torch_dryrun.py, tests/test_torch_moe_dispatch.py)
# ------------------------------------------------------------------

def dry_run_counters(rank, world, spec, cfg_fields, batch, remat):
    """The dry run's two train programs for real on this rank of the
    mesh ``spec``: one ``train_inner``, then one ``parle_sync``
    (``steps.make_parle_steps`` on the rank's ``MeshGroups``, f32, smoke
    params from seed 0); the rank's collective counters by axis after
    each, and the FLOPs of its ``train_inner``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ParleConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import parle
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.sharding.partition import collective_counts_by_axis

    cfg = ModelConfig(**cfg_fields)
    n = mesh_lib.replica_axis(spec)[1]
    group = mesh_lib.groups_from_spec(spec, n)
    pcfg = ParleConfig(n_replicas=n, lr=0.1, lr_inner=0.1)
    inner, sync, _ = steps.make_parle_steps(cfg, pcfg, weight_decay=5e-4,
                                            remat=remat, mesh=group)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    state = parle.dealias_state(parle.init(params, pcfg, group))
    with FlopCounterMode(display=False) as fc:
        state, _ = inner(state, {k: torch.from_numpy(v[group.rows])
                                 for k, v in batch.items()})
    counts = [collective_counts_by_axis(group.obs.registry)]
    sync(state)
    counts.append(collective_counts_by_axis(group.obs.registry))
    return {"counts": counts, "flops": fc.get_total_flops()}


def moe_columns(rank, world, layer, cfg, x, w):
    """One rank of a "model" pair: its column of the expert-parallel MoE
    dispatch summed over the pair (``MeshGroups.reduce_from_model``), the
    grads of ``sum(y * w) + aux`` through the sum (x's, and each of the
    layer's leaves the rank's column of them), and its counters by
    axis."""
    from repro_torch.models import megatron, moe
    from repro_torch.sharding.partition import (MeshGroups,
                                                collective_counts_by_axis)
    mesh = MeshGroups({"replica": 1, "model": world}, 1, rank)
    tp = megatron.TensorParallel(world, rank, mesh)
    params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in layer.items()}
    with megatron.tensor_parallel(tp):
        y, _ = moe.moe_forward(params, cfg, torch.from_numpy(x))
        xg = torch.from_numpy(x).requires_grad_(True)
        pg = {k: ({kk: vv.clone().requires_grad_(True)
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else v.clone().requires_grad_(True))
              for k, v in params.items()}
        yg, aux = moe.moe_forward(pg, cfg, xg)
    (torch.sum(yg * torch.from_numpy(w)) + aux).backward()
    grads = {k: ({kk: vv.grad.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.grad.numpy())
             for k, v in pg.items()}
    return {"y": y.numpy(), "gx": xg.grad.numpy(), "grads": grads,
            "counts": collective_counts_by_axis(mesh.obs.registry)}


# ------------------------------------------------------------------
# the Megatron split and the MoE on a "data" axis
# (tests/test_torch_megatron.py)
# ------------------------------------------------------------------

def moe_grads(rank, spec, cfg_fields, np_params, batch_np):
    """One replica of the moe ``cfg_fields`` model on the mesh ``spec``
    (every replica the same params and batch ``batch_np``): the loss and
    the shard grads from ``core/parle.py::ShardGrads`` (the grads
    gathered back into whole leaves), the aux loss of the rank's own
    forward under the same context (the data ranks' mean of it), and the
    rank's counters by axis."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.parle import ShardGrads, split_context
    from repro_torch.launch.mesh import parse_mesh_spec, replica_axis
    from repro_torch.models import megatron
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import build_model
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import (MeshGroups,
                                                collective_counts_by_axis)
    cfg = ModelConfig(**cfg_fields)
    model = build_model(cfg)
    mesh = MeshGroups(parse_mesh_spec(spec), replica_axis(spec)[1], rank,
                      obs=Obs())
    lay = mesh.layout(params_from_numpy(np_params, "cpu"))
    rows = lay.flatten(params_from_numpy(np_params, "cpu"))[None].clone()
    batch = {k: torch.from_numpy(v)[None] for k, v in batch_np.items()}
    out = torch.zeros_like(rows)
    shard = ShardGrads(mesh)
    loss = shard(model.loss, lay, rows, batch, out)
    counts = collective_counts_by_axis(mesh.obs.registry)
    full = torch.zeros(lay.full.numel)
    mesh.gather_blocks(out[0], full, lay)
    grads = {"/".join(p): g.numpy().copy()
             for p, g in zip(lay.full.paths, lay.full.views(full))}
    sel = mesh.data_rows(batch_np["tokens"].shape[0])
    tp = split_context(mesh, cfg, sel != slice(None))
    if tp.columns > 1:
        clay = shard.column_layout(lay, cfg)
        crow = mesh.gather_columns(rows[0], torch.zeros(clay.flat.numel),
                                   clay)
        params = clay.flat.tree(crow)
    else:
        params = lay.full.tree(mesh.gather_blocks(rows[0], full, lay))
    with torch.no_grad(), megatron.tensor_parallel(tp):
        _, info = model.loss(params, {k: v[0, sel]
                                      for k, v in batch.items()})
    aux = mesh.data_mean_(info["aux"].reshape(1), sel != slice(None))
    return {"loss": float(loss[0]), "aux": float(aux[0]), "grads": grads,
            "counts": counts, "coords": mesh.coords}


def vocab_parallel_ce(rank, M, mesh, seed):
    """The vocab-parallel CE (an untied head) and ``lm_cross_entropy`` of
    a tied head on this rank's "model" column of ``mesh``, against
    ``chunked_cross_entropy`` of the whole head in this process: values,
    grads of h and of the rank's column of the head (a tied head's
    whole), the bytes autograd saved for the backward, and the "model"
    collectives of each."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers, megatron
    from repro_torch.models.model import lm_cross_entropy
    from repro_torch.sharding.partition import collective_counts_by_axis
    B, T, d, V, chunk = 2, 32, 32, 64, 8
    rng = np.random.default_rng(seed)
    h0 = torch.from_numpy(rng.standard_normal((B, T, d), np.float32))
    w0 = torch.from_numpy(rng.standard_normal((d, V), np.float32) * 0.3)
    labels = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int32))
    tp = megatron.TensorParallel(M, mesh.model_index, mesh)
    tied = ModelConfig(name="t-tied", family="dense", num_layers=1,
                       d_model=d, num_heads=1, num_kv_heads=1, d_ff=d,
                       vocab_size=V, tie_embeddings=True)
    out = {}
    for kind in ("vocab", "tied"):
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        # the tied head at lm_cross_entropy's own chunk
        kw = dict(chunk=chunk) if kind == "vocab" else {}
        want = layers.chunked_cross_entropy(h, w, labels, **kw)
        want_g = torch.autograd.grad(want, (h, w))
        before = collective_counts_by_axis(mesh.obs.registry)
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if kind == "vocab":
                col = tp.cols(w, V, -1)
                got = layers.vocab_parallel_cross_entropy(
                    h, col, labels, tp, V, chunk=chunk)
            else:                         # the embedding (V, d) = w.T
                with megatron.tensor_parallel(tp):
                    got = lm_cross_entropy({"embed": w.T}, tied, h, labels)
        got_g = torch.autograd.grad(got, (h, w))
        lo, hi = tp.part(V) if kind == "vocab" else (0, V)
        sl = (slice(None), slice(lo, hi))
        after = collective_counts_by_axis(mesh.obs.registry)
        out[kind] = {
            "value": (float(got), float(want)),
            "gh": (got_g[0].numpy(), want_g[0].numpy()),
            "gw": (got_g[1][sl].numpy(), want_g[1][sl].numpy()),
            "saved": sum(seen.values()),
            "model": {op: (c - before.get("model", {}).get(op, (0, 0))[0],
                           b - before.get("model", {}).get(op, (0, 0))[1])
                      for op, (c, b) in after.get("model", {}).items()}}
    return out


def megatron_world(rank, world, moe_cases, mesh_cases, models, stream_kw):
    """The rank side of tests/test_torch_megatron.py's world: each moe
    case ({name: (spec, cfg fields, numpy params, numpy batch)}) through
    :func:`moe_grads`, the vocab-parallel CE on "model" pairs, and each
    of ``mesh_cases`` ({name: a :func:`run_mesh_case` case on the model
    its ``"model"`` key names in ``models``}) on a ``MeshGroups`` of its
    spec."""
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import MeshGroups
    out = {name: moe_grads(rank, *args) for name, args in moe_cases.items()}
    mesh = MeshGroups(parse_mesh_spec("replica:1,data:2,model:2"), 1, rank,
                      obs=Obs())
    out["ce"] = vocab_parallel_ce(rank, 2, mesh, seed=3)
    for name, case in mesh_cases.items():
        group = MeshGroups(parse_mesh_spec(case["mesh"]), case["n"], rank,
                           obs=Obs())
        out[name] = run_mesh_case(case, group, *models[case["model"]],
                                  stream_kw)
        out[name]["coords"] = group.coords
    return out
