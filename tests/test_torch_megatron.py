"""The Megatron split of a replica over "model" and the MoE on a "data"
axis (``models/megatron.py``, ``models/moe.py::moe_forward_split``,
``core/parle.py::ShardGrads``, the collectives of
``sharding/partition.py::MeshGroups``).

One world of four gloo ranks is spawned (``torch_ranks.spawn``) once for
the module and runs:

  * a small moe model (2 layers, 4 experts top-2 with a shared expert,
    QKV bias; batch 4 x 16) under ``replica:2,data:2`` and
    ``replica:1,data:2,model:2``, through ``ShardGrads``: the loss, the
    aux loss and every leaf's grad against the reference's flat dispatch
    on the global batch in one process (``jax.value_and_grad`` of its
    loss), at a drop-free capacity and at one where tokens drop (where a
    dispatch of each rank's own rows would give another loss);
  * the vocab-parallel CE (an untied head) and a tied head (read whole
    on every rank) on "model" pairs against ``chunked_cross_entropy`` in
    one process: values and grads, one chunk's logits held for the
    backward, and the collectives of each chunk and of its recompute
    counted;
  * the reference's ``t-dense`` under ``replica:2,model:2`` (as in
    ``tests/test_torch_fsdp_tp.py``): losses and the deployable against
    one process and the reference's local path, no leaf gathered over
    "model", a rank's compute row about half the row;
  * a small model of each other family (ssm, hybrid, vlm, audio) under
    ``replica:2,model:2``, and the ssm one under
    ``replica:1,data:2,model:2``: the losses against one process and the
    reference's local path, the eval loss and the deployable against one
    process, "model" gathering only activations
    (the embedding's columns; the Mamba2 mixer's packed projection and
    conv outputs), a rank's compute row about half the row.

Without ranks: the mean of each data half's own dispatch is not the
batch's at the dropping capacity, and every architecture is split (its
leaves held in columns or whole, none gathered over "model").  On M
"model" columns simulated by threads of one process
(``torch_ranks.ThreadColumns``): the split gated RMSNorm's forward and
backward, the packed projection's backward against the unsplit block in
float64, the per-codebook vocab-parallel CE against
``chunked_cross_entropy``, and each family's loss and grads split
against unsplit.

Tolerances are the reference's composed-mesh bounds: rtol 2e-5 on losses,
rtol 2e-5 / atol 2e-6 on the deployable and the grads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import ARCHS
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from torch_parity import (family_batch, numpy_params,  # noqa: F401
                          one_torch_thread, port_config, ssm_init_draws)

TOL = dict(rtol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-6)

RCFG = RefModelConfig(name="t-moe", family="moe", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256,
                      head_dim=16, qkv_bias=True, num_experts=4, top_k=2,
                      expert_d_ff=32, num_shared_experts=1,
                      shared_expert_d_ff=64)
# capacity factors: 2.0 gives a bucket of all 64 tokens (nothing drops);
# 0.5 a bucket of 16 of the 128 routed slots' 32 an expert on average
CAPACITIES = {"drop_free": 2.0, "drops": 0.5}
MESHES = {"data2": "replica:2,data:2", "data2model2":
          "replica:1,data:2,model:2"}

DENSE = RefModelConfig(name="t-dense", family="dense", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=512, head_dim=32)
STREAM = dict(vocab_size=512, seq_len=16, batch_size=2, seed=0)
DENSE_CASE = dict(algo="parle", n=2, L=3, mesh="replica:2,model:2",
                  steps=7, mode="step", model="dense")
# the other families, small: 2 layers, d 64 (the Mamba2 mixer 8 heads of
# 16 over one 16-state group; 4 / 2 attention heads of 16, ff 128)
_SSM = dict(ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
_ATTN = dict(num_heads=4, num_kv_heads=2, d_ff=128, head_dim=16)
FAMILIES = {
    "ssm": RefModelConfig(name="t-ssm", family="ssm", num_layers=2,
                          d_model=64, num_heads=0, num_kv_heads=0, d_ff=0,
                          vocab_size=512, **_SSM),
    "hybrid": RefModelConfig(name="t-hybrid", family="hybrid",
                             num_layers=2, d_model=64, vocab_size=512,
                             attn_every=1, **_SSM, **_ATTN),
    "vlm": RefModelConfig(name="t-vlm", family="vlm", num_layers=2,
                          d_model=64, vocab_size=512, qkv_bias=True,
                          num_patches=4, **_ATTN),
    "audio": RefModelConfig(name="t-audio", family="audio", num_layers=2,
                            d_model=64, vocab_size=128, num_codebooks=4,
                            cond_len=4, **{**_ATTN, "num_kv_heads": 4}),
}
FAMILY_CASES = {f: dict(algo="parle", n=2, L=2, mesh="replica:2,model:2",
                        steps=4, mode="step", model=f) for f in FAMILIES}
FAMILY_CASES["ssm-data2"] = dict(algo="parle", n=1, L=2,
                                 mesh="replica:1,data:2,model:2", steps=4,
                                 mode="step", model="ssm")


def _rcfg(capacity):
    return dataclasses.replace(RCFG, capacity_factor=CAPACITIES[capacity])


@pytest.fixture(scope="module")
def moe_params():
    return jax.tree.map(np.asarray, numpy_params(RCFG))


@pytest.fixture(scope="module")
def batch():
    return family_batch(RCFG, B=4, T=16, seed=1)


@pytest.fixture(scope="module")
def dense_params():
    return jax.tree.map(np.asarray, numpy_params(DENSE))


@pytest.fixture(scope="module")
def models(dense_params):
    """{model name: (port config fields, numpy params)} of the mesh
    cases."""
    out = {"dense": (dataclasses.asdict(port_config(DENSE)), dense_params)}
    for f, rcfg in FAMILIES.items():
        tree = jax.tree.map(np.asarray, numpy_params(rcfg))
        if f in ("ssm", "hybrid"):
            tree = ssm_init_draws(tree)
        out[f] = (dataclasses.asdict(port_config(rcfg)), tree)
    return out


@pytest.fixture(scope="module")
def world(moe_params, batch, models, tmp_path_factory):
    """Every job on four spawned ranks: [each rank's results]."""
    cases = {f"{m}-{c}": (spec, dataclasses.asdict(port_config(_rcfg(c))),
                          moe_params, batch)
             for m, spec in MESHES.items() for c in CAPACITIES}
    store = str(tmp_path_factory.mktemp("megatron") / "store")
    return torch_ranks.spawn(
        torch_ranks.megatron_world, 4, store, cases,
        {"dense": DENSE_CASE, **FAMILY_CASES}, models, STREAM)


@pytest.fixture(scope="module")
def family_single(models):
    """Each family case in this process, all n replicas."""
    return {k: torch_ranks.run_mesh_case(c, None, *models[c["model"]],
                                         STREAM)
            for k, c in FAMILY_CASES.items()}


@pytest.fixture(scope="module")
def reference(moe_params, batch):
    """{capacity: (loss, aux, grads by path)} of the reference's flat
    dispatch on the global batch, in one process."""
    out = {}
    for c in CAPACITIES:
        (loss, info), grads = jax.value_and_grad(
            ref_build_model(_rcfg(c)).loss, has_aux=True)(
            jax.tree.map(jnp.asarray, moe_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
        out[c] = (float(loss), float(info["aux"]), {
            "/".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)})
    return out


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_on_a_data_axis_is_the_global_flat_dispatch(world, reference,
                                                        mesh, capacity):
    """Every rank's loss and aux (the data ranks' mean of each rank's)
    and the grads gathered from its shard equal the reference's flat
    dispatch on the whole batch, drops included; each step gathers the
    blocks over "data" once and, in each of the 2 layers, the (2, E)
    expert and top-1 counts once."""
    loss, aux, grads = reference[capacity]
    for r in world:
        got = r[f"{mesh}-{capacity}"]
        err = max(np.abs(got["grads"][k] - g).max()
                  for k, g in grads.items())
        print(f"[megatron] {MESHES[mesh]} {capacity}: loss rel err "
              f"{abs(got['loss'] / loss - 1):.3e}, aux rel err "
              f"{abs(got['aux'] / aux - 1):.3e}, grads max abs err "
              f"{err:.3e}")
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        np.testing.assert_allclose(got["aux"], aux, **TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                       **GRAD_TOL)
        data = got["counts"]["data"]
        assert data["all_gather"][0] == 1 + RCFG.num_layers
        assert data["reduce_scatter"][0] == 1


def test_a_dispatch_of_each_ranks_rows_would_differ(moe_params, batch):
    """At the dropping capacity, the mean of the two data halves' own flat
    dispatches (each at its own capacity, with its own aux) is not the
    whole batch's loss: the global dispatch above is what the test
    holds."""
    cfg = port_config(_rcfg("drops"))
    loss = build_model(cfg).loss
    params = params_from_numpy(moe_params, "cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    whole = float(loss(params, t)[0])
    halves = np.mean([float(loss(params, {k: v[h:h + 2]
                                          for k, v in t.items()})[0])
                      for h in (0, 2)])
    print(f"[megatron] per-rank dispatch: {halves:.6f} vs {whole:.6f}")
    assert abs(halves / whole - 1) > 100 * TOL["rtol"]


@pytest.mark.parametrize("kind", ["vocab", "tied"])
def test_split_head_cross_entropy(world, kind):
    """On each "model" pair: the value and the grads of h and of the
    rank's column of the head equal ``chunked_cross_entropy``'s in one
    process.  The vocab-parallel CE: autograd holds one chunk's logits
    (not the four chunks'), and it all-reduces each chunk's max and
    (sum, target) once in the forward and once in the recompute, and h's
    grad once.  A tied head (``lm_cross_entropy`` under the context):
    read whole, no "model" collective, its one chunk's logits held."""
    B, T, d, V, chunk = 2, 32, 32, 64, 8
    for r in world:
        got = r["ce"][kind]
        np.testing.assert_allclose(*got["value"], **TOL)
        np.testing.assert_allclose(*got["gh"], **GRAD_TOL)
        np.testing.assert_allclose(*got["gw"], **GRAD_TOL)
        logits = (B * chunk * V // 2 if kind == "vocab" else B * T * V) * 4
        inputs = (B * T * d + d * V) * 4 + B * T * 4
        assert got["saved"] - inputs < 2 * logits, got["saved"]
        calls = T // chunk * 4 + 1 if kind == "vocab" else 0
        assert got["model"].get("all_reduce", (0, 0))[0] == calls


def test_dense_replica_split_over_model_pairs(world, dense_params):
    """t-dense under replica:2,model:2, 7 steps across two L = 3 syncs:
    the losses within rtol 2e-5 of one process and of the reference's
    local path, the deployable within rtol 2e-5 / atol 2e-6 of one
    process; "model" gathers only the embedding's columns (a step: its 2
    rows x 16 positions x 64 columns) and a rank computes on half the
    row (the norms, 640 elements, whole)."""
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import registry as ref_registry
    from repro.data.synthetic import TokenStream, replica_batches
    one = torch_ranks.run_mesh_case(
        DENSE_CASE, None, dataclasses.asdict(port_config(DENSE)),
        dense_params, STREAM)
    algo = ref_registry.get("parle")
    cfg = algo.canonicalize_cfg(RefParleConfig(
        n_replicas=2, L=3, lr=0.1, lr_inner=0.1, batches_per_epoch=5))
    st = algo.init(jax.tree.map(jnp.asarray, dense_params), cfg)
    step = jax.jit(algo.make_step(ref_build_model(DENSE).loss, cfg))
    stream = TokenStream(**STREAM)
    ref = []
    for i in range(7):
        st, m = step(st, replica_batches(stream, i, 2, 2))
        ref.append(float(m["loss"]))
    for rank in world:
        r = rank["dense"]
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        dep = max(np.abs(r["deploy"][k] - v).max()
                  for k, v in one["deploy"].items())
        print(f"[megatron] dense replica:2,model:2: losses max rel err "
              f"{rel:.3e}, deployable max abs err {dep:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        np.testing.assert_allclose(r["losses"], ref, **TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **GRAD_TOL)
        gathered = [c["model"]["all_gather"][1] for c in r["counts"]]
        assert list(np.diff([0] + gathered)) == [2 * 16 * 64 * 4] * 7
        assert set(r["counts"][-1]) == {"replica", "model"}
        assert r["column"] == (r["row"] - 640) // 2 + 640


def _whole_numel(params) -> int:
    """The elements of the leaves every "model" rank holds whole: the
    norms, biases and the Mamba2 per-head scalars."""
    from repro_torch.sharding.rules import REPLICATED_LEAVES
    return sum(int(np.prod(v.shape)) for p, v in
               jax.tree_util.tree_leaves_with_path(params)
               if p[-1].key in REPLICATED_LEAVES)


def _model_gather_bytes(cfg, rows: int, M: int = 2) -> int:
    """The bytes a rank contributes to its gathers over "model" in a step
    of a family split over M "model" ranks (every KV head count here
    divisible): its columns of the embedding of its ``rows`` token rows,
    and in each Mamba2 layer its block of the packed projection's and of
    the conv's outputs."""
    per_row = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        di, N, nh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_num_heads
        per_row += cfg.num_layers * ((2 * di + 2 * N + nh) + (di + 2 * N))
    return rows * per_row // M * 4


def _reference_losses(case, np_params) -> list:
    """The reference's Parle step (its local path) on ``case``'s batches:
    its token stream's replica batches, with the conditioning the port's
    runs draw (``torch_ranks.conditioning``)."""
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import registry as ref_registry
    from repro.data.synthetic import TokenStream, replica_batches
    rcfg = FAMILIES[case["model"]]
    algo = ref_registry.get(case["algo"])
    cfg = algo.canonicalize_cfg(RefParleConfig(
        n_replicas=case["n"], L=case["L"], lr=0.1, lr_inner=0.1,
        batches_per_epoch=5))
    st = algo.init(jax.tree.map(jnp.asarray, np_params), cfg)
    step = jax.jit(algo.make_step(ref_build_model(rcfg).loss, cfg))
    stream = TokenStream(**{**STREAM, "vocab_size": rcfg.vocab_size,
                            "num_codebooks": rcfg.num_codebooks
                            if rcfg.family == "audio" else 0})
    out = []
    for i in range(case["steps"]):
        b = replica_batches(stream, i, STREAM["batch_size"], case["n"])
        b.update({k: jnp.asarray(v) for k, v in torch_ranks.conditioning(
            rcfg, i, case["n"], STREAM["batch_size"]).items()})
        st, m = step(st, b)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_replica_split_over_model(world, family_single, models,
                                         case):
    """A small ssm, hybrid, vlm and audio model under replica:2,model:2
    (and the ssm one under replica:1,data:2,model:2), 4 steps across two
    L = 2 syncs: each rank's losses within rtol 2e-5 of one process and
    of the reference's local path, its eval loss within rtol 2e-5 of one
    process, its deployable within rtol 2e-5 / atol 2e-6; "model" gathers
    only activations a step (no leaf), and a rank computes on half the
    row (the whole leaves aside)."""
    c = FAMILY_CASES[case]
    cfg = port_config(FAMILIES[c["model"]])
    one = family_single[case]
    ref = _reference_losses(c, models[c["model"]][1])
    D = 2 if "data:2" in c["mesh"] else 1
    rows = STREAM["batch_size"] // D * STREAM["seq_len"]
    whole = _whole_numel(models[c["model"]][1])
    for rank in world:
        r = rank[case]
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        dep = max(np.abs(r["deploy"][k] - v).max()
                  for k, v in one["deploy"].items())
        print(f"[megatron] {case} {c['mesh']}: losses max rel err "
              f"{rel:.3e}, eval rel err "
              f"{abs(r['eval_loss'] / one['eval_loss'] - 1):.3e}, "
              f"deployable max abs err {dep:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        np.testing.assert_allclose(r["losses"], ref, **TOL)
        np.testing.assert_allclose(r["eval_loss"], one["eval_loss"], **TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **GRAD_TOL)
        gathered = [cn["model"]["all_gather"][1] for cn in r["counts"]]
        assert list(np.diff([0] + gathered)) == \
            [_model_gather_bytes(cfg, rows)] * c["steps"]
        assert r["column"] == (r["row"] - whole) // 2 + whole


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_each_family_is_on_one_path(arch):
    """Each architecture's leaves under model:2 (its smoke variant, a dry
    rank): every family is split, each leaf held in its column (the
    heads', ff's, experts', SSD heads' (the planner's blocks of the
    packed ``in_proj`` and the conv), embedding's and head's) or whole
    (norms, biases, the Mamba2 per-head scalars), none gathered over
    "model"."""
    from repro_torch.configs import smoke_variant
    from repro_torch.models import megatron
    from repro_torch.sharding.partition import MeshGroups
    from repro_torch.sharding.planner import meta_params
    cfg = smoke_variant(ARCHS[arch])
    mesh = MeshGroups({"replica": 1, "model": 2}, 1, 0, dry=True)
    lay = mesh.layout(meta_params(build_model(cfg)))
    clay = mesh.column_layout(lay, cfg)
    modes = dict(zip(lay.paths, clay.modes))
    assert megatron.splits_family(cfg)
    assert set(modes.values()) == {"col", "whole"} and not clay.gathered
    paths = [("embed",), ("head",)]
    if cfg.family in ("ssm", "hybrid"):
        paths += [("layers", k) for k in ("in_proj", "conv_w", "out_proj")]
        assert modes[("layers", "ln")] == "whole"
        for k in ("A_log", "D", "dt_bias", "conv_b", "norm"):
            i = lay.paths.index(("layers", k))
            assert modes[("layers", k)] == "whole" and clay.summed[i]
    if cfg.family == "hybrid":
        paths += [("shared_attn", "attn", "wq"), ("shared_attn", "mlp",
                                                  "w_down")]
    if cfg.family not in ("ssm", "hybrid"):
        paths += [("blocks", "attn", "wq"), ("blocks", "attn", "wo")]
        assert modes[("blocks", "ln1")] == "whole"
    for path in paths:
        assert modes[path] == "col", (path, modes[path])


# ------------------------------------------------------------------
# M "model" columns in one process (torch_ranks.ThreadColumns)
# ------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 4])
def test_split_gated_norm(M):
    """The gated RMSNorm over di channels, each of M columns holding di/M
    of them (its sum of squares summed over "model" forward and
    backward): its output columns and the grads of y, z and the norm
    weight (the columns' summed) equal ``rms_norm(y * silu(z), w)``'s."""
    from repro_torch.models.layers import rms_norm, silu
    from repro_torch.models.mamba2 import split_gated_norm
    rng = np.random.default_rng(5)
    B, T, di = 2, 8, 64
    y0, z0 = (torch.from_numpy(rng.standard_normal((B, T, di), np.float32))
              for _ in range(2))
    w0 = torch.from_numpy(1 + 0.1 * rng.standard_normal(di, np.float32))
    up = torch.from_numpy(rng.standard_normal((B, T, di), np.float32))
    y, z, w = (t.clone().requires_grad_() for t in (y0, z0, w0))
    want = rms_norm(y * silu(z), w, 1e-5)
    want_g = torch.autograd.grad((want * up).sum(), (y, z, w))

    def column(tp):
        lo, hi = tp.part(di)
        y, z, w = (t[..., lo:hi].clone().requires_grad_()
                   for t in (y0, z0, w0))
        out = split_gated_norm(tp, y, z, w, 1e-5, di)
        g = torch.autograd.grad((out * up[..., lo:hi]).sum(), (y, z, w))
        return out.detach(), g

    res = torch_ranks.ThreadColumns(M).run(column)
    np.testing.assert_allclose(torch.cat([r[0] for r in res], -1),
                               want.detach(), rtol=1e-6, atol=1e-6)
    for i, name in enumerate(("y", "z", "w")):
        got = torch.cat([r[1][i] for r in res], -1)
        np.testing.assert_allclose(got, want_g[i], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("M", [2, 4])
def test_packed_projection_backward(M):
    """In float64: the Mamba2 mixer's packed projection with each column
    multiplying by its planner block (a contiguous 1/M of the packed
    ``[z | x | B | C | dt]`` columns) and reading its own heads' z, x,
    dt and all of B and C from the gathered output: the grads of the
    input and of the blocks (concatenated) equal the unsplit product's
    under the same reads, and every column's output equals the whole
    product."""
    from repro_torch.models.mamba2 import packed_projection
    rng = np.random.default_rng(6)
    B, T, d, di, N, nh = 2, 4, 16, 32, 8, 8
    P = 2 * di + 2 * N + nh
    u0 = torch.from_numpy(rng.standard_normal((B, T, d)))
    w0 = torch.from_numpy(rng.standard_normal((d, P)))
    up = torch.from_numpy(rng.standard_normal((M, B, T, P)))

    def reads(tp, proj):
        """Column m's use of the projection: its heads' z, x, dt and all
        of B and C, weighted by its own upstream grads."""
        h0, h1 = tp.part(nh)
        c0, c1 = h0 * di // nh, h1 * di // nh
        cols = (list(range(c0, c1)) + list(range(di + c0, di + c1))
                + list(range(2 * di, 2 * di + 2 * N))
                + list(range(2 * di + 2 * N + h0, 2 * di + 2 * N + h1)))
        return (proj[..., cols] * up[tp.column][..., cols]).sum()

    u, w = u0.clone().requires_grad_(), w0.clone().requires_grad_()
    from repro_torch.models.megatron import TensorParallel
    total = sum(reads(TensorParallel(M, m), u @ w) for m in range(M))
    want_u, want_w = torch.autograd.grad(total, (u, w))

    def column(tp):
        lo, hi = tp.part(P)
        u = u0.clone().requires_grad_()
        w = w0[:, lo:hi].clone().requires_grad_()
        proj = packed_projection(tp, u, w)
        g = torch.autograd.grad(reads(tp, proj), (u, w))
        return proj.detach(), g

    res = torch_ranks.ThreadColumns(M).run(column)
    for proj, (gu, _) in res:
        np.testing.assert_allclose(proj, u0 @ w0, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gu, want_u, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(torch.cat([r[1][1] for r in res], -1),
                               want_w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("M", [2, 8])
def test_per_codebook_vocab_parallel_cross_entropy(M):
    """The audio head's K codebook heads side by side, split into M
    contiguous column blocks (M = 2: two whole codebooks a column; M =
    8: half a codebook): the vocab-parallel CE with ``num_streams=K``
    and the grads of h and of the blocks equal ``chunked_cross_entropy(
    ..., num_streams=K)``'s, the mean over the K codebooks."""
    from repro_torch.models import layers
    rng = np.random.default_rng(7)
    B, T, d, V, K, chunk = 2, 16, 32, 64, 4, 8
    h0 = torch.from_numpy(rng.standard_normal((B, T, d), np.float32))
    w0 = torch.from_numpy(rng.standard_normal((d, K * V), np.float32) * 0.3)
    labels = torch.from_numpy(rng.integers(0, V, (B, T, K)).astype(np.int32))
    h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = layers.chunked_cross_entropy(h, w, labels, chunk=chunk,
                                        num_streams=K)
    want_g = torch.autograd.grad(want, (h, w))

    def column(tp):
        lo, hi = tp.part(K * V)
        h = h0.clone().requires_grad_()
        w = w0[:, lo:hi].clone().requires_grad_()
        got = layers.vocab_parallel_cross_entropy(h, w, labels, tp, V,
                                                  chunk=chunk, num_streams=K)
        return float(got.detach()), torch.autograd.grad(got, (h, w))

    res = torch_ranks.ThreadColumns(M).run(column)
    for value, (gh, _) in res:
        np.testing.assert_allclose(value, float(want.detach()), **TOL)
        np.testing.assert_allclose(gh, want_g[0], **GRAD_TOL)
    np.testing.assert_allclose(torch.cat([r[1][1] for r in res], -1),
                               want_g[1], **GRAD_TOL)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b",
                                  "internvl2-1b", "musicgen-large"])
def test_family_split_equals_unsplit(arch, M):
    """Each family's smoke model split over M columns (each holding its
    column of every split leaf, the rest whole, as ``ColumnLayout`` hands
    them), params in float64: every column's loss equals the unsplit
    loss, and the grads (columns concatenated, the partial grads of whole
    leaves read in part summed, every other whole leaf's the same on
    each column) equal the unsplit grads."""
    from repro_torch.configs import smoke_variant
    from repro_torch.models import megatron
    from repro_torch.sharding.partition import MeshGroups
    from repro_torch.utils.pytree import (tree_from_paths,
                                          tree_leaves_with_paths)
    cfg = smoke_variant(ARCHS[arch])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float64)
    paths, leaves = zip(*tree_leaves_with_paths(params))
    b = {k: torch.from_numpy(v)
         for k, v in family_batch(cfg, B=2, T=16, seed=2).items()}
    b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    full = [x.clone().requires_grad_() for x in leaves]
    loss, _ = model.loss(tree_from_paths(zip(paths, full)), b)
    want = torch.autograd.grad(loss, full)
    mesh = MeshGroups({"replica": 1, "model": M}, 1, 0, dry=True)
    clay = mesh.column_layout(mesh.layout(params), cfg)

    def column(tp):
        mine = [(x.narrow(k, tp.column * x.shape[k] // M, x.shape[k] // M)
                 if mode == "col" else x).clone().requires_grad_()
                for x, mode, k in zip(leaves, clay.modes, clay.kdims)]
        with megatron.tensor_parallel(tp):
            got, _ = model.loss(tree_from_paths(zip(paths, mine)), b)
            grads = torch.autograd.grad(got, mine, allow_unused=True)
        return float(got.detach()), [torch.zeros_like(x) if g is None else g
                            for x, g in zip(mine, grads)]

    res = torch_ranks.ThreadColumns(M).run(column)
    for value, _ in res:
        np.testing.assert_allclose(value, float(loss.detach()), rtol=1e-6)
    for i, (mode, summed, k) in enumerate(zip(clay.modes, clay.summed,
                                              clay.kdims)):
        parts = [r[1][i] for r in res]
        if mode == "col":
            got = torch.cat(parts, k)
        elif summed:
            got = sum(parts)
        else:
            for p in parts[1:]:
                np.testing.assert_allclose(p, parts[0], rtol=1e-9,
                                           atol=1e-12)
            got = parts[0]
        np.testing.assert_allclose(got, want[i], err_msg=str(paths[i]),
                                   **GRAD_TOL)
