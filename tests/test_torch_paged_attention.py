"""K8, paged decode attention: the port's plain version against the JAX
reference oracle and the Pallas kernel (interpret mode on this CPU), the
shared-pages contract, the CPU dispatch of ``ops.paged_attention``, a
torch model of the kernel's split-and-combine (flash-decoding) at
lengths on the splits' edges, and — on a card only — the CUDA kernel
against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from torch_parity import KERNEL_TOL, assert_close


def _inputs(seed=0, B=3, P=12, H=4, KV=2, hd=32, ps=16, M=4):
    """The reference kernel test's case: each row a random permutation
    of usable pages, entries past the row's live extent on the trash page
    (id 0), ragged lengths (1, full, one and a half pages short)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k_pool = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    v_pool = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, P))[:M] for _ in range(B)])
    lengths = np.array([1, ps * M, ps * (M - 1) + ps // 2], np.int32)[:B]
    for b in range(B):
        table[b, -(-int(lengths[b]) // ps):] = 0
    return q, k_pool, v_pool, table.astype(np.int32), lengths


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("reference", ["oracle", "pallas_interpret"])
def test_plain_matches_reference(reference):
    arrays = _inputs()
    fn = ref_oracle.paged_attention if reference == "oracle" \
        else ref_ops.paged_attention
    want = fn(*[jnp.asarray(a) for a in arrays])
    got = pa.paged_attention_plain(*_torch(*arrays))
    assert_close(got, want, KERNEL_TOL, reference)


def test_plain_shared_pages_rows_bitwise_equal():
    """Two rows whose tables name the SAME pages (prefix sharing) score
    identically up to their common live extent."""
    H, KV, hd, ps, P = 4, 2, 32, 8, 8
    rng = np.random.default_rng(1)
    q1 = rng.standard_normal((1, H, hd)).astype(np.float32)
    q = np.concatenate([q1, q1])
    k_pool = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    v_pool = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    table = np.array([[3, 5, 1], [3, 5, 2]], np.int32)   # shared prefix
    lengths = np.array([2 * ps, 2 * ps], np.int32)       # live < page 3
    o = pa.paged_attention_plain(*_torch(q, k_pool, v_pool, table, lengths))
    np.testing.assert_array_equal(o[0].numpy(), o[1].numpy())
    want = ref_oracle.paged_attention(*[jnp.asarray(a) for a in
                                        (q, k_pool, v_pool, table, lengths)])
    assert_close(o, want, KERNEL_TOL)


def test_ops_cpu_takes_plain_version_and_launches_nothing():
    before = pa.launches
    args = _torch(*_inputs(seed=2))
    out = ops.paged_attention(*args)
    np.testing.assert_array_equal(out.numpy(),
                                  pa.paged_attention_plain(*args).numpy())
    assert pa.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are refused
    before any build or launch."""
    before = pa.launches
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_attention_cuda(*_torch(*_inputs()))
    assert pa.launches == before


def _edge_inputs(sm_count, seed=9, B=6, P=40, H=4, KV=2, hd=32, ps=4,
                 M=64):
    """Six rows at the edges of K8's splits on a card of ``sm_count``
    SMs: one and two spans of positions, each one short and one over,
    and 1; random pages (any id but the trash page 0)."""
    edge = pa.split_span(B, KV, M, sm_count) * ps
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k_pool, v_pool = rng.standard_normal((2, P, ps, KV, hd)).astype(
        np.float32)
    table = rng.integers(1, P, size=(B, M)).astype(np.int32)
    lengths = np.array([edge, edge - 1, edge + 1, 2 * edge, 2 * edge + 1,
                        1], np.int32)
    return q, k_pool, v_pool, table, lengths


def _split_combine_model(q, k_pool, v_pool, table, lengths, span):
    """K8's arithmetic in torch: split s of row b folds the pages
    [s span, (s + 1) span) of the live extent, one page at a time with an
    online softmax in log2 units; a split past the extent is empty; the
    combine weighs each non-empty split's (m, l, acc) by 2^(m - max m)
    in split order.  Also returns, per row, which splits were empty."""
    B, H, hd = q.shape
    _, ps, KV, _ = k_pool.shape
    M = table.shape[1]
    group = H // KV
    scale = hd ** -0.5 * np.log2(np.e)
    out = torch.empty_like(q)
    empty = []
    for b in range(B):
        length = min(int(lengths[b]), M * ps)
        n_pages = -(-length // ps)
        parts = []
        for first in range(0, M, span):
            if first >= n_pages:
                parts.append(None)
                continue
            m = torch.full((H,), float("-inf"))
            l = torch.zeros(H)
            acc = torch.zeros(H, hd)
            for j in range(first, min(first + span, n_pages)):
                live = min(ps, length - j * ps)
                page = int(table[b, j])
                k = k_pool[page, :live].repeat_interleave(group, dim=1)
                v = v_pool[page, :live].repeat_interleave(group, dim=1)
                s = torch.einsum("hd,phd->hp", q[b], k) * scale
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + torch.einsum("hp,phd->hd", p, v)
                m = m_new
            parts.append((m, l, acc))
        empty.append([part is None for part in parts])
        done = [part for part in parts if part is not None]
        mx = torch.stack([m for m, _, _ in done]).amax(0)
        w = [torch.exp2(m - mx) for m, _, _ in done]
        denom = sum(wi * l for wi, (_, l, _) in zip(w, done))
        num = sum(wi[:, None] * acc for wi, (_, _, acc) in zip(w, done))
        out[b] = num / denom.clamp_min(1e-30)[:, None]
    return out, empty


@pytest.mark.parametrize("sm_count", [12, 132])
def test_split_combine_model_matches_plain_at_split_edges(sm_count):
    """At lengths on, one short of and one past the splits' edges (and a
    length of 1, which leaves every split but the first empty) the
    split-and-combine equals the plain version within 1e-6 and the JAX
    oracle within the kernel tolerance; the empty splits are exactly
    those past ceil(ceil(length / ps) / span), the ones the combine
    kernel skips."""
    arrays = _edge_inputs(sm_count)
    _, k_pool, _, table, lengths = arrays
    _, ps, KV, _ = k_pool.shape
    B, M = table.shape
    span = pa.split_span(B, KV, M, sm_count)
    assert span > 1
    got, empty = _split_combine_model(*_torch(*arrays), span)
    want = pa.paged_attention_plain(*_torch(*arrays))
    assert_close(got, want.numpy(), dict(rtol=1e-6, atol=1e-6), "plain")
    assert_close(got, ref_oracle.paged_attention(
        *[jnp.asarray(a) for a in arrays]), KERNEL_TOL, "oracle")
    for b, flags in enumerate(empty):
        n_live = -(-(-(-int(lengths[b]) // ps)) // span)
        assert flags == [s >= n_live for s in range(-(-M // span))]
    assert sum(empty[-1]) == len(empty[-1]) - 1     # the length-1 row


def test_split_span_fills_the_card_from_shapes_alone():
    """No more splits than pages, nor than the aim of BLOCKS_PER_SM
    blocks an SM; the serve shape gets one page a split, the long-context
    shape 64 splits of 16 pages."""
    assert pa.split_span(B=4, KV=2, M=8, sm_count=132) == 1
    assert pa.split_span(B=4, KV=2, M=1024, sm_count=132) == 16
    for B, KV, M in ((1, 1, 1), (64, 8, 3), (2, 2, 4096), (6, 2, 512)):
        span = pa.split_span(B, KV, M, sm_count=132)
        splits = -(-M // span)
        aim = -(-pa.BLOCKS_PER_SM * 132 // (B * KV))
        assert 1 <= span <= M and splits <= min(M, aim)
        if span > 1:     # a page fewer a split would pass the aim
            assert -(-M // (span - 1)) > min(M, aim)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["reference_test", "length_1", "serve_path",
                                  "split_edges", "length_1_large_M"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    """Within the kernel tolerance of the plain version, one launch in
    ``launches`` (the combine kernel included), and bitwise the same on
    a second launch."""
    shapes = {"reference_test": {},
              "length_1": dict(B=1),
              "serve_path": dict(B=3, P=33, H=16, KV=2, hd=128, M=8),
              "split_edges": dict(H=16, KV=2, hd=128, ps=16, M=512),
              "length_1_large_M": dict(ps=16, M=512)}[case]
    if case in ("split_edges", "length_1_large_M"):
        arrays = list(_edge_inputs(torch.cuda.get_device_properties(
            cuda_device).multi_processor_count, **shapes))
        if case == "length_1_large_M":
            arrays[4][:] = 1
    else:
        arrays = _inputs(**shapes)
    args = _torch(*arrays, device=cuda_device)
    before = pa.launches
    got = pa.paged_attention_cuda(*args)
    again = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize(cuda_device)
    assert pa.launches == before + 2
    assert torch.equal(got, again)
    assert_close(got, pa.paged_attention_plain(*args).cpu().numpy(),
                 KERNEL_TOL, case)
