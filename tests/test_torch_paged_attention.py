"""K8, paged decode attention: the port's plain version against the JAX
reference oracle and the Pallas kernel (interpret mode on this CPU), the
shared-pages contract, the CPU dispatch of ``ops.paged_attention``, and —
on a card only — the CUDA kernel against its plain version."""
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["reference_test", "length_1", "serve_path"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    shapes = {"reference_test": {},
              "length_1": dict(B=1),
              "serve_path": dict(B=3, P=33, H=16, KV=2, hd=128, M=8)}[case]
    args = _torch(*_inputs(**shapes), device=cuda_device)
    before = pa.launches
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize(cuda_device)
    assert pa.launches == before + 1
    assert_close(got, pa.paged_attention_plain(*args).cpu().numpy(),
                 KERNEL_TOL, case)
