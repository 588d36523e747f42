"""Every assigned architecture's smoke variant (2 layers, d_model 256,
<= 4 experts: ``configs/base.py::smoke_variant``) through the port
against the JAX reference on the same numpy params and batches — the
contracts of the reference's ``tests/test_arch_smoke.py``: one forward
(shapes, finite), a prefill of 8 tokens and one decode step, and one
Parle n = 2 train step (loss, x, y, the step counter).  The ssm and
hybrid archs take ``A_log`` / ``dt_bias`` from the Mamba2 init
(``torch_parity.ssm_init_draws``).

Tolerance: f32 logits, loss and the one-step state within
rtol = atol = 1e-5 (``TOL``); the largest error measured is printed
(``pytest -s``).

Tier-1 runs the five archs of the moe, hybrid, vlm and audio families;
the dense and ssm archs, whose families other port tests hold to the
reference in tier-1 (test_torch_models.py, test_torch_mamba2.py), ride
the slow lane (``-m slow``), as the reference's own per-arch sweep
does."""
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro_torch.configs import ARCHS
from torch_parity import (check_forward, check_parle_step,
                          check_prefill_decode, family_batch, numpy_params,
                          params_from_numpy, ssm_init_draws)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
TIER1_FAMILIES = ("moe", "hybrid", "vlm", "audio")


def _arch_params():
    return [a if REF_ARCHS[a].family in TIER1_FAMILIES else
            pytest.param(a, marks=pytest.mark.slow)
            for a in sorted(REF_ARCHS)]


def _tree(rcfg):
    tree = numpy_params(rcfg, seed=0)
    return (ssm_init_draws(tree) if rcfg.family in ("ssm", "hybrid")
            else tree)


def test_every_family_is_buildable():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert {c.family for c in ARCHS.values()} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}


@pytest.mark.parametrize("arch", _arch_params())
def test_smoke_forward_and_decode_match_reference(arch):
    import jax
    import jax.numpy as jnp
    rcfg = ref_smoke_variant(REF_ARCHS[arch])
    tree = _tree(rcfg)
    params = (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))
    check_forward(rcfg, params, TOL, family_batch(rcfg))
    check_prefill_decode(rcfg, params, TOL, family_batch(rcfg, T=8),
                         steps=1)


@pytest.mark.parametrize("arch", _arch_params())
def test_smoke_parle_step_matches_reference(arch):
    rcfg = ref_smoke_variant(REF_ARCHS[arch])
    check_parle_step(rcfg, _tree(rcfg), TOL,
                     family_batch(rcfg, lead=(2,), seed=6))
