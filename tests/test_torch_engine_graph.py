"""The serving engine's decode chunk as one CUDA graph.

On CUDA the engine captures ``decode_chunk`` decodes with sampling into
one graph per engine and replays it every step; on the CPU the same
chunk runs eagerly over the same buffers.  Checked here on the CPU, for
the six families and the three layouts (dense, paged gather, paged
decode attention — its plain version here): the chunk does nothing a
capture refuses (no host read of a device value, no shape that depends
on the data), every buffer it touches keeps its address across
admission, steps, eviction and refill, and nothing is compiled.  On the
card (``gpu``): captured tokens equal eager ones, greedy and sampled.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import hybrid
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, SamplingParams
from repro_torch.serving.cache import _leaves
from torch_parity import NoHostSync, family_requests
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"dense": dict(paged=False),
           "paged": dict(paged=True, page_size=16, prefill_chunk=8),
           "paged_kernel": dict(paged=True, page_size=16, prefill_chunk=8,
                                use_paged_kernel=True)}
FAMILIES = sorted(FAMILY_CONFIGS)
LENS = (5, 9, 12)
MAX_LEN = 32
BUCKETS = (8, 16)          # the dense engine's prompt buckets of LENS


def _cfg(family):
    return ModelConfig(**dataclasses.asdict(FAMILY_CONFIGS[family]))


@pytest.fixture(scope="module")
def family_params():
    cache = {}

    def get(family, device="cpu"):
        if (family, device) not in cache:
            cfg = _cfg(family)
            gen = torch.Generator(device=device).manual_seed(0)
            cache[family, device] = cfg, build_model(cfg).init(gen)
        return cache[family, device]
    return get


def _engine(cfg, params, layout, device="cpu", **kw):
    return Engine(cfg, params, num_slots=2, max_len=MAX_LEN, decode_chunk=3,
                  device=device, **LAYOUTS[layout], **kw)


def _submit(eng, cfg, gens):
    for req, gen in zip(family_requests(cfg, LENS), gens):
        eng.submit(req["tokens"], max_new_tokens=gen, cond=req.get("cond"),
                   patch_embeds=req.get("patch_embeds"))


def _addresses(eng):
    """The data pointer of every buffer the decode chunk touches."""
    out = {f"cache.{name}.{i}": leaf.data_ptr()
           for i, (name, leaf) in enumerate(_leaves(eng.cache))}
    out.update(cur_tok=eng.cur_tok.data_ptr(),
               active=eng._active.data_ptr(), toks=eng._toks.data_ptr())
    return out


def _step_until_decoding(eng):
    """Engine steps until a decode chunk has run (paged prefill takes a
    step of its own per chunk)."""
    while eng.stats["chunks"] == 0:
        eng.step()


@pytest.mark.parametrize("case", ["item", "nonzero", "unique",
                                  "bool_index", "to_cpu"])
def test_no_host_sync_mode_refuses(case):
    """The mode below catches what a capture would refuse."""
    x = torch.rand(4, 6)
    fns = {"item": lambda: x.sum().item(),
           "nonzero": lambda: torch.nonzero(x > 0.5),
           "unique": lambda: torch.unique(x),
           "bool_index": lambda: x[x > 0.5],
           "to_cpu": lambda: x.to(device="cpu", dtype=torch.float64)}
    with pytest.raises(AssertionError), NoHostSync():
        fns[case]()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_decode_chunk_needs_no_host_sync(family, layout, family_params):
    """(a) One decode chunk, the call a CUDA graph captures, greedy and
    sampled, runs under a dispatch mode that refuses every op a capture
    cannot take."""
    cfg, params = family_params(family)
    for sampling in (SamplingParams(), SamplingParams(0.8, 50)):
        eng = _engine(cfg, params, layout, sampling=sampling)
        _submit(eng, cfg, (8, 8, 8))
        _step_until_decoding(eng)
        program = eng._decode_program()
        with NoHostSync():
            program()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_decode_buffers_keep_their_addresses(family, layout, family_params):
    """(b) After admission and the first decode step, every cache leaf
    (pos fields included), ``cur_tok``, the ``active`` mask and the
    chunk's token buffer keep their addresses through more steps, an
    eviction (request 0 ends in its first chunk) and the refill of its
    slot (request 2 waits for it)."""
    cfg, params = family_params(family)
    eng = _engine(cfg, params, layout)
    _submit(eng, cfg, (3, 8, 6))
    _step_until_decoding(eng)
    want = _addresses(eng)
    steps = 0
    while eng.sched.has_work():
        eng.step()
        steps += 1
        assert _addresses(eng) == want, f"after step {steps}"
    assert steps >= 2
    counters = eng.throughput()["counters"]
    assert counters["admitted"] == counters["finished"] == 3
    res = eng.sched.results()
    assert [np.asarray(res[uid]).shape[-1] for uid in sorted(res)] == [3, 8, 6]


@pytest.mark.parametrize("family", FAMILIES)
def test_cpu_engine_compiles_nothing(family, family_params):
    """(c) On the CPU the chunk runs eagerly: no capture, no warm-up,
    ``compile_s`` 0.0 and ``serve.compiles`` 0."""
    cfg, params = family_params(family)
    eng = _engine(cfg, params, "paged")
    assert not eng.graphs
    _submit(eng, cfg, (4, 4, 4))
    eng.run()
    assert eng._decode_program() == eng._run_eager
    assert eng.stats["chunks"] > 0 and eng.stats["warmup_steps"] == 0
    assert eng.throughput()["compile_s"] == 0.0
    assert eng.obs.counter("serve.compiles").total == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU has no CUDA graphs")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_captured_chunk_matches_eager_on_card(family, family_params,
                                              cuda_device):
    """(d) In every layout, greedy and at temperature 0.8 / top-k 50 from
    one seed, the captured engine's tokens equal the eager engine's; one
    decode capture per engine; the paged-attention kernel's launches count the
    replays (sites x (decode steps + the warm-up's steps)); the prefills
    captured too: one graph a prompt bucket (dense) or one chunk graph
    (paged)."""
    cfg, params = family_params(family, cuda_device)
    sites = (hybrid.num_attn_sites(cfg) if cfg.family == "hybrid"
             else cfg.num_layers)
    for layout in LAYOUTS:
        for sampling in (SamplingParams(), SamplingParams(0.8, 50)):
            out = {}
            for graphs in (True, False):
                eng = _engine(cfg, params, layout, device=cuda_device,
                              sampling=sampling, seed=3, graphs=graphs)
                _submit(eng, cfg, (3, 8, 6))
                before = pa.launches
                out[graphs] = eng.run()
                k8 = pa.launches - before
                steps = eng.stats["decode_steps"] + eng.stats["warmup_steps"]
                kernel = layout == "paged_kernel" and family != "ssm"
                assert k8 == (sites * steps if kernel else 0)
                # one decode graph, and one prefill graph a prompt bucket
                # (dense) or one prefill-chunk graph (paged)
                programs = 1 + (len(BUCKETS) if layout == "dense" else 1)
                assert eng.obs.counter("serve.compiles").total == (
                    programs if graphs else 0)
                assert (eng.stats["compile_s"] > 0) == graphs
            for uid, toks in out[False].items():
                np.testing.assert_array_equal(
                    out[True][uid], toks,
                    err_msg=f"{layout} {sampling} request {uid}")
