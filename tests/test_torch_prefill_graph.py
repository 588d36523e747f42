"""The serving engine's prefills as CUDA graphs.

On CUDA the engine captures each prefill program at its first use and
replays it: the dense prefill once per batch signature (prompt bucket
and conditioning shapes) and the paged prefill chunk once per engine;
on the CPU the same programs run eagerly over the same buffers.  Checked
here on the CPU, for the six families, dense and paged, sampled (the
served runs) and greedy (against the reference): (a) every prefill
program runs under a dispatch mode that refuses each op a capture
cannot take, and never draws from the generator, which draws once a
request, after its last chunk; (b) every buffer a program touches keeps
its address across admissions of different requests in one bucket and
across chunks of different slots; (c) one program object, run for
requests of different slots, frontiers (a shared-prefix admission
resumes past 0), valid lengths and extents, gives bit for bit what the
direct call with Python ints gives — an integer baked into the program
would not; (d) the dense engine's greedy tokens over prompts in three
buckets equal the JAX reference engine's.  On the card (``gpu``): (e)
captured prefill and decode equal eager, greedy and sampled, with the
reference's compile counts, and a prefill replay needs no host sync.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.serving import Engine as RefEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, SamplingParams
from repro_torch.serving import cache as cache_lib
from repro_torch.serving.cache import _leaves
from torch_parity import (NoHostSync, assert_same_tokens, both_params,
                          family_requests, run_engine)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = sorted(FAMILY_CONFIGS)
LAYOUTS = {"dense": dict(paged=False),
           "paged": dict(paged=True, page_size=8, prefill_chunk=8)}
MAX_LEN = 32
GEN = 6
# A (20 tokens) and X arrive first; B repeats A's first 17 tokens and
# arrives while A still decodes, so the paged engine of a sharing family
# resumes B's prefill at A's two full pages (frontier 16)
LENS = (20, 9, 18, 12, 5)
ARRIVALS = (0, 0, 3, 3, 3)
SAMPLED = SamplingParams(0.8, 50)


def _cfg(family):
    return ModelConfig(**dataclasses.asdict(FAMILY_CONFIGS[family]))


def _requests(cfg):
    reqs = family_requests(cfg, LENS)
    reqs[2]["tokens"][..., :17] = reqs[0]["tokens"][..., :17]
    return reqs


def _buffers(prog):
    """The data pointer of every buffer of a prefill program."""
    return tuple(t.data_ptr() for t in (*prog.batch.values(), prog.ints,
                                        prog.row))


def _cache_ptrs(cache):
    return tuple(leaf.data_ptr() for _, leaf in _leaves(cache))


class _Checked:
    """A prefill program run under ``NoHostSync`` and held, after each
    run, to the direct call of the model with Python ints on copies of
    the same inputs (``want``: the logits row and the cache it left)."""

    def __init__(self, eng, prog, cache, want):
        self.eng, self.prog, self.cache, self.want = eng, prog, cache, want
        self.row = prog.row

    def run(self):
        before = self.eng.generator.get_state()
        with NoHostSync():
            self.prog.run()
        assert torch.equal(self.eng.generator.get_state(), before)
        row, cache = self.want
        assert torch.equal(self.prog.row, row)
        for (name, got), (_, want) in zip(_leaves(self.cache),
                                          _leaves(cache)):
            assert torch.equal(got, want), name


def _serve_checked(cfg, params, layout):
    """Serve ``_requests`` through one engine (sampled), every prefill
    program checked by ``_Checked``.  Returns the engine, one record a
    prefill — (program, kind, uid, (slot, frontier, valid, total), its
    buffers' and its cache's addresses) — and the first-token draws."""
    eng = Engine(cfg, params, num_slots=2, max_len=MAX_LEN, decode_chunk=3,
                 device="cpu", sampling=SAMPLED, seed=3, **LAYOUTS[layout])
    for req, arrival in zip(_requests(cfg), ARRIVALS):
        eng.submit(req["tokens"], max_new_tokens=GEN, arrival=arrival,
                   cond=req.get("cond"), patch_embeds=req.get("patch_embeds"))
    records, draws = [], []

    def prefill(kind, req, tokens, ints):
        prog = Engine._prefill(eng, kind, req, tokens, ints)
        slot, frontier, valid, total = ints
        batch = {k: v.clone() for k, v in prog.batch.items()}
        if kind == "prefill":
            cache = eng._one
            want_cache = eng.model.init_cache(params, 1, MAX_LEN)
            logits, _ = eng.model.prefill(params, batch, want_cache, valid)
        else:
            cache = eng.cache
            want_cache = cache_lib.clone(cache)
            logits, _ = eng.model.prefill_chunk(params, batch, want_cache,
                                                slot, frontier, valid, total)
        records.append((prog, kind, req.uid, ints, _buffers(prog),
                        _cache_ptrs(cache)))
        return _Checked(eng, prog, cache,
                        (logits[:, valid - 1:valid], want_cache))

    selector = eng.selector

    def select(logits, generator):
        if any(logits is r[0].row for r in records):
            draws.append(records[-1][2])        # the uid it samples for
        return selector(logits, generator)

    eng._prefill, eng.selector = prefill, select
    eng.run()
    return eng, records, draws


@pytest.fixture(scope="module")
def served():
    runs = {}

    def get(family, layout):
        if (family, layout) not in runs:
            cfg = _cfg(family)
            params = build_model(cfg).init(torch.Generator().manual_seed(0))
            runs[family, layout] = _serve_checked(cfg, params, layout)
        return runs[family, layout]
    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_programs_need_no_host_sync(family, layout, served):
    """(a) Every prefill program ran under ``NoHostSync`` (in
    ``_Checked.run``) without touching the generator; the selector drew
    once a request, from its program's row, after its last chunk."""
    eng, records, draws = served(family, layout)
    assert sorted(draws) == list(range(len(LENS)))
    for uid in draws if layout == "paged" else ():
        last = [ints for _, _, u, ints, _, _ in records if u == uid][-1]
        assert last[1] + last[2] == last[3]      # frontier + valid = total
    assert eng.throughput()["counters"]["finished"] == len(LENS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_buffers_keep_their_addresses(family, layout, served):
    """(b) Each program keeps its buffers' and its cache's addresses over
    every request it serves: the dense 16-token bucket two requests, the
    paged chunk program every chunk of both slots."""
    eng, records, _ = served(family, layout)
    by_prog = {}
    for prog, kind, uid, ints, bufs, cache in records:
        by_prog.setdefault(id(prog), []).append((kind, uid, ints[0], bufs,
                                                 cache))
    for runs in by_prog.values():
        assert len({(bufs, cache) for _, _, _, bufs, cache in runs}) == 1
    if layout == "dense":
        assert {r[1] for r in records} == {"prefill"}
        uids = [[uid for _, uid, _, _, _ in runs] for runs in by_prog.values()]
        assert sorted(map(len, uids)) == [1, 2, 2]   # buckets 8, 16, 32
    else:
        (runs,) = by_prog.values()
        assert {slot for _, _, slot, _, _ in runs} == {0, 1}
        assert len({uid for _, uid, _, _, _ in runs}) == len(LENS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_one_program_equals_the_direct_int_call(family, layout, served):
    """(c) ``_Checked.run`` held every run to the direct call with Python
    ints: here, that one program object served different slots,
    frontiers (past 0, and for a sharing family at the first chunk of a
    shared-prefix admission), valid lengths and extents."""
    eng, records, _ = served(family, layout)
    progs = {}
    for prog, kind, uid, ints, _, _ in records:
        progs.setdefault(id(prog), set()).add(ints)
    assert max(len(seen) for seen in progs.values()) >= 2
    if layout == "paged":
        (seen,) = progs.values()
        for i in range(4):
            assert len({ints[i] for ints in seen}) >= 2
        first = {}
        for _, _, uid, ints, _, _ in records:
            first.setdefault(uid, ints[1])
        shares = family in ("dense", "moe")
        assert (first[2] == 16) == shares
        assert (eng.pool.stats["prefix_hit_tokens"] > 0) == shares


@pytest.mark.parametrize("family", FAMILIES)
def test_dense_engine_tokens_match_reference_engine(family):
    """(d) Greedy, prompts in three buckets (8, 16 and 32; 28 with the
    audio cond frames), two of them in one: the port's dense engine emits
    the JAX reference engine's tokens."""
    ref_cfg = FAMILY_CONFIGS[family]
    rp, pp = both_params(ref_cfg, seed=0)
    reqs = family_requests(ref_cfg, (5, 9, 12, 20))
    want, _ = run_engine(RefEngine, ref_cfg, rp, reqs, gen=4)
    got, eng = run_engine(Engine, _cfg(family), pp, reqs, gen=4,
                          device="cpu")
    assert_same_tokens(got, want)
    assert len(eng._prefills) == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU has no CUDA graphs")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_captured_prefills_match_eager_on_card(family, cuda_device):
    """(e) Dense and paged, greedy and sampled from one seed: the
    captured engine's tokens equal the eager engine's; it captured one
    decode graph and one prefill graph a bucket (dense) or one chunk
    graph (paged), in ``compile_s``; one more replay of each prefill
    program passes with host synchronisation forbidden."""
    cfg = _cfg(family)
    params = build_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    for layout in LAYOUTS:
        for sampling in (SamplingParams(), SAMPLED):
            out = {}
            for graphs in (True, False):
                eng = Engine(cfg, params, num_slots=2, max_len=MAX_LEN,
                             decode_chunk=3, device=cuda_device,
                             sampling=sampling, seed=3, graphs=graphs,
                             **LAYOUTS[layout])
                for req, arrival in zip(_requests(cfg), ARRIVALS):
                    eng.submit(req["tokens"], max_new_tokens=GEN,
                               arrival=arrival, cond=req.get("cond"),
                               patch_embeds=req.get("patch_embeds"))
                out[graphs] = eng.run()
                programs = 1 + (3 if layout == "dense" else 1)
                assert eng.obs.counter("serve.compiles").total == (
                    programs if graphs else 0)
                assert (eng.stats["compile_s"] > 0) == graphs
                if graphs:
                    torch.cuda.synchronize(cuda_device)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        for prog in eng._prefills.values():
                            prog.run()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize(cuda_device)
            for uid, toks in out[False].items():
                np.testing.assert_array_equal(
                    out[True][uid], toks,
                    err_msg=f"{layout} {sampling} request {uid}")
