"""The Megatron split of a replica over its "model" ranks, and the MoE's
batch over its "data" ranks: the context the training forward reads.

The reference's "model" axis is tensor-parallel: "contracted dims keep
a partial-sum layout and pay a reduce-scatter/all-reduce inside a
replica" (``repro/sharding/rules.py``).  Here a rank of the M "model"
ranks of a replica computes its column of each split product
(``core/parle.py::ShardGrads`` hands it its column of each leaf), as
Megatron-LM does:

* attention: the rank's H/M query heads and the KV heads they read
  (``models/attention.py``), ``wo`` row-parallel;
* the dense SwiGLU and the MoE's shared expert: gate and up
  column-parallel, down row-parallel;
* the MoE's routed experts: the rank's E/M experts
  (``models/moe.py``; the router runs whole on every rank);
* the Mamba2 mixer (the ssm family, and the hybrid's SSM layers;
  ``models/mamba2.py``): the rank's H/M SSD heads, their z, x and dt
  channels and all of B and C (one group shared by every head), the
  depthwise conv, ``out_proj`` row-parallel, the gated RMSNorm's sum of
  squares summed over "model";
* the token embedding: the rank's d/M columns, gathered over "model"
  (the audio family's K codebook tables alike);
* the LM head: vocab-parallel, the rank's V/M logits (the audio
  family's K·V/M of its K codebook heads)
  (``models/layers.py::vocab_parallel_cross_entropy``).

A tied embedding and head are read whole on every rank.

A split region is entered through :meth:`TensorParallel.copy` (identity
forward, the grads summed over "model" backward) and left through
:meth:`TensorParallel.reduce` (the partial sums summed over "model"
forward, identity backward), the conjugate pair of
``sharding/partition.py::MeshGroups``.  So everything outside the split
regions (the residual stream, the norms, the router, the loss) is the
same on every "model" rank, values and grads.

The planner's block of a packed leaf need not be the compute's column:
``in_proj`` packs ``[z | x | B | C | dt]`` and the planner splits its
columns contiguously over "model" (so does ``conv_w``'s channels).  A
rank multiplies by its planner block and the outputs are gathered over
"model" as activations (:meth:`TensorParallel.gather_summed`: the
backward reduce-scatters the grads, so a rank's block gets every rank's
grads of it).

A module is split only where M divides its split dim (heads, ff, experts,
d, vocab, SSD heads: the predicates below; the expert-parallel dispatch
splits the experts and the shared ff in balanced parts where it does
not), and :func:`leaf_split_dim` names the dim of each leaf that the
split cuts, so the leaves a rank is handed and the code that reads them
agree.  A module that M does not divide is computed
whole on every "model" rank, on its gathered leaves.  Every family is
split (:func:`splits_family`); the serving paths run unsplit.

The context is set by the training step under a mesh with an axis inside
a replica (``ShardGrads``), and, splitting only the experts, around the
expert-parallel MoE dispatch (``cfg.moe_impl == "shard_map"``: the dry
run's serving programs, the tests); one process and every serving path
run without it.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

SPLIT_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# the Mamba2 leaves of a split mixer: the dim the split cuts ("ln", the
# block's input norm, is read whole and its grads are every rank's own)
SSM_SPLIT_DIMS = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "A_log": -1,
                  "D": -1, "dt_bias": -1, "norm": -1, "out_proj": -2}


def split(size: int, parts: int, index: int):
    """[lo, hi) of part ``index`` of ``size`` items in ``parts`` nearly
    equal parts, the first ``size % parts`` one larger."""
    base, extra = divmod(size, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def splits_family(cfg) -> bool:
    return cfg.family in SPLIT_FAMILIES


def splits_attention(cfg, M: int) -> bool:
    """Each rank takes H/M whole query heads."""
    return M > 1 and cfg.num_heads % M == 0


def splits_mlp(cfg, M: int) -> bool:
    return M > 1 and cfg.d_ff % M == 0


def splits_experts(cfg, M: int) -> bool:
    """Each rank takes E/M experts; under the expert-parallel dispatch
    (``cfg.moe_impl == "shard_map"``) a balanced split where M does not
    divide E (60 experts over 16)."""
    return M > 1 and (cfg.num_experts % M == 0
                      or cfg.moe_impl == "shard_map")


def splits_shared(cfg, M: int) -> bool:
    return M > 1 and (cfg.shared_expert_d_ff % M == 0
                      or cfg.moe_impl == "shard_map")


def splits_ssm(cfg, M: int) -> bool:
    """Each rank takes H/M whole SSD heads of the Mamba2 mixer.  M
    divides the packed ``in_proj``'s and the conv's widths too (their
    B and C, 2N), so the planner splits both into the blocks the compute
    reads."""
    return (M > 1 and cfg.family in ("ssm", "hybrid")
            and cfg.ssm_num_heads % M == 0 and 2 * cfg.ssm_state % M == 0)


def head_width(cfg) -> int:
    """The LM head's output columns: V, or the audio family's K·V (its K
    codebook heads side by side)."""
    return cfg.vocab_size * (cfg.num_codebooks if cfg.family == "audio"
                             else 1)


def splits_embed(cfg, M: int) -> bool:
    """The rank's d/M columns of an untied embedding.  A tied one (the
    head is the embedding transposed) is read whole on every rank, as the
    head is: no arch of the catalog ties them."""
    return M > 1 and cfg.d_model % M == 0 and not cfg.tie_embeddings


def splits_head(cfg, M: int) -> bool:
    """The untied head vocab-parallel (the rank's contiguous K·V/M
    columns of an audio head, as the planner splits it); a tied one
    whole (:func:`splits_embed`)."""
    return M > 1 and head_width(cfg) % M == 0 and not cfg.tie_embeddings


def leaf_split_dim(cfg, M: int, names) -> Optional[int]:
    """The dim (negative, so that a stacked layer axis does not move it)
    of the param leaf at key path ``names`` that the split over M "model"
    ranks cuts, or None: every "model" rank reads the leaf whole."""
    if not splits_family(cfg) or M == 1:
        return None
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    if names == ("embed",):
        return -1 if splits_embed(cfg, M) else None
    if names == ("head",):
        return -1 if splits_head(cfg, M) else None
    if parent == "attn" and splits_attention(cfg, M):
        return -2 if leaf == "wo" else -1
    if (parent == "mlp" and splits_mlp(cfg, M)) or (
            parent == "shared" and splits_shared(cfg, M)):
        return -2 if leaf == "w_down" else -1
    if parent == "moe" and leaf != "router" and splits_experts(cfg, M):
        return -3                                   # (L, E, ., .)
    if parent == "layers" and splits_ssm(cfg, M):
        return SSM_SPLIT_DIMS.get(leaf)
    return None


@dataclass(frozen=True)
class TensorParallel:
    """Column ``column`` of ``columns`` "model" ranks, whose collectives
    run on ``group`` (a ``MeshGroups``; None: no collective, a column's
    partial sums come back as they are), with the replica's batch rows
    split over ``data`` "data" ranks (1: the rank holds every row).
    ``experts_only``: only the MoE blocks split (the expert-parallel
    dispatch of a serving program or a lone MoE block, as the
    reference's shard_map runs it); every other module runs whole."""

    columns: int = 1
    column: int = 0
    group: Optional[object] = None
    data: int = 1
    experts_only: bool = False

    def __post_init__(self):
        if not 0 <= self.column < self.columns:
            raise ValueError(f"column {self.column} of {self.columns}")

    def part(self, size: int):
        """[lo, hi) of the column's part of ``size`` items."""
        return split(size, self.columns, self.column)

    def cols(self, w, full: int, dim: int):
        """The column's part of ``w`` along ``dim``: ``w`` is the whole
        (``full`` items there; a view is taken) or the column's own part
        (passed on)."""
        lo, hi = self.part(full)
        size = w.shape[dim]
        if size == full:
            return w.narrow(dim, lo, hi - lo)
        if size == hi - lo:
            return w
        raise ValueError(f"column [{lo}, {hi}) of {full} takes {full} or "
                         f"{hi - lo} along dim {dim}, not {size}")

    @property
    def collective(self) -> bool:
        return self.group is not None and self.columns > 1

    def copy(self, x):
        """Enter a split region: identity forward, the grads summed over
        "model" backward."""
        return self.group.copy_to_model(x) if self.collective else x

    def reduce(self, x):
        """Leave a split region: the partial sums summed over "model"
        forward, identity backward."""
        return self.group.reduce_from_model(x) if self.collective else x

    def allsum(self, x):
        """``x`` summed over "model" forward and its grad summed over
        "model" backward: a sum every rank reads whole, each for its own
        part (the split gated RMSNorm's sum of squares)."""
        return self.copy(self.reduce(x))

    def gather(self, x, dim: int):
        """Every column's ``x`` concatenated along ``dim`` in column order
        forward, the column's slice of the grad backward."""
        if self.columns == 1:
            return x
        if self.group is None:
            raise ValueError("gathering over 'model' needs a group")
        return self.group.gather_from_model(x, dim)

    def gather_summed(self, x, dim: int):
        """Every column's ``x`` concatenated along ``dim`` in column order
        forward; backward, every column's grad of this column's slice
        summed (one reduce-scatter): a gathered tensor each column reads
        in parts of its own (a packed projection's outputs, KV heads cut
        mid-head)."""
        if self.columns == 1:
            return x
        if self.group is None:
            raise ValueError("gathering over 'model' needs a group")
        return self.group.gather_summed_from_model(x, dim)

    def max_(self, x):
        """``x`` (no grad) -> its elementwise max over "model", in place."""
        return self.group.model_max_(x) if self.collective else x


_CONTEXT = contextvars.ContextVar("tensor_parallel", default=None)


def context() -> Optional[TensorParallel]:
    """The context set, as the MoE blocks read it."""
    return _CONTEXT.get()


def current() -> Optional[TensorParallel]:
    """The context as every module but the MoE reads it: None where it
    splits only the experts."""
    tp = _CONTEXT.get()
    return None if tp is None or tp.experts_only else tp


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Run the forward called inside as ``tp`` says (None: unsplit)."""
    token = _CONTEXT.set(tp)
    try:
        yield tp
    finally:
        _CONTEXT.reset(token)


def within(tp: Optional[TensorParallel], fn):
    """``fn`` run under ``tp``: a block that ``torch.utils.checkpoint``
    recomputes in the backward (which may run on another thread, where
    the context is not set) takes the context of its forward."""
    if tp is None:
        return fn

    def run(*args):
        with tensor_parallel(tp):
            return fn(*args)

    return run
