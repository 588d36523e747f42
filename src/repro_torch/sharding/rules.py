"""Per-family partition rules: the declarative half of the sharding
planner (see :mod:`repro_torch.sharding.planner`).  Port of
``repro/sharding/rules.py`` (a copy: the port imports nothing of the JAX
package), with :class:`Spec` in place of JAX's ``PartitionSpec``.

A rule is a function ``(names, shape) -> Spec | None`` keyed on a param
tree leaf's key path (``names``, outermost first) and shape — None means
"not mine, ask the next rule".  :data:`RULE_TABLE` orders them
most-specific-first; the planner walks the table and records WHICH rule
fired for every leaf, so a planner gap is a visible ``generic`` /
``replicated`` entry instead of a silent fallthrough.

Axis conventions (launch/mesh.py):
  * ``data``  — FSDP / ZeRO-3 axis: weights sharded here are gathered
    just-in-time inside a replica.
  * ``model`` — tensor-parallel axis: the weights and state are held
    sharded over it; the training compute is split over it by the
    Megatron split (``models/megatron.py``), and a forward's experts by
    the expert-parallel MoE dispatch (``models/moe.py``).
The Parle ``replica`` / ``pod`` axis is never assigned here — the
planner prepends it to optimizer-state specs (Eq. 8d traffic rides it
alone).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

DATA, MODEL = "data", "model"


class Spec(tuple):
    """A partition spec: one entry a dim — None (replicated), an axis
    name, or a tuple of axis names (a dim split over several axes, as
    ``dp_only`` makes).  Dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


RuleFn = Callable[[Sequence[str], Tuple[int, ...]], Optional[Spec]]

# 1-D gains/biases/scalars: always replicated.  Keeping the explicit
# name list (rather than only the ndim<=1 catch-all) documents intent
# per family and guards against future 2-D leaves reusing these names.
REPLICATED_LEAVES = frozenset((
    # norms (attention / mlp / final / mamba2 gated-RMSNorm / vlm)
    "ln", "ln1", "ln2", "ln_f", "norm", "patch_ln",
    # biases
    "bq", "bk", "bv", "b", "b1", "b2", "b3", "conv_b",
    # mamba2 per-head scalars
    "A_log", "D", "dt_bias",
))

# attention / dense-MLP / mamba2 projections, by leaf name:
#   column-parallel (output dim on "model", input dim FSDP on "data")
COLUMN_PARALLEL = frozenset(("wq", "wk", "wv", "w_gate", "w_up", "in_proj"))
#   row-parallel (input dim on "model" — the contracted dim — output dim
#   FSDP)
ROW_PARALLEL = frozenset(("wo", "w_down", "out_proj"))


def replicated_rule(names, shape):
    """Norm gains, biases, per-head scalar banks, and anything 0/1-D."""
    leaf = names[-1] if names else ""
    if leaf in REPLICATED_LEAVES or len(shape) <= 1:
        return Spec(*([None] * len(shape)))
    return None


def embedding_rule(names, shape):
    """Token embeddings and LM heads: vocab on "data" (the big dim),
    d_model on "model".  Audio embeds carry a leading codebook axis."""
    leaf = names[-1] if names else ""
    if leaf == "embed":
        if len(shape) == 3:               # audio: (K, V, d)
            return Spec(None, DATA, MODEL)
        return Spec(DATA, MODEL)          # (V, d)
    if leaf == "head":
        return Spec(DATA, MODEL)          # (d, V): vocab-parallel out
    return None


def moe_rule(names, shape):
    """Router + routed expert stacks.  Experts ride "model" (expert
    parallelism); the per-expert matmul dims ZeRO-shard over "data".
    Shared-expert MLPs are plain dense mats — deferred to the
    attention/dense rule via the COLUMN/ROW tables (their path contains
    "shared" but their shapes are 2-D)."""
    leaf = names[-1] if names else ""
    if leaf == "router":
        return Spec(DATA, None)           # (d, E): E is tiny
    if len(shape) == 3 and leaf in ("w_gate", "w_up", "w_down"):
        if leaf == "w_down":
            return Spec(MODEL, None, DATA)    # (E, ff, d)
        return Spec(MODEL, DATA, None)        # (E, d, ff)
    return None


def attention_rule(names, shape):
    """QKV/out projections and dense/shared-expert SwiGLU mats (2-D)."""
    leaf = names[-1] if names else ""
    if len(shape) != 2:
        return None
    if leaf in COLUMN_PARALLEL:
        return Spec(DATA, MODEL)
    if leaf in ROW_PARALLEL:
        return Spec(MODEL, DATA)
    return None


def mamba2_rule(names, shape):
    """Mamba2/SSD leaves not already covered: the depthwise conv weight
    (W, C) shards its channel dim on "model" (in_proj's output layout);
    in_proj/out_proj hit the attention rule's COLUMN/ROW tables."""
    leaf = names[-1] if names else ""
    if leaf == "conv_w" and len(shape) == 2:
        return Spec(None, MODEL)
    return None


def conv_rule(names, shape):
    """Image-model conv kernels (HWIO): in-channels FSDP on "data",
    out-channels tensor-parallel on "model" (spatial dims replicated).
    Covers the paper-faithful All-CNN family (models/convnet.py)."""
    if len(shape) == 4:
        return Spec(None, None, DATA, MODEL)
    return None


def generic_matmul_rule(names, shape):
    """Last resort for 2-D leaves: treat as column-parallel."""
    if len(shape) == 2:
        return Spec(DATA, MODEL)
    return None


def fallback_rule(names, shape):
    """Anything still unmatched is replicated — the planner surfaces
    these as rule="fallback" so gaps are visible, not silent."""
    return Spec(*([None] * len(shape)))


# Most-specific-first.  ``fallback`` must stay last; it always matches.
RULE_TABLE: Tuple[Tuple[str, RuleFn], ...] = (
    ("replicated", replicated_rule),
    ("embedding", embedding_rule),
    ("moe", moe_rule),
    ("attention", attention_rule),
    ("mamba2", mamba2_rule),
    ("conv", conv_rule),
    ("generic", generic_matmul_rule),
    ("fallback", fallback_rule),
)

# Leaves under these path components are stacked along a leading
# layer axis; the planner strips it before matching and prepends None to
# the matched spec.
STACK_PATH_NAMES = frozenset(("blocks", "layers"))
