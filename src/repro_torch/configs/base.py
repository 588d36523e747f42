"""Configuration for the PyTorch port.

A copy of ``repro/configs/base.py``'s :class:`ModelConfig`,
:class:`ParleConfig` and ``smoke_variant`` (the port keeps its own copy
and imports nothing from the JAX package).  ``ParleConfig.compute_dtype``
returns a torch dtype.

Everything is a plain frozen dataclass so configs are hashable,
printable and serializable; ``dataclasses.replace`` is the mutation
idiom.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition.

    ``family`` selects the block type:
      dense   — pre-norm decoder transformer, GQA + SwiGLU
      moe     — dense attention + mixture-of-experts MLP (top-k routed,
                optional shared experts)
      ssm     — Mamba2 / SSD, attention-free
      hybrid  — Mamba2 backbone + a *shared* attention block every
                ``attn_every`` layers (Zamba2-style)
      vlm     — dense decoder that consumes text tokens with patch
                embeddings scattered at image positions (frontend stubbed)
      audio   — decoder over ``num_codebooks`` parallel EnCodec token
                streams, one LM head per codebook (frontend stubbed)
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free families
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0             # per routed expert hidden dim
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # switch-style load-balance loss
    moe_groups: int = 0              # >1: GShard grouped dispatch (= data
                                     # shards); buffers get data/model
                                     # sharding constraints (needs a mesh)
    moe_impl: str = "pjit"           # pjit | shard_map (expert-parallel
                                     # dispatch via shard_map; §Perf B4)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0               # N, state size per head
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2              # inner dim = expand * d_model
    ssm_conv: int = 4                # depthwise causal conv width
    ssm_chunk: int = 128             # SSD chunk length

    # --- hybrid (Zamba2) ---
    attn_every: int = 0              # shared attn block after every k SSM layers

    # --- attention variants ---
    sliding_window: int = 0          # 0 = full causal; >0 = window size

    # --- multimodal stubs ---
    num_codebooks: int = 0           # audio: parallel token streams
    num_patches: int = 0             # vlm: patch embeddings per sequence
    cond_len: int = 0                # audio: prepended conditioning frames

    # provenance
    source: str = ""                 # citation for the config values

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities ----------------------------------------
    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def num_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n = 0
        n += V * d                                    # embed
        if not self.tie_embeddings:
            n += V * d * max(1, self.num_codebooks or 1) if self.family == "audio" else V * d
        if self.family == "audio" and self.num_codebooks > 1:
            n += (self.num_codebooks - 1) * V * d     # extra codebook embeds
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
            per_layer += d * H * hd + 2 * d * KV * hd + H * hd * d   # qkvo
            if self.family == "moe":
                per_layer += d * self.num_experts                     # router
                per_layer += self.num_experts * 3 * d * self.expert_d_ff
                if self.num_shared_experts:
                    per_layer += 3 * d * self.shared_expert_d_ff
            else:
                per_layer += 3 * d * self.d_ff                        # swiglu
            per_layer += 2 * d                                        # norms
        elif self.family in ("ssm", "hybrid"):
            di, N, P = self.ssm_inner, self.ssm_state, self.ssm_head_dim
            nh = self.ssm_num_heads
            # in_proj -> [z, x, B, C, dt]
            per_layer += d * (2 * di + 2 * N * nh + nh)
            per_layer += self.ssm_conv * di                           # dw conv
            per_layer += nh * 2                                       # A, D
            per_layer += di * d                                       # out_proj
            per_layer += 2 * d
        n += per_layer * L
        if self.family == "hybrid" and self.attn_every:
            hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
            n += d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * self.d_ff + 2 * d
        n += d                                                        # final norm
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k routed + shared experts)."""
        if self.family != "moe":
            return self.num_params()
        d, L = self.d_model, self.num_layers
        inactive = (self.num_experts - self.top_k) * 3 * d * self.expert_d_ff * L
        return self.num_params() - inactive


@dataclass(frozen=True)
class ParleConfig:
    """Hyper-parameters of Eq. (8)–(9).  Paper defaults throughout (§3.1)."""

    n_replicas: int = 3
    L: int = 25                  # inner (Entropy-SGD) steps between syncs
    alpha: float = 0.75          # exponential-average coefficient (8b)
    gamma0: float = 100.0        # initial local-entropy scope
    rho0: float = 1.0            # initial elastic coupling
    gamma_min: float = 1.0       # clip (§3.1)
    rho_min: float = 0.1         # clip (§3.1)
    momentum: float = 0.9        # Nesterov (Remark 2)
    lr: float = 0.1              # eta  (outer x^a step)
    lr_inner: float = 0.1        # eta' (inner y step; "fixed to the initial lr")
    batches_per_epoch: int = 390 # B in Eq. (9) scoping schedule
    scale_lr_by_gamma: bool = True   # Remark 1: eta <- eta * gamma for the z-term
    mode: str = "parle"          # parle | entropy_sgd | elastic_sgd (baselines)
    # §4 step-decay schedule: at each boundary step, lr AND lr_inner are
    # multiplied by lr_drop_factor.  () disables the schedule.
    lr_drop_steps: Tuple[int, ...] = ()
    lr_drop_factor: float = 0.2
    # "f32" keeps everything float32; "bf16" stores the inner iterate y
    # (and hence activations and grads) in bfloat16 while x, z and both
    # momenta stay f32 masters.
    precision: str = "f32"
    # Compression of the Eq. (8d) sync payload: "none", "bf16" or "int8"
    # (per-1024-chunk scales + an error-feedback residual in the state).
    sync_compress: str = "none"
    # Staleness-1 overlapped sync: each round's consensus is applied at
    # the start of the next round (flushed after the last).
    sync_overlap: bool = False

    def scoping_factor(self) -> float:
        return 1.0 - 1.0 / (2.0 * self.batches_per_epoch)

    def compute_dtype(self):
        import torch
        if self.precision == "bf16":
            return torch.bfloat16
        if self.precision == "f32":
            return torch.float32
        raise ValueError(f"unknown precision {self.precision!r}")


def replace(cfg, **kw):
    """Convenience re-export of dataclasses.replace."""
    return dataclasses.replace(cfg, **kw)


def smoke_variant(m: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests.

    2 layers, d_model <= 512, <= 4 experts — per the deliverables spec.
    """
    kw = dict(
        name=m.name + "-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4 if m.num_heads else 0,
        num_kv_heads=min(m.num_kv_heads, 2) if m.num_heads else 0,
        d_ff=512 if m.d_ff else 0,
        vocab_size=512,
        head_dim=64 if m.num_heads else 0,
    )
    if m.family == "moe":
        kw.update(num_experts=4, top_k=min(m.top_k, 2),
                  expert_d_ff=256,
                  num_shared_experts=min(m.num_shared_experts, 1),
                  shared_expert_d_ff=256 if m.num_shared_experts else 0,
                  capacity_factor=8.0)   # drop-free at smoke scale
    if m.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if m.family == "hybrid":
        kw.update(attn_every=1)
    if m.family == "vlm":
        kw.update(num_patches=min(m.num_patches, 4))
    if m.family == "audio":
        kw.update(num_codebooks=m.num_codebooks, cond_len=min(m.cond_len, 8))
    if m.sliding_window:
        kw.update(sliding_window=64)
    return dataclasses.replace(m, **kw)
