"""The H100's published peaks, the card's power limit, and the operations
and bytes of the work the benchmark times, each computed from shapes.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16 / fp16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s of HBM.  A share of a float32 configuration
is taken against the TF32 rate: the fastest rate at which an
implementation can still meet float32 tolerances (three TF32 products,
as the program's K3 and K9 do), so no later redesign can read a share
over 100% of it.  The card's ``power.limit`` is reported beside every
share: a card set below 700 W runs slower under load.

Counting: each input byte read once and each output byte written once;
an operation the inputs do not need (the masked half of a causal score
matrix) is not counted (``as_computed=False``); ``as_computed=True``
counts what the program's plain path multiplies, which
``torch.utils.flop_counter.FlopCounterMode`` sees (the tests hold the two
equal at small sizes).
"""
from __future__ import annotations

import subprocess

from perfbench.reference.mamba2 import vocab_rows

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def power_limit_w():
    """The card's ``power.limit`` in watts from ``nvidia-smi``, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def least_time_s(flops: float, nbytes: float, rate: str = "tf32") -> float:
    """The least time the card could take: the larger of its operations
    over the peak rate and its bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS[rate], nbytes / PEAK_BYTES_PER_S)


# ------------------------------------------------------------------
# the models: parameters and forward operations
# ------------------------------------------------------------------

def _causal_pairs(T: int, as_computed: bool) -> float:
    """Query-key pairs of a causal T x T score matrix."""
    return T * T if as_computed else T * (T + 1) / 2


def qwen2_dims(cfg):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return (d, H, cfg["num_key_value_heads"], d // H,
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def mamba2_dims(cfg):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return (d, di, cfg["d_state"], di // cfg["headdim"], cfg["headdim"],
            cfg["d_conv"], cfg["n_layer"], vocab_rows(cfg))


def layer_matmul_params(cfg) -> int:
    """Weights of one layer that enter a product."""
    if cfg["model_type"] == "qwen2":
        d, H, KV, hd, f, V, L = qwen2_dims(cfg)
        return d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    d, di, N, nh, P, W, L, V = mamba2_dims(cfg)
    return d * (2 * di + 2 * N + nh) + di * d


def head_params(cfg) -> int:
    """Weights of the head (tied or not, it enters a product)."""
    if cfg["model_type"] == "qwen2":
        return cfg["hidden_size"] * cfg["vocab_size"]
    return cfg["d_model"] * vocab_rows(cfg)


def num_layers(cfg) -> int:
    return cfg["num_hidden_layers" if cfg["model_type"] == "qwen2"
               else "n_layer"]


def param_count(cfg) -> int:
    """Every parameter of the model (the Parle state's row, less the
    program's alignment gaps)."""
    if cfg["model_type"] == "qwen2":
        d, H, KV, hd, f, V, L = qwen2_dims(cfg)
        per = layer_matmul_params(cfg) + H * hd + 2 * KV * hd + 2 * d
        head = 0 if cfg["tie_word_embeddings"] else d * V
        return V * d + L * per + d + head
    d, di, N, nh, P, W, L, V = mamba2_dims(cfg)
    conv = di + 2 * N
    per = layer_matmul_params(cfg) + d + W * conv + conv + 3 * nh + di
    return V * d + L * per + d + d * V


def forward_flops(cfg, B: int, T: int, as_computed: bool = False) -> float:
    """One forward pass over (B, T) tokens, the head and the loss's
    product included (the loss's other arithmetic is not a product)."""
    L = num_layers(cfg)
    mm = 2.0 * B * T * (L * layer_matmul_params(cfg) + head_params(cfg))
    if cfg["model_type"] == "qwen2":
        d, H, KV, hd, f, V, L = qwen2_dims(cfg)
        # Q·Kᵀ and P·V over every query head
        mix = 4.0 * B * H * hd * _causal_pairs(T, as_computed)
        return mm + L * mix
    d, di, N, nh, P, W, L, V = mamba2_dims(cfg)
    Q = min(cfg["chunk_size"], T)
    c = -(-T // Q)
    pairs = _causal_pairs(Q, as_computed)
    # C·Bᵀ and the decayed scores times x within chunks; each chunk's
    # state from its inputs and its output from the carried state
    ssd = 2.0 * B * c * (pairs * N + pairs * nh * P + 2 * Q * nh * N * P)
    return mm + L * ssd


def train_step_flops(cfg, B: int, T: int) -> float:
    """Model FLOPs of one forward and backward over (B, T): the backward
    does twice the forward's products."""
    return 3.0 * forward_flops(cfg, B, T)


# ------------------------------------------------------------------
# the Parle kernels
# ------------------------------------------------------------------

def k1_bytes(n: int, M: int) -> float:
    """Eq. 8a-8b over (n, M) f32: reads y, g, x, z, v_y and writes y, z,
    v_y."""
    return (5 + 3) * F32_BYTES * float(n) * M


def k2_bytes(n: int, M: int) -> float:
    """Eq. 8c-8d over (n, M) f32 against one (M,) x̄: reads x, z, v_x
    and writes x, v_x a row, and reads x̄ once."""
    return (3 + 2) * F32_BYTES * float(n) * M + F32_BYTES * float(M)


# ------------------------------------------------------------------
# serving: the whole decode step
# ------------------------------------------------------------------

def decode_step_cost(cfg, lengths) -> tuple:
    """(operations, bytes) of one decode step over rows of ``lengths``
    live positions (after the step's token is written): every weight
    read once, each row's embedding row; the live keys and values read
    and the new ones written (qwen2), or each row's state and conv ring
    read and written (mamba2)."""
    rows = len(lengths)
    L = num_layers(cfg)
    w_bytes = F32_BYTES * float(L * layer_matmul_params(cfg)
                                + head_params(cfg))
    flops = 2.0 * rows * (L * layer_matmul_params(cfg) + head_params(cfg))
    if cfg["model_type"] == "qwen2":
        d, H, KV, hd, f, V, L = qwen2_dims(cfg)
        live = float(sum(lengths))
        flops += L * 4.0 * H * hd * live
        kv = L * 2.0 * KV * hd * F32_BYTES * (live + rows)
        return flops, w_bytes + kv + rows * d * F32_BYTES
    d, di, N, nh, P, W, L, V = mamba2_dims(cfg)
    flops += L * rows * 2.0 * (2 * nh * N * P)
    state = L * rows * F32_BYTES * 2.0 * (nh * N * P + (W - 1) * (di + 2 * N))
    return flops, w_bytes + state + rows * d * F32_BYTES
