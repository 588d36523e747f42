"""Plain PyTorch Mamba2 language model (model type ``mamba2``).

Written from the Mamba2 paper (Dao and Gu, arXiv:2405.21060, §6 and
Listing 1, "SSD minimal"): each layer is x + Mamba2(RMSNorm(x)) with one
input projection to [z, xBC, dt], a depthwise causal convolution of
width ``d_conv`` and SiLU over xBC, the selective state space

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ,    y_t = C_t h_t + D x_t

over ``nheads`` heads of ``headdim`` with one group of B and C of
``d_state``, computed by the paper's chunked algorithm (segment sums
within chunks of ``chunk_size``, chunk states passed on between them),
then RMSNorm(y * SiLU(z)) and the output projection; a final RMSNorm and
an untied head.  The embedding has ``vocab_size`` rounded up to
``pad_vocab_size_multiple`` rows, as the released checkpoints do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.products import F32
from perfbench.reference.weights import Leaf


def vocab_rows(cfg) -> int:
    m = cfg["pad_vocab_size_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def dims(cfg):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    N = cfg["d_state"]
    nh = di // cfg["headdim"]
    return d, di, N, nh, cfg["headdim"], cfg["d_conv"], cfg["n_layer"]


def leaves(cfg) -> list:
    d, di, N, nh, P_, W, L = dims(cfg)
    V = vocab_rows(cfg)
    conv = di + 2 * N
    return [Leaf(("embed",), (V, d), "normal", 0.02),
            Leaf(("layers", "ln"), (L, d), "ones", 0.02),
            Leaf(("layers", "in_proj"), (L, d, 2 * di + 2 * N + nh),
                 "normal", 1.0 / math.sqrt(d)),
            Leaf(("layers", "conv_w"), (L, W, conv), "normal",
                 1.0 / math.sqrt(W)),
            Leaf(("layers", "conv_b"), (L, conv), "normal", 0.02),
            Leaf(("layers", "A_log"), (L, nh), "log_linspace"),
            Leaf(("layers", "D"), (L, nh), "ones", 0.02),
            Leaf(("layers", "dt_bias"), (L, nh), "log_uniform_dt"),
            Leaf(("layers", "norm"), (L, di), "ones", 0.02),
            Leaf(("layers", "out_proj"), (L, di, d), "normal",
                 1.0 / math.sqrt(di)),
            Leaf(("ln_f",), (d,), "ones", 0.02),
            Leaf(("head",), (d, V), "normal", 1.0 / math.sqrt(d))]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def segsum(a):
    """(..., T) -> (..., T, T): entry (i, j) is a[j+1] + ... + a[i] for
    j <= i, -inf above the diagonal (the paper's stable segment sum)."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    s = torch.cumsum(a.masked_fill(~below, 0.0), dim=-2)
    return s.masked_fill(~below.logical_or(torch.eye(
        T, dtype=torch.bool, device=a.device)), float("-inf"))


def ssd(X, A, B, C, Q, P=F32):
    """The paper's chunked SSD.  X (b, T, h, p) already times dt; A
    (b, T, h) = dt A; B, C (b, T, n).  T is padded to chunks of Q with
    inert positions (A = 0, X = 0).  Returns y (b, T, h, p)."""
    b, T, h, p = X.shape
    pad = (-T) % Q
    if pad:
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        A = F.pad(A, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c = X.shape[1] // Q
    X = X.reshape(b, c, Q, h, p)
    B = B.reshape(b, c, Q, -1)
    C = C.reshape(b, c, Q, -1)
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)          # b h c l
    A_cum = torch.cumsum(A, dim=-1)
    Lmat = torch.exp(segsum(A))                            # b h c l s
    CB = P.einsum("bcln,bcsn->bcls", C, B)
    Y_diag = P.einsum("bcls,bhcls,bcshp->bclhp", CB, Lmat, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)      # b h c l
    states = P.einsum("bcln,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = P.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = P.einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, c * Q, h, p)[:, :T]


def layer(p, l, cfg, x, P):
    d, di, N, nh, hp, W, L = dims(cfg)
    eps = cfg["norm_epsilon"]
    b, T, _ = x.shape
    u = rms_norm(x, p["ln"][l], eps)
    proj = P.mm(u, p["in_proj"][l])
    z, xBC, dt = proj.split([di, di + 2 * N, nh], dim=-1)
    w = p["conv_w"][l]                                     # (W, conv)
    xBC = F.conv1d(xBC.transpose(1, 2), w.T[:, None, :],
                   padding=W - 1, groups=w.shape[1])[..., :T]
    xBC = F.silu(xBC.transpose(1, 2) + p["conv_b"][l])
    xs, Bm, Cm = xBC.split([di, N, N], dim=-1)
    xs = xs.reshape(b, T, nh, hp)
    dt = F.softplus(dt + p["dt_bias"][l])                 # (b, T, nh)
    A = -torch.exp(p["A_log"][l])
    y = ssd(xs * dt[..., None], dt * A, Bm, Cm, cfg["chunk_size"], P)
    y = (y + p["D"][l][:, None] * xs).reshape(b, T, di)
    y = rms_norm(y * F.silu(z), p["norm"][l], eps)
    return x + P.mm(y, p["out_proj"][l])


def hidden(params, cfg, tokens, P=F32):
    x = params["embed"][tokens.long()]
    for l in range(cfg["n_layer"]):
        x = layer(params["layers"], l, cfg, x, P)
    return rms_norm(x, params["ln_f"], cfg["norm_epsilon"])


def logits(params, cfg, h, P=F32):
    return P.mm(h, params["head"])
