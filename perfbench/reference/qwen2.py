"""Plain PyTorch Qwen2 decoder (model type ``qwen2``: Qwen2 / Qwen2.5).

Written from the published architecture (the Qwen2 technical report,
arXiv:2407.10671, and the ``config.json`` keys it names): pre-norm
blocks of grouped-query attention with bias on q, k and v, rotary
embeddings over the two halves of each head (theta ``rope_theta``),
RMSNorm with weight (eps ``rms_norm_eps``), a SwiGLU MLP, a final
RMSNorm and a head tied to the embedding where ``tie_word_embeddings``
says so.  Every weight is ``(d_in, d_out)``, so a projection is
``x @ w``; the leaves are stacked over layers.  No kernel, no cache, no
batching tricks: one full causal forward.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.products import F32
from perfbench.reference.weights import Leaf


def dims(cfg):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return (d, H, cfg["num_key_value_heads"], d // H,
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def leaves(cfg) -> list:
    """The leaves, in the param tree's layout, with their draws."""
    d, H, KV, hd, f, V, L = dims(cfg)
    s = 1.0 / math.sqrt(d)
    out = [Leaf(("embed",), (V, d), "normal", 0.02),
           Leaf(("blocks", "ln1"), (L, d), "ones", 0.02),
           Leaf(("blocks", "ln2"), (L, d), "ones", 0.02),
           Leaf(("blocks", "attn", "wq"), (L, d, H * hd), "normal", s),
           Leaf(("blocks", "attn", "wk"), (L, d, KV * hd), "normal", s),
           Leaf(("blocks", "attn", "wv"), (L, d, KV * hd), "normal", s),
           Leaf(("blocks", "attn", "wo"), (L, H * hd, d), "normal",
                1.0 / math.sqrt(H * hd)),
           Leaf(("blocks", "attn", "bq"), (L, H * hd), "normal", 0.02),
           Leaf(("blocks", "attn", "bk"), (L, KV * hd), "normal", 0.02),
           Leaf(("blocks", "attn", "bv"), (L, KV * hd), "normal", 0.02),
           Leaf(("blocks", "mlp", "w_gate"), (L, d, f), "normal", s),
           Leaf(("blocks", "mlp", "w_up"), (L, d, f), "normal", s),
           Leaf(("blocks", "mlp", "w_down"), (L, f, d), "normal",
                1.0 / math.sqrt(f)),
           Leaf(("ln_f",), (d,), "ones", 0.02)]
    if not cfg["tie_word_embeddings"]:
        out.append(Leaf(("head",), (d, V), "normal", s))
    return out


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x: (B, T, heads, hd) at positions 0..T-1; the two halves of each
    head rotate together."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def block(p, l, cfg, x, P):
    """Decoder layer ``l`` of the stacked leaves ``p`` on x (B, T, d)."""
    d, H, KV, hd, f, V, L = dims(cfg)
    eps = cfg["rms_norm_eps"]
    B, T, _ = x.shape
    a = p["attn"]
    u = rms_norm(x, p["ln1"][l], eps)
    q = (P.mm(u, a["wq"][l]) + a["bq"][l]).view(B, T, H, hd)
    k = (P.mm(u, a["wk"][l]) + a["bk"][l]).view(B, T, KV, hd)
    v = (P.mm(u, a["wv"][l]) + a["bv"][l]).view(B, T, KV, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = P.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = P.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    x = x + P.mm(o.reshape(B, T, H * hd), a["wo"][l])
    m = p["mlp"]
    u = rms_norm(x, p["ln2"][l], eps)
    g = P.mm(u, m["w_gate"][l])
    return x + P.mm(torch.nn.functional.silu(g) * P.mm(u, m["w_up"][l]),
                    m["w_down"][l])


def head(params, cfg):
    return params["embed"].T if cfg["tie_word_embeddings"] else params["head"]


def hidden(params, cfg, tokens, P=F32):
    """tokens (B, T) -> the final-normed hidden states (B, T, d)."""
    x = params["embed"][tokens.long()]
    for l in range(cfg["num_hidden_layers"]):
        x = block(params["blocks"], l, cfg, x, P)
    return rms_norm(x, params["ln_f"], cfg["rms_norm_eps"])


def logits(params, cfg, h, P=F32):
    return P.mm(h, head(params, cfg))
