"""Mamba2 (SSD — state-space duality, arXiv:2405.21060).

Port of ``repro/models/mamba2.py``.  The selective state space recurrence
per head h (state N, head dim P):

    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t        a_t = exp(dt_t * A)
    y_t = C_t . h_t + D * x_t

computed with the chunked SSD algorithm: quadratic attention-like math
inside chunks of length Q = cfg.ssm_chunk, a linear recurrence across
chunk states.  ``ssd_chunked`` here is the plain PyTorch path; with
``use_kernel=True`` the forward takes the SSD-scan kernel (K9,
``kernels/ops.py::ssd_scan``) instead.

Single group (B, C shared across heads), depthwise causal conv of width
``ssm_conv`` over the xBC streams, gated RMSNorm before out-projection —
the standard Mamba2 block.  As in ``transformer.py``, the reference's
``lax.scan`` over the stacked layers is a Python loop over per-layer
views (one ``unbind(0)`` per leaf), and caches are written in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       silu, softplus)
from repro_torch.models.transformer import layer_params


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (L, B, W-1, conv_dim) ring of recent xBC inputs
    state: torch.Tensor   # (L, B, nh, N, P) SSM states
    pos: torch.Tensor     # () or (B,) int32


# ------------------------------------------------------------------
# Parameters
# ------------------------------------------------------------------

def init_ssm_layer(generator, cfg, dtype=torch.float32, layers=()):
    """One SSM block's params; ``layers=(L,)`` draws them stacked over L
    layers in one call per leaf.  in_proj -> [z (di), xBC (di+2N),
    dt (nh)]."""
    d, di, N = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    nh = cfg.ssm_num_heads
    conv_dim = di + 2 * N
    lead = tuple(layers)
    dev = generator.device

    def const(values):
        return values.to(dtype).expand(lead + values.shape).clone()

    conv_w = torch.empty(lead + (cfg.ssm_conv, conv_dim), device=dev)
    conv_w.normal_(generator=generator).mul_(0.1)
    u = torch.empty(lead + (nh,), device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    return {
        "ln": torch.ones(lead + (d,), dtype=dtype, device=dev),
        "in_proj": dense_init(generator, lead + (d, 2 * di + 2 * N + nh),
                              dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh, device=dev))),
        "D": torch.ones(lead + (nh,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, lead + (di, d), dtype=dtype),
    }


def init_stacked_ssm(generator, cfg, num_layers=None, dtype=torch.float32):
    L = cfg.num_layers if num_layers is None else num_layers
    return init_ssm_layer(generator, cfg, dtype, layers=(L,))


# ------------------------------------------------------------------
# Chunked SSD (the plain path; the kernel K9 computes the same)
# ------------------------------------------------------------------

def ssd_chunked(x, dt, A, B_mat, C_mat, chunk: int, h0=None):
    """Chunked selective scan.

    x:     (B, T, nh, P)
    dt:    (B, T, nh)           already softplus'd
    A:     (nh,)                negative reals
    B_mat: (B, T, N)            single group
    C_mat: (B, T, N)
    h0:    optional (B, nh, N, P) initial state
    Returns y: (B, T, nh, P), final state (B, nh, N, P).
    """
    Bsz, T, nh, P = x.shape
    N = B_mat.shape[-1]
    Q = min(chunk, T)
    T_orig = T
    if T % Q:
        # pad with dt=0 positions: a=1 and dB=0, so padding is inert
        pad = Q - T % Q
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B_mat = torch.nn.functional.pad(B_mat, (0, 0, 0, pad))
        C_mat = torch.nn.functional.pad(C_mat, (0, 0, 0, pad))
        T = T + pad
    nc = T // Q

    xc = x.reshape(Bsz, nc, Q, nh, P)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = B_mat.reshape(Bsz, nc, Q, N)
    Cc = C_mat.reshape(Bsz, nc, Q, N)

    log_a = dtc * A                                  # (B, nc, Q, nh), negative
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # inclusive cumsum within the chunk, as a masked sum: torch.cumsum has
    # no deterministic CUDA implementation, and training runs under
    # torch.use_deterministic_algorithms where it is checked bit for bit
    cum = (log_a[:, :, None, :, :]
           * mask[None, None, :, :, None]).sum(dim=3)

    # intra-chunk: scores[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (B, nc, Q, Q)
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,nh)
    # exp(-inf) = 0 where j > i: the reference's where(mask, exp(delta), 0)
    # value for value, but with no exp of the (large, positive) masked
    # deltas, whose inf would turn the backward's 0 into NaN
    decay = torch.exp(delta.masked_fill(~mask[None, None, :, :, None],
                                        float("-inf")))
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # per-chunk local state: sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    last = cum[:, :, -1:, :]                         # (B, nc, 1, nh)
    w = torch.exp(last - cum) * dtc                  # (B, nc, Q, nh)
    s_local = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w, Bc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])        # (B, nc, nh)

    h = (torch.zeros((Bsz, nh, N, P), dtype=x.dtype, device=x.device)
         if h0 is None else h0.to(x.dtype))
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqn,bhnp,bqh->bqhp", Cc[:, c], h,
                                    torch.exp(cum[:, c])))
        h = chunk_decay[:, c, :, None, None] * h + s_local[:, c]
    y_inter = torch.stack(y_inter, dim=1)            # (B, nc, Q, nh, P)

    y = (y_intra + y_inter).reshape(Bsz, T, nh, P)
    return y[:, :T_orig], h


def ssd_decode(x, dt, A, B_mat, C_mat, h):
    """One token.  x: (B, nh, P); dt: (B, nh); B/C: (B, N); h: (B, nh, N, P)."""
    a = torch.exp(dt * A)                            # (B, nh)
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, B_mat, x)
    h_new = a[:, :, None, None] * h + dBx
    y = torch.einsum("bn,bhnp->bhp", C_mat, h_new)
    return y, h_new


# ------------------------------------------------------------------
# Block forward
# ------------------------------------------------------------------

def _split_proj(cfg, proj):
    di, N = cfg.ssm_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, prefix=None):
    """Depthwise causal conv.  xBC: (B, T, C); w: (W, C).

    ``prefix``: optional (B, W-1, C) ring of raw xBC inputs preceding
    this segment (chunk-resumed prefill); None pads with zeros — and a
    zero prefix is bitwise identical to the zero padding.
    """
    W = w.shape[0]
    T = xBC.shape[1]
    if prefix is None:
        pad = torch.nn.functional.pad(xBC, (0, 0, W - 1, 0))
    else:
        pad = torch.cat([prefix.to(xBC.dtype), xBC], dim=1)
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + T, :] * w[i]
    return silu(out + b)


def _ssd_inputs(lp, cfg, xBC, dt, lead):
    """xs (lead..., nh, P), B, C, softplus'd dt and A from the conv
    output and the raw dt projection."""
    di, N = cfg.ssm_inner, cfg.ssm_state
    xs = xBC[..., :di].reshape(*lead, cfg.ssm_num_heads, cfg.ssm_head_dim)
    return (xs, xBC[..., di:di + N], xBC[..., di + N:],
            softplus(dt + lp["dt_bias"]), -torch.exp(lp["A_log"]))


def _gated_out(lp, cfg, x, y, xs, z):
    """x + out_proj(RMSNorm((y + D x) * silu(z)))."""
    y = y + lp["D"][:, None] * xs
    y = y.reshape(*z.shape)
    y = rms_norm(y * silu(z), lp["norm"], cfg.norm_eps)
    return x + y @ lp["out_proj"]


def ssm_block_forward(lp, cfg, x, h0=None, use_kernel=False):
    """x: (B, T, d) -> (B, T, d), final_state."""
    Bsz, T, _ = x.shape
    u = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xBC, dt = _split_proj(cfg, u @ lp["in_proj"])
    xBC = _causal_conv(xBC, lp["conv_w"], lp["conv_b"])
    xs, B_mat, C_mat, dt, A = _ssd_inputs(lp, cfg, xBC, dt, (Bsz, T))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        y, hf = kops.ssd_scan(xs, dt, A, B_mat, C_mat, cfg.ssm_chunk, h0=h0)
    else:
        y, hf = ssd_chunked(xs, dt, A, B_mat, C_mat, cfg.ssm_chunk, h0=h0)
    return _gated_out(lp, cfg, x, y, xs, z), hf


def ssm_block_prefill(lp, cfg, x, h0, conv0, valid):
    """Chunk-resumable SSM block: state AND conv ring threaded across
    segment boundaries, padded tail made exactly inert.

    x: (B, C, d); h0: (B, nh, N, P); conv0: (B, W-1, conv_dim) raw-xBC
    ring entering this segment; valid: int — positions >= valid are
    padding.  Forcing their dt to exactly 0 AFTER softplus makes them
    inert in the SSD recurrence (decay exp(0·A)=1, update dt·B⊗x=0),
    matching ``ssd_chunked``'s own dt=0 chunk padding, so a segmented
    prefill reproduces the one-shot scan state.  Segment length must be
    a multiple of cfg.ssm_chunk for the chunk decomposition to coincide
    (the engine rounds prefill_chunk up).  Returns (out, h_final,
    new_ring).
    """
    Bsz, T, _ = x.shape
    valid = int(valid)
    u = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xBC_raw, dt = _split_proj(cfg, u @ lp["in_proj"])
    xBC = _causal_conv(xBC_raw, lp["conv_w"], lp["conv_b"], prefix=conv0)
    xs, B_mat, C_mat, dt, A = _ssd_inputs(lp, cfg, xBC, dt, (Bsz, T))
    live = torch.arange(T, device=x.device) < valid
    dt = torch.where(live[None, :, None], dt, 0.0)
    y, hf = ssd_chunked(xs, dt, A, B_mat, C_mat, cfg.ssm_chunk, h0=h0)
    out = _gated_out(lp, cfg, x, y, xs, z)
    # ring leaving the segment: raw xBC of the W-1 positions before
    # ``valid`` (reaching into conv0 when the segment is shorter)
    hist = torch.cat([conv0.to(xBC_raw.dtype), xBC_raw], dim=1)
    return out, hf, hist[:, valid:valid + cfg.ssm_conv - 1]


def ssm_block_decode(lp, cfg, x, conv_cache, h):
    """x: (B, 1, d); conv_cache: (B, W-1, conv_dim); h: (B, nh, N, P).
    Returns (out, new conv ring, new state), all new tensors."""
    Bsz = x.shape[0]
    u = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xBC, dt = _split_proj(cfg, (u @ lp["in_proj"])[:, 0])
    # conv over [cache, current]
    window = torch.cat([conv_cache, xBC[:, None, :]], dim=1)   # (B, W, C)
    conv_out = silu(torch.einsum("bwc,wc->bc", window, lp["conv_w"])
                    + lp["conv_b"])
    xs, B_mat, C_mat, dtv, A = _ssd_inputs(lp, cfg, conv_out, dt, (Bsz,))
    y, h_new = ssd_decode(xs, dtv, A, B_mat, C_mat, h)
    out = _gated_out(lp, cfg, x[:, 0], y, xs, z)[:, None, :]
    return out, window[:, 1:], h_new


# ------------------------------------------------------------------
# Full model (family == "ssm")
# ------------------------------------------------------------------

def init_params(generator, cfg, dtype=torch.float32):
    """Random params drawn on ``generator`` (and on its device)."""
    return {
        "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype),
        "layers": init_stacked_ssm(generator, cfg, dtype=dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype,
                           device=generator.device),
        "head": dense_init(generator, (cfg.d_model, cfg.vocab_size),
                           dtype=dtype),
    }


def _layers(params, cfg):
    return layer_params(params["layers"], cfg.num_layers)


def _logits(params, cfg, x):
    return rms_norm(x, params["ln_f"], cfg.norm_eps) @ params["head"]


def forward_hidden(params, cfg, tokens, use_kernel=False):
    """Returns (final-normed hidden (B, T, d), aux_loss = 0)."""
    x = params["embed"][tokens]
    for lp in _layers(params, cfg):
        x, _ = ssm_block_forward(lp, cfg, x, use_kernel=use_kernel)
    return (rms_norm(x, params["ln_f"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params, cfg, tokens, use_kernel=False):
    """tokens: (B, T) -> logits (B, T, V), aux_loss."""
    h, aux = forward_hidden(params, cfg, tokens, use_kernel=use_kernel)
    return h @ params["head"], aux


def init_cache(cfg, batch, dtype=torch.float32, num_layers=None,
               device=None) -> SSMCache:
    L = cfg.num_layers if num_layers is None else num_layers
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((L, batch, cfg.ssm_num_heads, cfg.ssm_state,
                           cfg.ssm_head_dim), dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def prefill_layer(lp, cfg, x, cache: SSMCache, l: int, valid=None,
                  use_kernel=False):
    """Layer ``l`` of a prefill: returns its output and writes the
    layer's final state and conv ring into ``cache`` in place (the ssm
    and hybrid families' prefill)."""
    if valid is not None:
        out, hf, ring = ssm_block_prefill(lp, cfg, x, cache.state[l],
                                          cache.conv[l], valid)
    else:
        out, hf = ssm_block_forward(lp, cfg, x, h0=cache.state[l],
                                    use_kernel=use_kernel)
        # conv cache = last W-1 raw xBC inputs of this layer
        u = rms_norm(x, lp["ln"], cfg.norm_eps)
        _, ring, _ = _split_proj(cfg, u[:, -(cfg.ssm_conv - 1):]
                                 @ lp["in_proj"])
    cache.state[l].copy_(hf)
    cache.conv[l].copy_(ring)
    return out


def decode_layer(lp, cfg, x, cache: SSMCache, l: int, active=None):
    """Layer ``l`` of a one-token decode, its conv ring and state written
    in place; ``active`` (B,) bool keeps inactive rows' old values."""
    x, conv, state = ssm_block_decode(lp, cfg, x, cache.conv[l],
                                      cache.state[l])
    if active is not None:
        conv = torch.where(active[:, None, None], conv, cache.conv[l])
        state = torch.where(active[:, None, None, None], state,
                            cache.state[l])
    cache.conv[l].copy_(conv)
    cache.state[l].copy_(state)
    return x


def prefill_chunk_layer(lp, cfg, x, cache: SSMCache, l: int, slot: int,
                        valid):
    """Layer ``l`` of one slot's resumable prefill chunk (x: (1, C, d)),
    resuming from and writing back that slot's state and conv ring."""
    x, hf, ring = ssm_block_prefill(lp, cfg, x, cache.state[l, slot][None],
                                    cache.conv[l, slot][None], valid)
    cache.state[l, slot] = hf[0]
    cache.conv[l, slot] = ring[0]
    return x


def prefill(params, cfg, tokens, cache: SSMCache, use_kernel=False,
            valid=None):
    """Absorb a prompt; returns logits + the populated state cache
    (written in place).

    ``valid``: optional int — positions >= valid are padding (the
    engine's bucketed prompts); they are made inert in the scan and the
    conv ring ends at ``valid``.  None keeps the unpadded path.
    """
    x = params["embed"][tokens]
    for l, lp in enumerate(_layers(params, cfg)):
        x = prefill_layer(lp, cfg, x, cache, l, valid, use_kernel)
    return _logits(params, cfg, x), cache._replace(
        pos=cache.pos + tokens.shape[1])


def decode_step(params, cfg, token, cache: SSMCache):
    """token: (B, 1) int32 -> logits (B, 1, V); the cache is updated in
    place."""
    x = params["embed"][token]
    for l, lp in enumerate(_layers(params, cfg)):
        x = decode_layer(lp, cfg, x, cache, l)
    return _logits(params, cfg, x), cache._replace(pos=cache.pos + 1)


# ------------------------------------------------------------------
# Paged-engine entry points.  SSM state is O(1) per slot (no KV pages
# to manage) — "paged" here buys the chunked-prefill interleaving and
# the shared engine plumbing: pos is a per-slot vector, decode rows can
# be inactive, prefill runs one resumable chunk at a time.
# ------------------------------------------------------------------

def init_paged_cache(params, cfg, num_slots, num_pages, page_size, max_pages,
                     dtype=torch.float32):
    del num_pages, page_size, max_pages
    dev = params["embed"].device
    base = init_cache(cfg, num_slots, dtype, device=dev)
    return base._replace(pos=torch.zeros((num_slots,), dtype=torch.int32,
                                         device=dev))


def prefill_chunk(params, cfg, tokens, cache: SSMCache, slot, frontier,
                  valid):
    """One resumable prefill chunk for a single slot.  tokens: (1, C).
    Writes the slot's state and conv ring in place; pos is not advanced
    (the engine sets it once the whole prompt is in)."""
    del frontier                      # state carry IS the position
    x = params["embed"][tokens]
    for l, lp in enumerate(_layers(params, cfg)):
        x = prefill_chunk_layer(lp, cfg, x, cache, l, slot, valid)
    return _logits(params, cfg, x), cache


def decode_step_paged(params, cfg, token, cache: SSMCache, active):
    """decode_step over the slot batch with inactive rows frozen: their
    conv ring / state / pos keep their old values (the computed row is
    garbage the engine never reads)."""
    x = params["embed"][token]
    for l, lp in enumerate(_layers(params, cfg)):
        x = decode_layer(lp, cfg, x, cache, l, active)
    return _logits(params, cfg, x), cache._replace(
        pos=cache.pos + active.to(torch.int32))


def paged_to_dense(cache: SSMCache) -> SSMCache:
    """SSM state is already dense per slot.  The decode chunk updates its
    view in place, so the view is a copy: ``paged_restore`` then takes
    only the active rows back (the reference's view is the cache itself,
    its decode being functional)."""
    return SSMCache(conv=cache.conv.clone(), state=cache.state.clone(),
                    pos=cache.pos.clone())


def paged_restore(cache: SSMCache, dense: SSMCache, active,
                  steps) -> SSMCache:
    cache.conv.copy_(torch.where(active[None, :, None, None], dense.conv,
                                 cache.conv))
    cache.state.copy_(torch.where(active[None, :, None, None, None],
                                  dense.state, cache.state))
    return cache._replace(pos=cache.pos + steps * active.to(torch.int32))
