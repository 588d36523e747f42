"""Threefry-2x32 and the four ``jax.random`` draws the token stream makes,
in torch, equal to JAX's bit for bit on any device.

The reference draws its synthetic batches with ``jax.random``'s default
PRNG, threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011), in the mode ``jax_threefry_partitionable = True``
(the default of the JAX the reference runs under): random bits and key
splits hash each element's 64-bit linear index as a counter (hi, lo),
and 32-bit bits are the xor of the hash's two words.

A key is a (2,) int64 tensor holding two uint32 words.  Every uint32
value lives in int64 and is masked with ``& 0xFFFFFFFF`` after each add,
multiply and shift: torch's ``uint32`` has no arithmetic kernels on CUDA.

* :func:`prng_key` — ``jax.random.PRNGKey(seed)`` for an int32 seed;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``;
* :func:`split` — ``jax.random.split(key, num)``;
* :func:`random_bits` — 32 random bits an element;
* :func:`randint` — ``jax.random.randint(key, shape, minval, maxval)``,
  int32, with JAX's modulo arithmetic over two words of bits (and its
  wrap modulo 2^32);
* :func:`bernoulli` — ``jax.random.bernoulli(key, p, shape)``: a float32
  uniform from the top 23 bits, below ``p``.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry-2x32 hash of the counter words (x0, x1)
    under the key words (k0, k1); every argument an int64 tensor (or a
    0-dim one) of uint32 values.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed), with
    the seed an int32 as JAX's 32-bit mode holds it (so the high word is
    0, a right shift of an int32 by 32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit an int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    (0, data) under ``key``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], zero, zero + (data & MASK))
    return torch.stack([y0, y1])


def _iota_2x32(shape, device):
    """The (hi, lo) words of each element's row-major linear index."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the partitionable mode's: key i
    is the hash of the counter (0, i)): (num, 2)."""
    hi, lo = _iota_2x32((num,), key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element of ``shape`` (uint32 values in int64):
    the xor of the two words of each linear index's hash."""
    hi, lo = _iota_2x32(tuple(shape), key.device)
    y0, y1 = threefry2x32(key[0], key[1], hi, lo)
    return y0 ^ y1


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32:
    two words of bits from the key's two halves, each reduced modulo the
    span, combined as hi * (2^32 mod span) + lo modulo the span, with
    JAX's uint32 wraps (the multiplier's square, the product and the sum
    wrap modulo 2^32)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError("randint: bounds must fit an int32")
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    # JAX's 2^32 mod span as (2^16 mod span)^2 mod span in uint32: above
    # a span of 2^16 the square wraps to 0, and so does the multiplier
    multiplier = (((2 ** 16 % span) ** 2) & MASK) % span
    offset = ((higher % span) * multiplier) & MASK
    offset = ((offset + lower % span) & MASK) % span
    out = (minval + offset) & MASK       # int32 wrap, as uint32 bits
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 over [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < p (float32)."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
