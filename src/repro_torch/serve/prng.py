"""Threefry-2x32 random bits on torch tensors, bit for bit as ``jax.random``
computes them (jax 0.9.0, ``jax_threefry_partitionable`` on).

The reference's sampler draws its Gumbel noise from
``jax.random.uniform(fold_in(PRNGKey(seed), pos), (V,), minval=1e-20)``
(``repro/serve/sampling.py:83``).  This module mirrors the JAX functions
behind that call:

* ``threefry2x32``: ``_threefry2x32_lowering`` (``jax/_src/prng.py:883``):
  five groups of four Threefry rounds with the key schedule
  ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)``;
* ``prng_key``: ``_threefry_seed`` (``prng.py:815``): the key
  ``[seed >> 32 (logical), seed & 0xFFFFFFFF]``; an int32 seed's high word
  is 0 and a negative seed wraps to ``seed + 2**32``;
* ``fold_in``: ``threefry_fold_in`` (``prng.py:1163``):
  ``threefry_2x32(key, _threefry_seed(uint32(data)))``, i.e. the hash of
  the counter pair ``(0, data)``;
* ``random_bits``: ``_threefry_random_bits_partitionable``
  (``prng.py:1184``) at 32 bits: ``bits1 ^ bits2`` of the hash of the
  ``(hi, lo)`` words of the flat index (``iota_2x32_shape``);
* ``uniform``: ``_uniform`` (``jax/_src/random.py:435``): the top 23 bits
  as a mantissa under the exponent of 1.0, minus 1, times
  ``maxval - minval``, plus ``minval``, then ``max(minval, .)``;
* ``normal``: ``_normal_real`` (``jax/_src/random.py``) in float32: a
  uniform on ``[nextafter(-1, 0), 1)`` through ``sqrt(2) * erfinv(u)``.
  The uniforms are bit-exact; ``torch.erfinv`` and XLA's ``ErfInv``
  (a polynomial) may differ in the last ulps, so the normals agree to a
  few float32 ulps (``tests/test_torch_grad_compress.py`` holds 1e-6
  relative).

torch has no full uint32 arithmetic, so every word is an int64 tensor
holding a value in [0, 2**32), masked back to 32 bits after each add and
rotate.  Every function is batched over a tensor of keys (the leading
dimensions of a ``(..., 2)`` key tensor), so one call serves an (S,) batch
of lanes or an (S, n) verify grid, and runs on the keys' device: there is no
global generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1, k2):
    int64 tensors of 32-bit values, broadcast together -> (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seeds):
    """``jax.random.PRNGKey`` of each int32 seed: (...,) -> (..., 2) int64."""
    s = torch.as_tensor(seeds).long() & MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(keys, data):
    """``jax.random.fold_in`` of each key (..., 2) with each data word (...,)
    (an int32 position; a negative one wraps as uint32) -> (..., 2)."""
    d = torch.as_tensor(data, device=keys.device).long() & MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys, n):
    """32 random bits a value, ``jax.random.bits(key, (n,))`` for each key:
    (..., 2) -> (..., n) int64 in [0, 2**32)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(keys, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for each
    key: (..., 2) -> (..., n) float32."""
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


#: jax's lower bound of the normal's uniform: the float32 after -1
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(keys, n):
    """``jax.random.normal(key, (n,), float32)`` for each key: (..., 2) ->
    (..., n) float32 (reshape for a 2-D shape: jax draws it row-major)."""
    u = uniform(keys, n, minval=_NORMAL_LO, maxval=1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=keys.device) * torch.erfinv(u)
