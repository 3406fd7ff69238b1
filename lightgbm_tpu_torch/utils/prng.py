"""Threefry-2x32 keys and uniform draws, bit for bit those of ``jax.random``.

The JAX package draws the stochastic-rounding uniforms of every tree from
``fold_in(PRNGKey(seed), iteration * K + k)``, split into two keys, one
``uniform`` of f32 ``[R]`` each (``lightgbm_tpu/models/gbdt.py`` and
``core/grower.quantize_gradients``). This module computes the same bits
without JAX, following jax 0.9's threefry PRNG with
``jax_threefry_partitionable`` on (its default):

- a key is a pair of uint32 words; ``prng_key(seed)`` is
  ``(seed >> 32, seed & 0xffffffff)`` of the seed as a 32-bit integer,
  so ``(0, seed mod 2^32)``;
- ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under the
  key: the two output words are the new key;
- ``split(key, n)`` hashes the counters ``(0, i)``, ``i < n``: key i is
  the i-th output pair;
- ``uniform(key, shape)`` hashes ``(0, i)`` for every element i of the
  row-major flattened shape (``iota_2x32_shape``: the flat index split
  into a high and a low word, the high word 0 below 2^32 elements), xors
  the two output words, keeps the top 23 bits as an f32 mantissa in
  [1, 2) and subtracts 1; with ``minval`` it then computes
  ``max(minval, u * (1 - minval) + minval)`` in f32, as ``jax.random``'s
  ``_uniform`` does;
- ``gumbel(key, shape)`` is ``-log(-log(uniform(key, shape,
  minval=finfo(f32).tiny)))``, ``jax.random.gumbel``'s default ``"low"``
  mode. The uniforms are the JAX package's bit for bit; torch's ``log``
  may differ from XLA's in the last ulp (ROADMAP C1(a)).

Keys are plain Python ints (a few hashes per tree, on the host). The
``[n]`` draws are torch int64 tensors masked to 32 bits on the caller's
device, so a draw on the card never leaves it; the same code hashes
Python ints and tensors.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0,
    x1)`` under ``key``: Python ints or int64 tensors holding uint32
    values. Returns the two output words, of the same kind."""
    k0, k1 = key
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


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed={seed} does not fit 32 bits")
    return 0, seed & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def uniform(key: Key, shape: Union[int, Tuple[int, ...]], device=None,
            minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=minval)``: f32 in
    [minval, 1) on ``device``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    if not 0 <= n < (1 << 32):
        raise ValueError(f"{n} elements outside [0, 2^32)")
    counts = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, torch.zeros_like(counts), counts)
    mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
    u = (mantissa.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
    if minval:
        lo = torch.tensor(minval, dtype=torch.float32, device=device)
        u = torch.maximum(lo, u * (1.0 - lo) + lo)
    return u


def uniform_host(key: Key, n: int) -> np.ndarray:
    """``uniform(key, n)`` as a numpy f32 array, hashed with numpy on the
    host: the same bits, without a torch launch per hash step, for the
    few draws of a split (extra_trees)."""
    counts = np.arange(n, dtype=np.int64)
    b0, b1 = threefry2x32(key, np.zeros_like(counts), counts)
    mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
    return mantissa.astype(np.uint32).view(np.float32) - np.float32(1.0)


F32_TINY = torch.finfo(torch.float32).tiny


def gumbel(key: Key, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``, mode ``"low"``."""
    return -torch.log(-torch.log(uniform(key, shape, device,
                                         minval=F32_TINY)))
