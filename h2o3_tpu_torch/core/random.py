"""Counter-based random numbers: Threefry-2x32 as JAX draws it with
``jax_threefry_partitionable`` on (counterpart of the three
``jax.random`` draws of the tree builders: h2o3_tpu/models/tree/
shared_tree.py:54 and :681, drf.py:39).

A key is a pair of 32-bit words. ``PRNGKey(seed)`` is (seed >> 32,
seed & 0xFFFFFFFF), ``fold_in(key, t)`` hashes the counter pair (0, t)
under `key`, and ``uniform(key, shape)`` hashes the flat index i of each
element as the counter pair (i >> 32, i & 0xFFFFFFFF), XORs the two output
words and builds an f32 in [0, 1) from its top 23 bits. Element i depends
on i alone, not on the shape, so a draw over n rows is the first n values
of a draw over any padded length.

Words are int64 tensors holding values in [0, 2**32), on whatever device
the caller gives.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 block function: key words (k0, k1)
    (ints), counter words x0, x1 (int64 tensors in [0, 2**32)) -> the two
    output words."""
    ks = (int(k0) & _MASK, int(k1) & _MASK,
          (int(k0) ^ int(k1) ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int):
    """The key of an integer seed, as a (2,) int64 CPU tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64)


def fold_in(key: torch.Tensor, t: int) -> torch.Tensor:
    """A new key from `key` and the integer `t`."""
    k0, k1 = (int(v) for v in key.tolist())
    t = int(t)
    hi = torch.tensor([(t >> 32) & _MASK], dtype=torch.int64)
    lo = torch.tensor([t & _MASK], dtype=torch.int64)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.cat([y0, y1])


def random_bits(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """(n,) 32-bit words (int64) of the flat counters 0..n-1."""
    k0, k1 = (int(v) for v in key.tolist())
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of `shape`: (bits >> 9 | 0x3F800000) read
    as a float in [1, 2), minus 1."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = random_bits(key, math.prod(shape), device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).reshape(shape)
