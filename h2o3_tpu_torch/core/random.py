"""Counter-based random numbers: Threefry-2x32 as JAX draws it with
``jax_threefry_partitionable`` on (counterpart of the ``jax.random``
draws of the tree builders, h2o3_tpu/models/tree/shared_tree.py:54 and
:681, drf.py:39, of DeepLearning, deeplearning.py:62-72 and :362-363,
and of Word2Vec, word2vec.py:243-245).

A key is a pair of 32-bit words. ``PRNGKey(seed)`` is (seed >> 32,
seed & 0xFFFFFFFF), ``fold_in(key, t)`` hashes the counter pair (0, t)
under `key`, and ``split(key, n)`` gives key i = the hash of (0, i), so
``split(key, n)[i] == fold_in(key, i)``. ``uniform(key, shape)`` hashes
the flat index i of each element as the counter pair (i >> 32,
i & 0xFFFFFFFF), XORs the two output words and builds an f32 in [0, 1)
from its top 23 bits. Element i depends on i alone, not on the shape,
so a draw over n rows is the first n values of a draw over any padded
length. ``bernoulli`` is ``uniform < float32(p)``; ``randint`` is
jax.random's ``_randint``: it splits the key in two, draws two words per
element and folds them into [minval, maxval) with uint32 arithmetic.
``choice_p`` is ``jax.random.choice`` with replacement and weights p:
the float32 cumulative sum of p times (1 - uniform), searched for in
that cumulative sum; ``cumsum_f32`` sums p in the order ``jnp.cumsum``
does on XLA's CPU backend, so the draws follow the reference's bit for
bit wherever the sum is computed once on the host.

Words are int64 tensors holding values in [0, 2**32), on whatever device
the caller gives. A key is a (2,) tensor, or a (..., 2) batch of keys:
every draw then has the batch's leading shape, and draws of different
keys never mix, so one call makes a whole epoch's draws on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 block function: key words (k0, k1)
    (ints, or int64 tensors broadcastable against the counters), counter
    words x0, x1 (int64 tensors in [0, 2**32)) -> the two output
    words."""
    if not torch.is_tensor(k0):
        k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & _MASK)
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


def _key_words(key: torch.Tensor, device):
    """A single key's words as ints; a batch's as (..., 1) tensors on
    `device`, to broadcast against the draw's flat counters."""
    if key.dim() == 1:
        k0, k1 = (int(v) for v in key.tolist())
        return k0, k1
    k = key.to(device)
    return k[..., 0:1], k[..., 1:2]


def fold_in(key: torch.Tensor, t: int) -> torch.Tensor:
    """A new key from `key` and the integer `t`."""
    t = int(t)
    hi = torch.tensor([(t >> 32) & _MASK], dtype=torch.int64)
    lo = torch.tensor([t & _MASK], dtype=torch.int64)
    if key.dim() > 1:
        hi, lo = hi.to(key.device), lo.to(key.device)
    k0, k1 = _key_words(key, key.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([y0, y1], dim=-1).reshape(key.shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys: (num, 2) from a (2,) key, (..., num, 2) from a
    batch."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = _key_words(key, key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32-bit words (int64) of the flat counters 0..prod(shape)-1, shaped
    key.shape[:-1] + shape."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    if key.dim() > 1 and device is None:
        device = key.device
    i = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = _key_words(key, device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """(bits >> 9 | 0x3F800000) read as a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of `shape` (after the key batch's axes)."""
    return _bits_to_unit(random_bits(key, shape, device))


def bernoulli(key: torch.Tensor, p: float, shape, device=None
              ) -> torch.Tensor:
    """Booleans that are True with chance p: uniform < p, p rounded to
    float32 first (jax.random.bernoulli's mode 'low')."""
    u = uniform(key, shape, device)
    return u < torch.tensor(float(p), dtype=torch.float32, device=u.device)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval) (jax.random.randint, int32): two
    words per element, hi from split(key)[0] and lo from split(key)[1],
    folded as ((hi % span) * mult + lo % span) % span with mult as below,
    every product and sum wrapped to uint32."""
    minval, maxval = int(minval), int(maxval)
    k12 = split(key, 2)
    if key.dim() > 1 and device is None:
        device = key.device
    hi = random_bits(k12[..., 0, :], shape, device)
    lo = random_bits(k12[..., 1, :], shape, device)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    # 2**nbits % span as jax computes it: (2**16 % span)**2 % span, the
    # square wrapped to uint32 (so 0 whenever span > 2**16)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)


def cumsum_f32(p) -> np.ndarray:
    """Inclusive float32 cumulative sum of a vector in the order of
    XLA's CPU lowering of ``jnp.cumsum``: up to 16 values are summed in
    turn; longer vectors are cut into rows of 16 summed in turn, and
    each row then adds the (recursively computed) sum of the rows before
    it."""
    x = np.asarray(p, np.float32)
    n = len(x)
    if n <= 16:
        return np.cumsum(x, dtype=np.float32)
    m = -(-n // 16)
    rows = np.zeros(m * 16, np.float32)
    rows[:n] = x
    inner = np.cumsum(rows.reshape(m, 16), axis=1, dtype=np.float32)
    before = np.concatenate([np.zeros(1, np.float32),
                             cumsum_f32(inner[:, -1])[:-1]])
    return (inner + before[:, None]).ravel()[:n]


def choice_p(key: torch.Tensor, shape, p_cuml: torch.Tensor,
             device=None) -> torch.Tensor:
    """int64 draws in [0, len(p)) with chance p (jax.random.choice with
    replacement), given p's float32 cumulative sum `p_cuml` on the draw's
    device: the first index whose cumulative sum reaches
    p_cuml[-1] * (1 - uniform)."""
    u = uniform(key, shape, device)
    return torch.searchsorted(p_cuml, p_cuml[-1] * (1.0 - u))
