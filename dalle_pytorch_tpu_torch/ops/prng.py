"""Threefry-2x32 counter-based random bits, as ``jax.random`` computes them.

Port of what the sampler uses from JAX's own PRNG (``jax/_src/prng.py``
and ``jax/_src/random.py``, jax 0.9 with the default
``jax_threefry_partitionable=True``):

* ``threefry2x32`` — the 20-round Threefry-2x32 block function;
* ``prng_key(seed)`` — ``PRNGKey``: a 32-bit seed becomes ``[0, seed]``
  (JAX keeps only the low 32 bits of wider Python ints);
* ``fold_in(key, data)`` — ``threefry_2x32(key, [0, data])``;
* ``random_bits`` — the partitionable layout: element ``i`` of the
  flat output hashes the counter pair ``(i >> 32, i & 0xffffffff)``
  and returns the XOR of the two output words;
* ``uniform``, ``gumbel`` and ``categorical`` (``argmax(gumbel +
  logits)``, first maximum on ties, as ``jnp.argmax``).

The bits, keys and uniforms are bit-equal to JAX's. The Gumbel noise
agrees to within an ulp or two, because XLA's CPU ``log`` is not
correctly rounded and torch's is; a draw can therefore differ only
where two noisy logits tie to within ~1e-6, which the tests never see.
That makes a sampled token a pure function of ``(logits, fold_in(key,
pos))`` — identical to the JAX engine's at the same seed — and keeps the
replay contract (an evicted or replayed request re-samples exactly the
same tokens).

torch has little uint32 arithmetic, so words are carried as int64
holding values in ``[0, 2**32)`` and masked after every add and shift.
Keys are ``(..., 2)`` int64 tensors; everything is batched over leading
axes and stays on the keys' device — no host sync per token.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 on broadcastable int64 words; returns the two output
    words (``prng._threefry2x32_lowering``)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int or an int tensor of
    seeds: ``(..., 2)`` int64 ``[0, seed & 0xffffffff]``."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, batched: key (..., 2), data (...) ints."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words of ``shape`` for every key in ``key``'s
    leading axes: (..., *shape) int64 in [0, 2**32)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval) (``random._uniform``): the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard Gumbel noise (``random._gumbel``, mode 'low')."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per key over the last axis of float32 ``logits``
    (key (..., 2), logits (..., V)) — ``jax.random.categorical``. JAX
    draws the noise in the logits' dtype; the engine's logits are f32
    after the per-slot temperature divide, and only that is ported."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
