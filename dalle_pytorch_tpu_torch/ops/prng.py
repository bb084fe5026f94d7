"""Threefry-2x32 counter-based random bits, as ``jax.random`` computes them.

Port of what the sampler uses from JAX's own PRNG (``jax/_src/prng.py``
and ``jax/_src/random.py``, jax 0.9 with the default
``jax_threefry_partitionable=True``):

* ``threefry2x32`` — the 20-round Threefry-2x32 block function;
* ``prng_key(seed)`` — ``PRNGKey``: a 32-bit seed becomes ``[0, seed]``
  (JAX keeps only the low 32 bits of wider Python ints);
* ``fold_in(key, data)`` — ``threefry_2x32(key, [0, data])``;
* ``split(key, shape)`` — the fold-like split: key ``i`` of the flat
  output is the two words of ``threefry_2x32(key, (i >> 32, i &
  0xffffffff))``, not XORed;
* ``random_bits`` — the partitionable layout: element ``i`` of the
  flat output hashes the counter pair ``(i >> 32, i & 0xffffffff)``
  and returns the XOR of the two output words; narrower draws keep its
  low bits (``convert_element_type`` of the word), one counter each;
* ``uniform`` in float32 (the top 23 of 32 bits as the mantissa) or
  bfloat16 (JAX draws 8 bits for a type with fewer than 8 mantissa
  bits, and keeps the top 7 of them: ``random._uniform``),
  ``bernoulli`` (``uniform < p`` in float32), ``gumbel`` (mode 'low')
  and ``categorical`` (``argmax(gumbel + logits)`` in the logits'
  dtype, first maximum on ties, as ``jnp.argmax``).

The bits, keys and uniforms are bit-equal to JAX's. The float32 Gumbel
noise agrees to within an ulp or two, because XLA's CPU ``log`` is not
correctly rounded and torch's is; a draw can therefore differ only
where two noisy logits tie to within ~1e-6, which the tests never see.
The bfloat16 noise rounds each ``log`` to bfloat16, as XLA does.
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

import contextlib
import math
import numbers
import threading
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
    if isinstance(seed, numbers.Integral):      # a fill, no host copy
        seed = torch.full((), int(seed), dtype=torch.int64, device=device)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, batched: key (..., 2), data (...) ints. A
    Python int is filled on the key's device (a kernel argument, no host
    copy)."""
    if isinstance(data, numbers.Integral):
        data = torch.full((), int(data), dtype=torch.int64,
                          device=key.device)
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def _hash_counters(key: torch.Tensor, shape: Sequence[int],
                   offset: int = 0, cols=None):
    """Both threefry output words for the flat counters of ``shape``,
    for every key in ``key``'s leading axes: (..., *shape) each. The
    counters are ``offset + arange(prod(shape))``: a draw of a slice of
    rows of a larger array starts at the slice's first flat index, and
    equals that slice of the whole array's draw. ``cols=(c0, width)``
    says the last axis is columns ``c0 ..`` of a ``width``-wide last
    axis (a tensor-parallel rank's columns of a hidden layer): each
    row's counters then step by ``width``, and the draw is those columns
    of the whole draw."""
    shape = tuple(int(s) for s in shape)
    if cols is None:
        n = math.prod(shape)
        idx = torch.arange(offset, offset + n, dtype=torch.int64,
                           device=key.device).reshape(shape)
    else:
        c0, width = (int(c) for c in cols)
        rows = torch.arange(math.prod(shape[:-1]), dtype=torch.int64,
                            device=key.device)[:, None]
        idx = (offset + c0 + rows * width + torch.arange(
            shape[-1], dtype=torch.int64, device=key.device)).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, idx >> 32, idx & _MASK)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                bit_width: int = 32, offset: int = 0,
                cols=None) -> torch.Tensor:
    """``bit_width``-bit random words (8, 16 or 32) of ``shape`` for every
    key in ``key``'s leading axes: (..., *shape) int64 in
    [0, 2**bit_width), the low bits of the 32-bit word. ``offset`` is the
    first flat counter and ``cols`` a column window
    (``_hash_counters``)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    b0, b1 = _hash_counters(key, shape, offset, cols)
    return (b0 ^ b1) & ((1 << bit_width) - 1)


def split(key: torch.Tensor, shape=2) -> torch.Tensor:
    """``jax.random.split(key, shape)``: (..., *shape, 2) keys."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    b0, b1 = _hash_counters(key, shape)
    return torch.stack([b0, b1], dim=-1)


# dtype -> (bits drawn, mantissa bits, the bits of 1.0, the int view)
_UNIFORM = {torch.float32: (32, 23, 0x3F800000, torch.int32),
            torch.bfloat16: (8, 7, 0x3F80, torch.int16)}


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32,
            offset: int = 0, cols=None) -> torch.Tensor:
    """Uniform in [minval, maxval) in float32 or bfloat16
    (``random._uniform``): the top mantissa-width bits of the draw become
    the mantissa of a float in [1, 2), minus 1, all in ``dtype``."""
    if dtype not in _UNIFORM:
        raise TypeError(f"uniform takes float32 or bfloat16, got {dtype}")
    width, nmant, one, view = _UNIFORM[dtype]
    bits = random_bits(key, shape, width, offset, cols)
    fbits = ((bits >> (width - nmant)) | one).to(view)
    floats = fbits.view(dtype) - 1.0
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int],
              offset: int = 0, cols=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool, True with
    probability ``p`` (a float32 uniform below float32 ``p``)."""
    pf = torch.full((), p, dtype=torch.float32, device=key.device)
    return uniform(key, shape, offset=offset, cols=cols) < pf


def gumbel(key: torch.Tensor, shape: Sequence[int], dtype=torch.float32,
           offset: int = 0) -> torch.Tensor:
    """Standard Gumbel noise in float32 or bfloat16 (``random._gumbel``,
    mode 'low'), every step in ``dtype``."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, dtype,
                                         offset)))


# the first global batch row of the rows this thread's batch draws hold
_ROWS = threading.local()


@contextlib.contextmanager
def batch_rows(start: int):
    """Inside, a draw of a batch-leading shape made through
    ``row_offset`` (dropout, the VAE's Gumbel noise, the caption drop,
    ``categorical`` under one key) is rows ``start ..`` of the draw for
    the whole batch: a data-parallel rank holding those rows draws
    exactly its part of the one-device draw, as JAX's data-parallel step
    (and its sampler over a dp-sharded candidate batch) does: it draws
    for the global shape and shards it."""
    prev = getattr(_ROWS, "start", 0)
    _ROWS.start = int(start)
    try:
        yield
    finally:
        _ROWS.start = prev


def row_offset(shape: Sequence[int]) -> int:
    """The first flat counter of a batch-leading ``shape`` under
    ``batch_rows`` (0 outside it)."""
    start = getattr(_ROWS, "start", 0)
    return start * math.prod(int(s) for s in tuple(shape)[1:]) if start \
        else 0


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32 or
    bfloat16 ``logits``: ``argmax(gumbel + logits)`` with the noise in
    the logits' dtype. ``key``'s leading axes are batch axes over the
    logits' leading axes, each key drawing noise of the rest of the
    shape: one key (2,) draws noise of the logits' full shape, as one
    JAX call over a (rows, V) batch does (``generate_images``; under
    ``batch_rows`` these rows of the whole batch's draw); keys
    (b, 2) over (b, V) logits draw a (V,) row each, as ``vmap`` of the
    call does (the engine's per-slot sampling)."""
    lead = key.dim() - 1
    if logits.shape[:lead] != key.shape[:-1]:
        raise ValueError(f"keys {tuple(key.shape)} do not lead logits "
                         f"{tuple(logits.shape)}")
    shape = logits.shape[lead:]
    g = gumbel(key, shape, logits.dtype,
               offset=row_offset(shape) if lead == 0 else 0)
    return torch.argmax(g + logits, dim=-1)
