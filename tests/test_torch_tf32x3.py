"""Why the port's float32 flash bodies take three TF32 products, on the
CPU: the numerics of ``csrc/flash_attention.cu``'s float32 K1 and K2b
(split and fused) emulated here, against the JAX package's float32
flash attention (``dalle_pytorch_tpu/ops/flash_attention.py``, its Pallas
kernels in interpret mode, as its own tests run them).

The card's TF32 products take 10 mantissa bits of each operand
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero) and sum in
f32. The bodies split each operand x into hi = tf32(x) and lo = tf32(x -
hi) and take a b as a_hi b_hi + a_hi b_lo + a_lo b_hi. Emulated with
integer bit arithmetic on f32 tensors (products of two TF32 values are
exact in f32, so an f32 matmul of them is the tensor core's product up
to summation order), attention forward and backward with those products
stay within 1e-5 of the largest output magnitude of JAX's f32 result, at
b 2, h 2, n 200, d 64, causal, with and without a pad mask; and their
error is at least 50x smaller than with one TF32 product a product, the
error the bodies would have with one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import flash_attention as JF

FILL = -3.0e38
B, H, N, D = 2, 2, 200, 64
SCALE = D ** -0.5
OUTPUTS = ("out", "dq", "dk", "dv")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on an f32 tensor: the magnitude rounded to 10
    mantissa bits, half away from zero (add half of the 13 dropped bits'
    weight to the bit pattern, then clear them; a carry rounds into the
    exponent, as it should)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the bodies take it: a_hi b_hi + a_hi b_lo + a_lo b_hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def attention(q, k, v, dout, mask, mm):
    """out, dq, dk, dv of causal attention under the kernels' masking
    contract (pad pairs score FILL, causal pairs are left out, a zero l
    becomes 1, ds zeroed where the fill replaced the score), every
    product taken by ``mm``."""
    n = q.shape[2]
    s = mm(q, k.transpose(-1, -2)) * SCALE
    live = None
    if mask is not None:
        live = (mask[:, :, None] & mask[:, None, :])[:, None]
        s = torch.where(live, s, FILL)
    future = torch.ones((n, n), dtype=torch.bool).triu(1)
    s = s.masked_fill(future, float("-inf"))
    m = torch.clamp(s.amax(-1), min=FILL)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    l = torch.where(l == 0, 1.0, l)
    out = mm(p, v) / l[..., None]
    p = p / l[..., None]
    dstat = (dout * out).sum(-1)
    dp = mm(dout, v.transpose(-1, -2))
    ds = p * (dp - dstat[..., None]) * SCALE
    if live is not None:
        ds = torch.where(live, ds, 0.0)
    dq = mm(ds, k)
    dk = mm(ds.transpose(-1, -2), q)
    dv = mm(p.transpose(-1, -2), dout)
    return dict(zip(OUTPUTS, (out, dq, dk, dv)))


def inputs(mask_kind: str):
    rs = np.random.RandomState(24)
    q, k, v, dout = (rs.randn(B, H, N, D).astype(np.float32)
                     for _ in range(4))
    mask = None
    if mask_kind == "pad":
        mask = np.ones((B, N), bool)
        mask[0, 1:40] = False          # a caption of one token
        mask[1, 20:40] = False
    return q, k, v, dout, mask


@functools.lru_cache(maxsize=None)
def jax_reference(mask_kind: str) -> dict:
    """JAX's f32 out and gradients (the Pallas forward and split
    backward, interpreted on the CPU)."""
    q, k, v, dout, mask = inputs(mask_kind)
    jm = None if mask is None else jnp.asarray(mask)

    def fwd(q, k, v):
        return JF.flash_attention(q, k, v, scale=SCALE, causal=True,
                                  mask=jm, bwd_impl="pallas")

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(dout))
    return {name: np.asarray(x, np.float64)
            for name, x in zip(OUTPUTS, (out, dq, dk, dv))}


@functools.lru_cache(maxsize=None)
def emulated(mask_kind: str, products: int) -> dict:
    q, k, v, dout, mask = inputs(mask_kind)
    got = attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                    torch.tensor(dout),
                    None if mask is None else torch.tensor(mask),
                    mm3 if products == 3 else mm1)
    return {name: x.double().numpy() for name, x in got.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tf32_rounds_to_nearest_ties_away_keeping_10_bits():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32's ulp at 1
    x = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0e38, 1.5 * 2.0 ** -130, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one, one + ulp, one + ulp, -(one + ulp),
                         float(tf32(torch.tensor([3.0e38]))), 1.5 *
                         2.0 ** -130, 0.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    # hi + lo keeps x to 2^-21 of it; hi alone only to 2^-11
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(10000).astype(np.float32) *
                     10.0 ** rs.uniform(-6, 6, 10000).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) < 2.0 ** -21
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("mask_kind", ["none", "pad"])
def test_three_tf32_products_hold_jax_f32_attention(mask_kind, output):
    ref = jax_reference(mask_kind)[output]
    scale = float(np.abs(ref).max())
    err3 = float(np.abs(emulated(mask_kind, 3)[output] - ref).max())
    err1 = float(np.abs(emulated(mask_kind, 1)[output] - ref).max())
    assert err3 <= 1e-5 * scale, (err3, scale)
    assert err1 >= 50 * err3, (err1, err3)
