"""Primitive ops: linear, layernorm, gelu, embedding, conv, the mask fill.

Port of ``dalle_pytorch_tpu/ops/core.py``. Parameters live in the
standard ``torch.nn`` modules (``nn.Linear`` weight ``(out, in)``,
``nn.Conv2d`` OIHW, ``nn.ConvTranspose2d`` IOHW, ``nn.Embedding``,
``nn.LayerNorm``), and these functions apply them with the JAX
package's numerics rather than the modules' own ``forward``:

* ``linear`` casts the weight to the activation dtype (``core.linear``);
  given an int8 ``ops/quant.py::QuantLinear`` it runs the JAX int8
  branch (``:64-66``): the int8 weight cast to the activation dtype,
  the product, then the per-output-channel scale in that dtype;
* ``layernorm`` normalises in f32 with eps 1e-5 and casts back
  (``core.layernorm``), where ``nn.LayerNorm`` would stay in bf16;
* ``gelu`` is the exact erf form (``core.gelu``);
* ``dropout`` draws its keep mask with the port's threefry, so a key
  drops the same elements as ``core.dropout`` under that key in JAX;
* the convolutions run NCHW; callers keep NHWC at their public
  functions (``models/vae.py``). ``conv2d_transpose`` with an IOHW
  weight equals the JAX flipped-kernel input-dilated convolution over
  the HWIO weight ``w[kh, kw, i, o] = W[i, o, kh, kw]`` — no flip is
  needed, because ``conv_transpose2d`` is already that adjoint
  (tests/test_torch_core.py pins it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.ops import prng


def linear(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w.T (+ b), in the activation dtype; ``p`` an ``nn.Linear``
    or an int8 ``QuantLinear`` (y = (x @ w_q.T) * scale (+ b))."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    if not hasattr(p, "w_q"):
        return F.linear(x, p.weight.to(x.dtype), b)
    y = F.linear(x, p.w_q.to(x.dtype)) * p.scale.to(x.dtype)
    return y if b is None else y + b


def layernorm(p: nn.LayerNorm, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.weight.float() + p.bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dropout(key, x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Inverted dropout (``core.dropout``): keep each element with
    probability ``1 - rate`` (``prng.bernoulli`` under ``key``) and scale
    the kept ones by ``1 / (1 - rate)``. The divisor is rounded to x's
    dtype first, as JAX rounds the weakly typed Python float."""
    if not train or rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = prng.bernoulli(key, keep, x.shape)
    div = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def embedding(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p.weight)


def conv2d(p: nn.Conv2d, x: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW input, OIHW weight."""
    return F.conv2d(x, p.weight.to(x.dtype), p.bias.to(x.dtype),
                    stride=stride, padding=padding)


def conv2d_transpose(p: nn.ConvTranspose2d, x: torch.Tensor, *,
                     stride: int = 2, padding: int = 1) -> torch.Tensor:
    """NCHW input, IOHW weight; out spatial = in * stride for k=4, s=2,
    p=1 (the dVAE upsample)."""
    return F.conv_transpose2d(x, p.weight.to(x.dtype), p.bias.to(x.dtype),
                              stride=stride, padding=padding)


def neg_inf(dtype: torch.dtype) -> float:
    """The reference's mask fill value, ``-finfo(dtype).max`` — finite,
    so a fully masked row still has a defined softmax."""
    return -torch.finfo(dtype).max


def _uniform_fan_in_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    torch.nn.init.uniform_(w, -bound, bound, generator=g)


@torch.no_grad()
def init_params_(module: nn.Module, g: torch.Generator) -> None:
    """Seeded random init in the JAX package's distribution families:
    U(±1/sqrt(fan_in)) for linears and convs, N(0, 1) for embeddings,
    ones/zeros for layernorms. Bitwise equality with a JAX init is not a
    goal (weights cross over through ``compat/from_jax.py``)."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            torch.nn.init.normal_(m.weight, generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            _uniform_fan_in_(m.weight, fan_in, g)
            if m.bias is not None:
                _uniform_fan_in_(m.bias, fan_in, g)
        elif isinstance(m, nn.ConvTranspose2d):
            # IOHW: the JAX HWIO init's fan-in is in_ch * kh * kw
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            _uniform_fan_in_(m.weight, fan_in, g)
            _uniform_fan_in_(m.bias, fan_in, g)
