"""Multi-head attention: parameters, head layout, projections, dense math.

Port of ``dalle_pytorch_tpu/ops/attention.py`` (``:37-113``): a fused
bias-free qkv projection, the scale the caller passes (``dim ** -0.5``
under the reference's ``scale_mode='dim'``, not ``dim_head ** -0.5``),
pad masking with the finite ``-finfo.max`` fill and the causal mask
with ``-inf``, then merge heads and the biased output projection.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops import core


class Attention(nn.Module):
    """PreNorm attention parameters: ``ln``, fused ``qkv`` (no bias) and
    ``out`` (with bias) — the JAX ``layer_params["attn"]`` subtree."""

    def __init__(self, dim: int, heads: int, dim_head: int, *,
                 device=None, dtype=None):
        super().__init__()
        inner = heads * dim_head
        kw = dict(device=device, dtype=dtype)
        self.ln = nn.LayerNorm(dim, **kw)
        self.qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.out = nn.Linear(inner, dim, **kw)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, n, h*d) -> (b, h, n, d)"""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) -> (b, n, h*d)"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def qkv_project(p: Attention, x: torch.Tensor, heads: int):
    q, k, v = core.linear(p.qkv, x).chunk(3, dim=-1)
    return split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)


def dense_attention_weights(q: torch.Tensor, k: torch.Tensor, scale: float,
                            mask: Optional[torch.Tensor],
                            causal: bool) -> torch.Tensor:
    """Masked softmax weights with queries end-aligned against the keys
    (``attention.dense_attention_weights`` with ``offset=None``)."""
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    n_q, n_k = dots.shape[-2], dots.shape[-1]
    row0 = n_k - n_q
    if mask is not None:
        q_mask = mask[:, row0:row0 + n_q] if mask.shape[1] != n_q else mask
        pair = q_mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, core.neg_inf(dots.dtype))
    if causal:
        rows = torch.arange(n_q, device=dots.device)[:, None] + row0
        cols = torch.arange(n_k, device=dots.device)[None, :]
        dots = dots.masked_fill(cols > rows, float("-inf"))
    return torch.softmax(dots, dim=-1)


def output_tail(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """merge heads -> out projection (eval mode: no dropout)."""
    return core.linear(p.out, merge_heads(out))


def attention_apply(p: Attention, x: torch.Tensor, *, heads: int,
                    scale: float, causal: bool,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qkv proj -> dense attention -> out proj (``attention_apply`` with
    ``impl='xla'``; the flash kernel K1 is a later slice)."""
    q, k, v = qkv_project(p, x, heads)
    attn = dense_attention_weights(q, k, scale, mask, causal)
    return output_tail(p, torch.einsum("bhij,bhjd->bhid", attn, v))
