"""Multi-head attention: parameters, head layout, projections, dense math.

Port of ``dalle_pytorch_tpu/ops/attention.py`` (``:37-144``): a fused
bias-free qkv projection, the scale the caller passes (``dim ** -0.5``
under the reference's ``scale_mode='dim'``, not ``dim_head ** -0.5``),
pad masking with the finite ``-finfo.max`` fill and the causal mask
with ``-inf``, then merge heads, the biased output projection and, in
train mode, dropout on its output (not on the attention weights, so the
flash kernels take no random numbers).

``impl`` selects the attention: ``'xla'`` the dense einsum here,
``'flash'`` the flash kernels (``ops/flash_attention.py``, K1 forward
and the backward ``bwd_impl`` names).

Under tensor parallelism (``Attention.tp``, set by
``parallel/train.py::setup_sharded``) a rank holds heads ``[r h/tp,
(r+1) h/tp)``: its rows of each third of ``qkv`` and the matching
columns of ``out``. ``qkv_project`` then yields the rank's heads, the
attention (K1-K3 included) runs on them alone, and ``output_tail`` sums
the row-parallel product over ``tp`` before it adds the bias, once.
Dropout acts after that sum, on the whole output, drawn alike on every
rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import flash_attention as flash_ops
from dalle_pytorch_tpu_torch.parallel import collectives as col


class Attention(nn.Module):
    """PreNorm attention parameters: ``ln``, fused ``qkv`` (no bias) and
    ``out`` (with bias) — the JAX ``layer_params["attn"]`` subtree;
    ``tp`` the group its heads are split over (None: all heads here)."""

    tp = None

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


def local_heads(p: Attention, heads: int) -> int:
    """The heads this rank runs: ``heads / tp``."""
    tp = p.tp or col.SELF
    if heads % tp.size:
        raise ValueError(f"{heads} heads do not split over tensor "
                         f"parallelism {tp.size}")
    return heads // tp.size


def qkv_project(p: Attention, x: torch.Tensor, heads: int):
    """(q, k, v), each (b, h, n, d) for this rank's heads."""
    heads = local_heads(p, heads)
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


def output_tail(p: Attention, out: torch.Tensor, *,
                dropout_rate: float = 0.0,
                dropout_key: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
    """merge heads -> out projection -> dropout (train mode only). Over a
    ``tp`` group the product of this rank's heads is summed over the
    group (``row_parallel``), then the bias is added."""
    tp = p.tp or col.SELF
    if tp.size == 1:
        out = core.linear(p.out, merge_heads(out))
    else:
        out = row_parallel(p.out, merge_heads(out), tp)
    return core.dropout(dropout_key, out, dropout_rate, train)


def row_parallel(p: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """``core.linear`` of a row-parallel linear over ``tp``: this rank's
    columns of the product, summed over the group in float32, plus the
    bias, rounded to x's dtype once (as the one-process product rounds
    once)."""
    y = col.psum(F.linear(x, p.weight.to(x.dtype)).float(), tp)
    return (y + p.bias.float()).to(x.dtype)


def attention_apply(p: Attention, x: torch.Tensor, *, heads: int,
                    scale: float, causal: bool,
                    mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_key: Optional[torch.Tensor] = None,
                    train: bool = False, impl: str = "xla",
                    bwd_impl: str = "xla", block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """qkv proj -> attention -> out proj (+ dropout). ``bwd_impl`` and
    ``block_q``/``block_k`` reach the flash path only."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}; expected 'xla' "
                         f"or 'flash'")
    q, k, v = qkv_project(p, x, heads)
    if impl == "flash":
        out = flash_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
            causal=causal, mask=mask, bwd_impl=bwd_impl, block_q=block_q,
            block_k=block_k)
    else:
        attn = dense_attention_weights(q, k, scale, mask, causal)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
    return output_tail(p, out, dropout_rate=dropout_rate,
                       dropout_key=dropout_key, train=train)
