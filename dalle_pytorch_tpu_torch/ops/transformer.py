"""Transformer stack: PreNorm(attention) + PreNorm(GEGLU feed-forward).

Port of ``dalle_pytorch_tpu/ops/transformer.py``, sequential engine
only: ``TransformerConfig``, per-layer modules in place of the JAX
depth-stacked pytree (``compat/from_jax.py`` unstacks it), the GEGLU
``ff_branch`` with dense layers, and the forward of the stack in eval
mode (no dropout). Reversible blocks, Mixture-of-Experts, block-sparse
layers and rematerialisation are later slices; a config asking for
them raises ``NotImplementedError`` instead of silently running a
different model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import core


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int
    depth: int
    seq_len: int
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    causal: bool = True
    reversible: bool = False
    sparse_attn: Union[bool, Tuple[bool, ...]] = False
    moe_experts: int = 0
    # reference uses dim**-0.5 (transformer.py:57); 'head' gives dim_head**-0.5
    scale_mode: str = "dim"

    def __post_init__(self):
        if self.reversible:
            raise NotImplementedError(
                "reversible blocks are a later slice of the port "
                "(ROADMAP.md, training)")
        if self.moe_experts:
            raise NotImplementedError(
                "Mixture-of-Experts layers are a later slice of the port")
        if any(self.sparse_pattern):
            raise NotImplementedError(
                "block-sparse layers (kernel K3) are a later slice of the "
                "port")
        if self.scale_mode not in ("dim", "head"):
            raise ValueError(f"scale_mode must be 'dim' or 'head', got "
                             f"{self.scale_mode!r}")

    @property
    def sparse_pattern(self) -> Tuple[bool, ...]:
        if isinstance(self.sparse_attn, bool):
            return (self.sparse_attn,) * self.depth
        return tuple(self.sparse_attn)

    @property
    def scale(self) -> float:
        base = self.dim if self.scale_mode == "dim" else self.dim_head
        return base ** -0.5


class FeedForward(nn.Module):
    """PreNorm GEGLU parameters: ``ln``, ``w1`` (dim -> 2*hidden),
    ``w2`` (hidden -> dim) — the JAX ``layer_params["ff"]`` subtree."""

    def __init__(self, dim: int, mult: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = nn.LayerNorm(dim, **kw)
        self.w1 = nn.Linear(dim, dim * mult * 2, **kw)
        self.w2 = nn.Linear(dim * mult, dim, **kw)


class Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.attn = attn_ops.Attention(cfg.dim, cfg.heads, cfg.dim_head,
                                       device=device, dtype=dtype)
        self.ff = FeedForward(cfg.dim, cfg.ff_mult, device=device,
                              dtype=dtype)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(cfg, device=device, dtype=dtype) for _ in range(cfg.depth))


def ff_branch(layer: Layer, x: torch.Tensor) -> torch.Tensor:
    """PreNorm GEGLU feed-forward (``transformer.ff_branch``)."""
    p = layer.ff
    h = core.linear(p.w1, core.layernorm(p.ln, x))
    h, gates = h.chunk(2, dim=-1)
    return core.linear(p.w2, h * core.gelu(gates))


def attn_branch(layer: Layer, x: torch.Tensor, mask: Optional[torch.Tensor],
                cfg: TransformerConfig) -> torch.Tensor:
    p = layer.attn
    return attn_ops.attention_apply(p, core.layernorm(p.ln, x),
                                    heads=cfg.heads, scale=cfg.scale,
                                    causal=cfg.causal, mask=mask)


def transformer_apply(model: Transformer, x: torch.Tensor, *,
                      cfg: TransformerConfig,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the stack. x: (b, n, dim); mask: (b, n) bool (True = keep)."""
    for layer in model.layers:
        x = x + attn_branch(layer, x, mask, cfg)
        x = x + ff_branch(layer, x)
    return x
