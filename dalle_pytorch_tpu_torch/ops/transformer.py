"""Transformer stack: PreNorm(attention) + PreNorm(GEGLU feed-forward).

Port of ``dalle_pytorch_tpu/ops/transformer.py``, sequential engine
only: ``TransformerConfig``, per-layer modules in place of the JAX
depth-stacked pytree (``compat/from_jax.py`` unstacks it), the GEGLU
``ff_branch`` with dense layers, and the forward of the stack in eval
or train mode. In train mode each layer draws its two dropout keys from
``split(rng, (depth, 2))`` as ``_layer_keys`` does, so the masks are
JAX's bit for bit. ``attn_impl='flash'`` runs the flash kernels
(``ops/flash_attention.py``) with the backward ``attn_bwd_impl`` names.
Reversible blocks, Mixture-of-Experts, block-sparse layers and
rematerialisation are later slices; a config asking for them raises
``NotImplementedError`` instead of silently running a different model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import core, prng
from dalle_pytorch_tpu_torch.ops import flash_attention as flash_ops


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int
    depth: int
    seq_len: int
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    causal: bool = True
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    reversible: bool = False
    sparse_attn: Union[bool, Tuple[bool, ...]] = False
    attn_impl: str = "xla"      # 'xla' | 'flash'
    # flash backward: 'xla' blockwise loop | 'pallas' K2a + K2b split |
    # 'pallas_fused' K2b fused; only read with attn_impl='flash'
    attn_bwd_impl: str = "xla"
    # the JAX flash tile sizes; the CUDA kernels use their own tile, the
    # plain blockwise backward walks flash_block_k key columns at a time
    flash_block_q: int = 128
    flash_block_k: int = 128
    # reference uses dim**-0.5 (transformer.py:57); 'head' gives dim_head**-0.5
    scale_mode: str = "dim"
    remat: str = "none"
    moe_experts: int = 0

    def __post_init__(self):
        if self.attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention impl {self.attn_impl!r}; "
                             f"expected 'xla' or 'flash'")
        if self.attn_bwd_impl not in flash_ops.BWD_IMPLS:
            raise ValueError(f"unknown attn_bwd_impl "
                             f"{self.attn_bwd_impl!r}")
        if self.remat != "none":
            raise NotImplementedError(
                "remat other than 'none' is a later slice of the port "
                "(ROADMAP.md, training)")
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


def ff_branch(layer: Layer, x: torch.Tensor,
              cfg: Optional[TransformerConfig] = None,
              key: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
    """PreNorm GEGLU feed-forward (``transformer.ff_branch``), with
    ``cfg.ff_dropout`` on the gated hidden in train mode."""
    p = layer.ff
    h = core.linear(p.w1, core.layernorm(p.ln, x))
    h, gates = h.chunk(2, dim=-1)
    h = h * core.gelu(gates)
    if train:
        h = core.dropout(key, h, cfg.ff_dropout, train)
    return core.linear(p.w2, h)


def attn_branch(layer: Layer, x: torch.Tensor, mask: Optional[torch.Tensor],
                cfg: TransformerConfig, key: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
    p = layer.attn
    return attn_ops.attention_apply(
        p, core.layernorm(p.ln, x), heads=cfg.heads, scale=cfg.scale,
        causal=cfg.causal, mask=mask, dropout_rate=cfg.attn_dropout,
        dropout_key=key, train=train, impl=cfg.attn_impl,
        bwd_impl=cfg.attn_bwd_impl, block_q=cfg.flash_block_q,
        block_k=cfg.flash_block_k)


def _layer_keys(rng: Optional[torch.Tensor], depth: int,
                device) -> torch.Tensor:
    """(depth, 2, 2) keys: layer i's attention and feed-forward dropout
    keys, ``split(rng, (depth, 2))``."""
    if rng is None:
        rng = prng.prng_key(0, device=device)
    return prng.split(rng, (depth, 2))


def transformer_apply(model: Transformer, x: torch.Tensor, *,
                      cfg: TransformerConfig,
                      mask: Optional[torch.Tensor] = None,
                      rng: Optional[torch.Tensor] = None,
                      train: bool = False) -> torch.Tensor:
    """Run the stack. x: (b, n, dim); mask: (b, n) bool (True = keep);
    ``rng`` a (2,) key, needed when training with dropout."""
    if train and rng is None and (cfg.attn_dropout > 0
                                  or cfg.ff_dropout > 0):
        raise ValueError(
            "transformer_apply(train=True) with nonzero dropout needs an "
            "explicit `rng` key")
    keys = (_layer_keys(rng, cfg.depth, x.device) if train
            else [(None, None)] * cfg.depth)
    for layer, lkeys in zip(model.layers, keys):
        x = x + attn_branch(layer, x, mask, cfg, lkeys[0], train)
        x = x + ff_branch(layer, x, cfg, lkeys[1], train)
    return x
