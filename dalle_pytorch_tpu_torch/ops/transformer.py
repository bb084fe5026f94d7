"""Transformer stack: PreNorm(attention) + PreNorm(GEGLU feed-forward).

Port of ``dalle_pytorch_tpu/ops/transformer.py``, sequential engine
only: ``TransformerConfig``, per-layer modules in place of the JAX
depth-stacked pytree (``compat/from_jax.py`` unstacks it), the GEGLU
``ff_branch`` with dense layers, and the forward of the stack in eval
or train mode. In train mode each layer draws its two dropout keys from
``split(rng, (depth, 2))`` as ``_layer_keys`` does, so the masks are
JAX's bit for bit. ``attn_impl='flash'`` runs the flash kernels
(``ops/flash_attention.py``) with the backward ``attn_bwd_impl`` names.

Block-sparse layers (``sparse_attn``, a bool or one flag per layer) run
``sparse_impl``: ``'ref'`` the dense oracle and ``'windowed'`` the
structured path (``ops/sparse.py``), or ``'pallas'`` kernel K3
(``ops/block_sparse.py``); dense layers keep ``attn_impl``. A sparse
layer pads its sequence to a ``sparse_block`` multiple, masks the pad
keys and drops the pad rows (``attn_branch``, JAX ``:187-227``). The
layers run one after another, so the dense/sparse choice is a Python
bool per layer; ``_pattern_period`` and ``_MAX_UNROLL_PERIOD`` are kept
for the serving engine's sparse reads, which need a periodic pattern.
Reversible blocks, Mixture-of-Experts and rematerialisation are later
slices; a config asking for them raises ``NotImplementedError`` instead
of silently running a different model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import block_sparse as block_sparse_ops
from dalle_pytorch_tpu_torch.ops import core, prng
from dalle_pytorch_tpu_torch.ops import flash_attention as flash_ops
from dalle_pytorch_tpu_torch.ops import sparse as sparse_ops

SPARSE_IMPLS = ("ref", "windowed", "pallas")


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
    # per-layer dense/sparse selection: a bool or a tuple of len depth
    sparse_attn: Union[bool, Tuple[bool, ...]] = False
    sparse_block: int = 16
    attn_impl: str = "xla"      # 'xla' | 'flash'
    # flash backward: 'xla' blockwise loop | 'pallas' K2a + K2b split |
    # 'pallas_fused' K2b fused; only read with attn_impl='flash'
    attn_bwd_impl: str = "xla"
    # the JAX flash tile sizes; the CUDA kernels use their own tile, the
    # plain blockwise backward walks flash_block_k key columns at a time
    flash_block_q: int = 128
    flash_block_k: int = 128
    sparse_impl: str = "ref"    # 'ref' | 'windowed' | 'pallas'
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
        if self.sparse_impl not in SPARSE_IMPLS:
            raise ValueError(f"unknown sparse impl {self.sparse_impl!r}; "
                             f"expected one of {SPARSE_IMPLS}")
        if len(self.sparse_pattern) != self.depth:
            raise ValueError(f"sparse_attn has {len(self.sparse_pattern)} "
                             f"flags for depth {self.depth}")
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


def sparse_fn(p: attn_ops.Attention, h: torch.Tensor,
              mask: Optional[torch.Tensor], cfg: TransformerConfig,
              key: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
    """A block-sparse layer's attention on the normed input ``h``: pad to
    a ``sparse_block`` multiple, mask the pad keys, project, attend with
    ``cfg.sparse_impl``, drop the pad rows, then the output tail (the
    reference's SparseAttention padding contract)."""
    b, n, _ = h.shape
    block = cfg.sparse_block
    pad = (-n) % block
    kp_mask = mask
    if pad:
        h = torch.cat([h, h.new_zeros((b, pad, h.shape[2]))], dim=1)
        if kp_mask is None:
            kp_mask = torch.ones((b, n), dtype=torch.bool, device=h.device)
        kp_mask = torch.cat([kp_mask.bool(), kp_mask.new_zeros(
            (b, pad), dtype=torch.bool)], dim=1)
    q, k, v = attn_ops.qkv_project(p, h, cfg.heads)
    kw = dict(scale=cfg.scale, causal=cfg.causal, mask=kp_mask, block=block)
    if cfg.sparse_impl == "pallas":
        out = block_sparse_ops.block_sparse_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    elif cfg.sparse_impl == "windowed":
        out = sparse_ops.sparse_attention_windowed(q, k, v, **kw)
    else:
        out = sparse_ops.sparse_attention_ref(q, k, v, **kw)
    return attn_ops.output_tail(p, out[:, :, :n],
                                dropout_rate=cfg.attn_dropout,
                                dropout_key=key, train=train)


def attn_branch(layer: Layer, x: torch.Tensor, mask: Optional[torch.Tensor],
                cfg: TransformerConfig, key: Optional[torch.Tensor] = None,
                train: bool = False, *, is_sparse: bool = False
                ) -> torch.Tensor:
    """PreNorm attention: the layer's ``sparse_fn`` when ``is_sparse``,
    else dense attention with ``cfg.attn_impl``."""
    p = layer.attn
    h = core.layernorm(p.ln, x)
    if is_sparse:
        return sparse_fn(p, h, mask, cfg, key, train)
    return attn_ops.attention_apply(
        p, h, heads=cfg.heads, scale=cfg.scale,
        causal=cfg.causal, mask=mask, dropout_rate=cfg.attn_dropout,
        dropout_key=key, train=train, impl=cfg.attn_impl,
        bwd_impl=cfg.attn_bwd_impl, block_q=cfg.flash_block_q,
        block_k=cfg.flash_block_k)


# the largest dense/sparse pattern period the JAX stack unrolls; the
# serving engine's sparse reads need a pattern at most this periodic
_MAX_UNROLL_PERIOD = 4


def _pattern_period(pattern: Tuple[bool, ...]) -> int:
    """Smallest p with pattern == pattern[:p] * (len / p)."""
    depth = len(pattern)
    for p in range(1, depth + 1):
        if depth % p == 0 and pattern == pattern[:p] * (depth // p):
            return p
    return depth


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
    for layer, lkeys, is_sparse in zip(model.layers, keys,
                                       cfg.sparse_pattern):
        x = x + attn_branch(layer, x, mask, cfg, lkeys[0], train,
                            is_sparse=is_sparse)
        x = x + ff_branch(layer, x, cfg, lkeys[1], train)
    return x
