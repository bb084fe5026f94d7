"""Transformer stack: PreNorm attention + PreNorm GEGLU (or MoE) FF.

Port of ``dalle_pytorch_tpu/ops/transformer.py`` (``:46-372``):
``TransformerConfig``, per-layer modules in place of the JAX
depth-stacked pytree (``compat/from_jax.py`` unstacks it), the GEGLU
``ff_branch`` and ``ff_or_moe`` (``moe_experts > 0`` swaps every FF for
a top-k ``ops/moe.py`` layer whose load-balance loss ``transformer_apply
(with_aux=True)`` sums over depth), and the forward of the stack in
eval or train mode. In train mode each layer draws its two dropout keys
from ``split(rng, (depth, 2))`` as ``_layer_keys`` does, so the masks
are JAX's bit for bit. ``attn_impl='flash'`` runs the flash kernels
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

``reversible=True`` runs the two-stream engine of ``ops/reversible.py``
(and ignores ``remat``, as JAX does). ``remat`` (``_maybe_remat``,
JAX ``:139-165``) trades memory for recompute per layer:

* ``'full'``: ``torch.utils.checkpoint`` of the layer; the backward
  reruns it whole, K1 included (2 x depth K1 launches a step);
* ``'dots'``: a selective checkpoint that keeps the outputs of the
  matrix products (aten ``mm``, ``addmm``, ``bmm``, ``baddbmm``) and
  recomputes the rest. K1 launches through ctypes, not as a dispatcher
  op, so its outputs are not a product's: the recompute relaunches it,
  as JAX's ``dots_saveable`` recomputes its ``pallas_call``;
* ``'save_ln'``: no layer checkpoint; each layernorm keeps only its
  input and recomputes its two f32 intermediates in the backward
  (``core.layernorm(recompute=True)``, JAX's ``ln_f32_in`` and
  ``ln_f32_out``). Everything else, K1's outputs included, stays saved:
  K1 runs once a layer.

Across ranks (``parallel/placement.py``): under tensor parallelism
(``FeedForward.tp``) a rank holds its slice of GEGLU's hidden half and
of its gates half (``w1``'s rows and bias) and the matching columns of
``w2``; ``ff_dropout`` draws the rank's columns of the one-process mask
(``core.dropout(cols=)``), and ``w2``'s product is summed over ``tp``
before its bias. Under fsdp (``Layer.fsdp``) each layer's weights reach
the ranks from their owner inside the (rematerialised) layer body, so a
recompute fetches them again.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import block_sparse as block_sparse_ops
from dalle_pytorch_tpu_torch.ops import core, prng
from dalle_pytorch_tpu_torch.ops import flash_attention as flash_ops
from dalle_pytorch_tpu_torch.ops import moe as moe_ops
from dalle_pytorch_tpu_torch.ops import reversible as rev_ops
from dalle_pytorch_tpu_torch.ops import sparse as sparse_ops
from dalle_pytorch_tpu_torch.parallel import collectives as col
from dalle_pytorch_tpu_torch.parallel import placement as PL

SPARSE_IMPLS = ("ref", "windowed", "pallas")
REMAT_MODES = ("none", "save_ln", "dots", "full")


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
    remat: str = "none"          # 'none' | 'save_ln' | 'dots' | 'full'
    # 0 = plain GEGLU; > 0 replaces every FF with a top-k MoE layer
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity: float = 1.25

    def __post_init__(self):
        if self.attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention impl {self.attn_impl!r}; "
                             f"expected 'xla' or 'flash'")
        if self.attn_bwd_impl not in flash_ops.BWD_IMPLS:
            raise ValueError(f"unknown attn_bwd_impl "
                             f"{self.attn_bwd_impl!r}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be 'none', 'dots', 'full' or "
                             f"'save_ln', got {self.remat!r}")
        if self.moe_experts:
            if self.reversible:
                raise ValueError("reversible=True does not compose with "
                                 "MoE layers (the FF branch is not "
                                 "invertible-stream shaped); use the "
                                 "sequential engine")
            self.moe                 # validates k <= num_experts
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
    def moe(self) -> moe_ops.MoEConfig:
        return moe_ops.MoEConfig(dim=self.dim, num_experts=self.moe_experts,
                                 k=self.moe_k, ff_mult=self.ff_mult,
                                 capacity_factor=self.moe_capacity)

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
    ``w2`` (hidden -> dim) — the JAX ``layer_params["ff"]`` subtree;
    ``tp`` the group its hidden units are split over (None: all here)."""

    tp = None

    def __init__(self, dim: int, mult: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = nn.LayerNorm(dim, **kw)
        self.w1 = nn.Linear(dim, dim * mult * 2, **kw)
        self.w2 = nn.Linear(dim * mult, dim, **kw)


class MoEFeedForward(nn.Module):
    """PreNorm MoE parameters: ``ln`` and ``moe`` (``ops/moe.py``) — the
    JAX ``layer_params["ff"]`` subtree of a MoE stack."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.ln = nn.LayerNorm(cfg.dim, device=device, dtype=dtype)
        self.moe = moe_ops.MoE(cfg.moe, device=device, dtype=dtype)


class Layer(nn.Module):
    """One layer's ``attn`` and ``ff``; ``fsdp`` (a ``placement.Owner``)
    when one rank of a group stores it for all of them."""

    fsdp = None

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        self.attn = attn_ops.Attention(cfg.dim, cfg.heads, cfg.dim_head,
                                       device=device, dtype=dtype)
        if cfg.moe_experts:
            self.ff = MoEFeedForward(cfg, device=device, dtype=dtype)
        else:
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
              train: bool = False, dropout_fn=None) -> torch.Tensor:
    """PreNorm GEGLU feed-forward (``transformer.ff_branch``), with
    ``cfg.ff_dropout`` on the gated hidden in train mode;
    ``dropout_fn(key, h, cols=)`` replaces that dropout (the
    sequence-parallel stack passes ``core.positional_dropout``). Over a
    ``tp`` group: this rank's hidden columns, their dropout mask drawn
    as those columns of the whole one, and ``w2``'s product summed over
    the group before its bias."""
    p = layer.ff
    tp = p.tp or col.SELF
    h = core.linear(p.w1, core.layernorm(p.ln, x, recompute=_save_ln(cfg)))
    h, gates = h.chunk(2, dim=-1)
    h = h * core.gelu(gates)
    cols = None if tp.size == 1 else (tp.index * h.shape[-1],
                                      tp.size * h.shape[-1])
    if dropout_fn is not None:
        h = dropout_fn(key, h, cols=cols)
    elif train:
        h = core.dropout(key, h, cfg.ff_dropout, train, cols)
    if tp.size == 1:
        return core.linear(p.w2, h)
    return attn_ops.row_parallel(p.w2, h, tp)


def ff_or_moe(layer: Layer, x: torch.Tensor, cfg: TransformerConfig,
              key: Optional[torch.Tensor] = None, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FF residual branch -> (out, aux): GEGLU with aux 0, or the MoE
    layer with its load-balance loss and ``ff_dropout`` on its output."""
    if cfg.moe_experts:
        p = layer.ff
        h = core.layernorm(p.ln, x, recompute=_save_ln(cfg))
        out, aux = moe_ops.moe_apply(p.moe, h, cfg=cfg.moe)
        return core.dropout(key, out, cfg.ff_dropout, train), aux
    return (ff_branch(layer, x, cfg, key, train),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _save_ln(cfg: Optional[TransformerConfig]) -> bool:
    return cfg is not None and cfg.remat == "save_ln" and not cfg.reversible


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
    h = core.layernorm(p.ln, x, recompute=_save_ln(cfg))
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


# the aten products 'dots' keeps; every other op is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body, mode: str):
    """``body`` checkpointed under 'full' and 'dots' (module docstring)
    while gradients are recorded; 'none' and 'save_ln' run it as it is
    (the latter's layernorms recompute themselves)."""
    if mode not in ("full", "dots"):
        return body
    kw = dict(use_reentrant=False)
    if mode == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts)
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return torch.utils.checkpoint.checkpoint(body, *args, **kw)

    return run


def transformer_apply(model: Transformer, x: torch.Tensor, *,
                      cfg: TransformerConfig,
                      mask: Optional[torch.Tensor] = None,
                      rng: Optional[torch.Tensor] = None,
                      train: bool = False, with_aux: bool = False):
    """Run the stack. x: (b, n, dim); mask: (b, n) bool (True = keep);
    ``rng`` a (2,) key, needed when training with dropout.
    ``with_aux=True`` returns (x, aux): the MoE load-balance loss summed
    over depth (0 for GEGLU stacks), float32."""
    if train and rng is None and (cfg.attn_dropout > 0
                                  or cfg.ff_dropout > 0):
        raise ValueError(
            "transformer_apply(train=True) with nonzero dropout needs an "
            "explicit `rng` key")
    if cfg.reversible:
        out = rev_ops.reversible_apply(model, x, cfg=cfg, mask=mask,
                                       rng=rng, train=train)
        return (out, x.new_zeros((), dtype=torch.float32)) if with_aux \
            else out
    keys = (_layer_keys(rng, cfg.depth, x.device) if train
            else [(None, None)] * cfg.depth)
    aux = x.new_zeros((), dtype=torch.float32)
    for layer, lkeys, is_sparse in zip(model.layers, keys,
                                       cfg.sparse_pattern):

        def body(h, mask, ka, kf, layer=layer, is_sparse=is_sparse):
            layer = PL.fetch_layer(layer)
            h = h + attn_branch(layer, h, mask, cfg, ka, train,
                                is_sparse=is_sparse)
            f, a = ff_or_moe(layer, h, cfg, kf, train)
            return h + f, a

        x, a = _maybe_remat(body, cfg.remat)(x, mask, lkeys[0], lkeys[1])
        aux = aux + a
    return (x, aux) if with_aux else x
