"""The sequence-parallel transformer and DALLE loss.

Port of ``dalle_pytorch_tpu/parallel/sequence.py`` (``:57-187``): the
stack with the token axis split over the ranks of ``sp_axis``, each
rank holding (b, n/sp, dim). LayerNorm, the projections and the GEGLU
are position-local; attention runs as the ring or the Ulysses body
(``parallel/ring.py``). Both dropout sites draw per global position
(``core.positional_dropout`` at offset ``rank_in_sp * n_local``), so a
key gives the same masks at every sp degree, and ``cfg.remat`` wraps
each layer (``ops/transformer.py::_maybe_remat``): the recompute re-runs
the layer's collectives in the backward, in the same order on every
rank. Refused, as in JAX: sparse layers, the reversible engine and MoE.
Tensor parallelism composes inside (JAX's dp x tp x sp): under
``dalle_param_specs(tp=)`` the ring and Ulysses bodies run on the rank's
``h/tp`` heads, the GEGLU on its hidden slice (its positional dropout
drawn for those columns), and the head's softmax spans the tp group
(``models/dalle.py``).

``sp_dalle_loss_fn`` embeds the batch, keeps this rank's positions and
returns this rank's share of the loss: the CE summed over its rows,
divided by all of the batch's, so the shares of the sp group add up to
the loss (the convention of ``parallel/collectives.py``; the training
step sums them and the parameters' gradients over sp).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import transformer as T
from dalle_pytorch_tpu_torch.parallel import collectives as col
from dalle_pytorch_tpu_torch.parallel import placement as PL
from dalle_pytorch_tpu_torch.parallel.ring import (ring_attention_local,
                                                   ulysses_attention_local)


def _check_cfg(cfg: T.TransformerConfig) -> None:
    if any(cfg.sparse_pattern):
        raise ValueError("sequence parallelism supports dense attention "
                         "only (sparse_attn must be False)")
    if cfg.reversible:
        raise ValueError("sequence parallelism and reversible execution "
                         "are mutually exclusive engines")
    if cfg.moe_experts:
        raise ValueError("sequence parallelism does not yet compose with "
                         "MoE layers (route tokens before sharding them)")


def _stack_local(model: T.Transformer, x: torch.Tensor, mask, *, cfg,
                 group: col.Group, impl: str, rng, train: bool
                 ) -> torch.Tensor:
    """The stack on this rank's (b, n_local, dim) shard."""
    offset = group.index * x.shape[1]
    keys = (T._layer_keys(rng, cfg.depth, x.device) if train
            else [(None, None)] * cfg.depth)

    def attend(q, k, v, mb):
        if impl == "ring":
            return ring_attention_local(q, k, v, group=group,
                                        causal=cfg.causal, scale=cfg.scale,
                                        mask=mb)
        return ulysses_attention_local(q, k, v, group=group,
                                       causal=cfg.causal, scale=cfg.scale,
                                       mask=mb)

    def drop(rate):
        return lambda k, t, cols=None: core.positional_dropout(
            k, t, rate, train, offset=offset, cols=cols)

    for layer, lkeys in zip(model.layers, keys):

        def body(h, mb, ka, kf, layer=layer):
            layer = PL.fetch_layer(layer)
            p = layer.attn
            a_in = core.layernorm(p.ln, h, recompute=T._save_ln(cfg))
            q, k, v = attn_ops.qkv_project(p, a_in, cfg.heads)
            a_out = attn_ops.output_tail(p, attend(q, k, v, mb))
            h = h + drop(cfg.attn_dropout)(ka, a_out)
            return h + T.ff_branch(layer, h, cfg, kf, train,
                                   dropout_fn=drop(cfg.ff_dropout))

        x = T._maybe_remat(body, cfg.remat)(x, mask, lkeys[0], lkeys[1])
    return x


def sp_transformer_apply(model: T.Transformer, x: torch.Tensor, *,
                         cfg: T.TransformerConfig, mesh,
                         sp_axis: str = "sp",
                         batch_axis: Optional[str] = None,
                         impl: str = "ring",
                         mask: Optional[torch.Tensor] = None,
                         rng: Optional[torch.Tensor] = None,
                         train: bool = False, local: bool = False
                         ) -> torch.Tensor:
    """The stack with the sequence split over ``sp_axis``, numerically
    ``transformer_apply``'s. With ``local=False`` x (b, n, dim) and
    ``mask`` (b, n) are GLOBAL (the same on every rank): this rank runs
    its rows (``batch_axis``) and positions and the output comes back
    global, gathered. With ``local=True`` they are this rank's shard and
    the output is too."""
    _check_cfg(cfg)
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp impl {impl!r}")
    if train and rng is None and (cfg.attn_dropout > 0
                                  or cfg.ff_dropout > 0):
        raise ValueError(
            "sp_transformer_apply(train=True) with nonzero dropout requires "
            "an explicit `rng` key")
    group = mesh.group(sp_axis)
    if local:
        return _stack_local(model, x, mask, cfg=cfg, group=group, impl=impl,
                            rng=rng, train=train)
    from dalle_pytorch_tpu_torch.parallel.ring import _gather, _shard
    size = mesh.size(sp_axis)
    if x.shape[1] % size != 0:
        raise ValueError(f"seq len {x.shape[1]} not divisible by "
                         f"{sp_axis} axis ({size})")
    xs = _shard(x, mesh, sp_axis, batch_axis, 1)
    ms = _shard(mask, mesh, sp_axis, batch_axis, 1) if mask is not None \
        else None
    y = _stack_local(model, xs, ms, cfg=cfg, group=group, impl=impl,
                     rng=rng, train=train)
    return _gather(y, mesh, sp_axis, batch_axis, 1)


def _ce_sum(model: D.DALLE, h: torch.Tensor, targets: torch.Tensor,
            row0: int) -> torch.Tensor:
    """The CE summed over the rows ``row0 ..`` of the sequence that ``h``
    (b, n_local, dim) holds, through ``cfg.loss_chunk``-row chunks when
    set (each recomputed in the backward, as ``D._chunked_ce``)."""
    cfg = model.cfg
    n = h.shape[1]
    chunk = min(cfg.loss_chunk, n) if cfg.loss_chunk > 0 else n

    def body(hc, tc, rows):
        return D.nll_rows(model, hc, tc, rows).sum()

    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        rows = torch.arange(row0 + c0, row0 + c1, device=h.device)
        args = (h[:, c0:c1], targets[:, c0:c1], rows)
        total = total + (torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False) if cfg.loss_chunk > 0
            else body(*args))
    return total


def sp_dalle_loss_fn(mesh, *, sp_axis: str = "sp", impl: str = "ring"):
    """``loss(model, batch, rng)`` for ``parallel/train.py``'s step, with
    the transformer sequence-split over ``sp_axis``. ``batch`` is this
    rank's rows ({'text': (b, t), 'image': ids (b, n_img), 'mask':
    optional (b, t), extended all-True over the image span}), the same on
    every rank of the sp group. Returns this rank's share of the batch's
    mean CE (the group's shares sum to it)."""
    group = mesh.group(sp_axis)

    def loss(model: D.DALLE, batch: dict, rng) -> torch.Tensor:
        cfg = model.cfg
        _check_cfg(cfg.transformer)
        text, image_ids = batch["text"], batch["image"]
        tokens = D.embed_prompt(model, text, image_ids)
        b, n = tokens.shape[:2]
        if n % group.size:
            raise ValueError(f"seq len {n} not divisible by {sp_axis} "
                             f"axis ({group.size})")
        nl = n // group.size
        row0 = group.index * nl
        mask = batch.get("mask")
        if mask is not None:
            pad = torch.ones((mask.shape[0], image_ids.shape[1]),
                             dtype=torch.bool, device=mask.device)
            mask = torch.cat([mask.bool(), pad], dim=1)[:, row0:row0 + nl]
        h = _stack_local(model.transformer, tokens[:, row0:row0 + nl], mask,
                         cfg=cfg.transformer, group=group, impl=impl,
                         rng=rng, train=True)
        eos = torch.full((b, 1), cfg.eos_token_id, dtype=torch.long,
                         device=text.device)
        labels = torch.cat([text.long(),
                            image_ids.long() + cfg.num_text_tokens, eos],
                           dim=1)
        targets = labels[:, 1 + row0:1 + row0 + nl]
        return _ce_sum(model, h, targets, row0) / (b * n)

    loss.model_axis = sp_axis
    return loss
