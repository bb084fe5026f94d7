"""Pipeline parallelism: the GPipe schedule over the ranks of a ``pp``
axis.

Port of ``dalle_pytorch_tpu/parallel/pipeline.py`` (``:44-278``). Stage
``s`` of P holds layers ``s * depth/P ..`` (``pp_param_specs``: a rank
stores only those; ``parallel/train.py::setup_sharded`` drops the rest to
the meta device; ``ep=`` splits each stage's experts further), the batch
splits into M microbatches, and the schedule
runs M + P - 1 ticks: at tick t stage s runs microbatch ``t - s`` when it
is in range, then every stage hands its output to the next through
``collectives.ppermute``. An idle tick skips the layers but still
rotates, so every rank issues the same collectives in the same order,
forward and backward; every rotated tensor takes part in the graph on
every rank for the same reason (stage 0 selects its input with a
``where`` over the handoff it ignores, as JAX's ``where`` does, and idle
ticks carry zeros that require a gradient). Dropout keys are
``fold_in(fold_in(rng, stage), clip(t - stage, 0, M - 1))``; sparse
layers run when the dense/sparse pattern is the same on every stage
(``_stage_pattern``), which puts kernel K3 on the path.

The last stage's output comes back on every rank through ``psum`` (the
other stages add zeros), and so does the MoE load-balance aux: summed
over stages, divided by M. A loss computed alike on every stage enters
each rank's backward divided by P (``pp_dalle_loss_fn``), so the sum
over stages of the head's and the embeddings' gradients is the loss's
gradient (``parallel/collectives.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.ops import transformer as T
from dalle_pytorch_tpu_torch.parallel import collectives as col


def _stage_pattern(cfg: T.TransformerConfig, num_stages: int):
    """The dense/sparse pattern of one stage, the same for every stage
    (``ValueError`` otherwise, as JAX's)."""
    depth_per = cfg.depth // num_stages
    pattern = cfg.sparse_pattern
    slices = {pattern[s * depth_per:(s + 1) * depth_per]
              for s in range(num_stages)}
    if len(slices) != 1:
        raise ValueError(
            f"sparse pattern {pattern} is not stage-invariant over "
            f"{num_stages} pipeline stages of {depth_per} layers — every "
            "stage must see the same dense/sparse slice")
    return next(iter(slices))


def stage_layers(model: T.Transformer, cfg: T.TransformerConfig,
                 num_stages: int, stage: int):
    """(stage module, stage config): a view of ``model`` holding stage
    ``stage``'s layers (shared, not copied) and the config of a stack of
    ``depth / num_stages`` layers with the stage's pattern."""
    depth_per = cfg.depth // num_stages
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.layers = model.layers[stage * depth_per:(stage + 1) * depth_per]
    return view, dataclasses.replace(
        cfg, depth=depth_per, sparse_attn=_stage_pattern(cfg, num_stages))


def _check(cfg: T.TransformerConfig, num_stages: int) -> None:
    if cfg.depth % num_stages:
        raise ValueError(f"depth {cfg.depth} not divisible by pipeline "
                         f"stages {num_stages}")
    if cfg.reversible:
        raise NotImplementedError(
            "pipeline_transformer does not support reversible=True")
    _stage_pattern(cfg, num_stages)


def _schedule(model, xm, maskm, *, cfg, group: col.Group, rng, train):
    """The M + P - 1 ticks over microbatches ``xm`` (M, mb, n, d) on this
    stage. Returns (the last stage's (M * mb, n, d) output on every rank,
    the aux summed over stages / M)."""
    P_, idx = group.size, group.index
    M = xm.shape[0]
    stage, stage_cfg = stage_layers(model, cfg, P_, idx)
    if rng is None:
        rng = prng.prng_key(0, device=xm.device)     # dead (dropout off)
    rng_stage = prng.fold_in(rng, idx)
    grad = torch.is_grad_enabled()
    first = torch.full((), idx == 0, device=xm.device)

    def zeros():
        return torch.zeros(xm.shape[1:], dtype=xm.dtype, device=xm.device,
                           requires_grad=grad)

    state = zeros()
    outs, aux = [], xm.new_zeros((), dtype=torch.float32)
    ticks = M + P_ - 1
    for t in range(ticks):
        inp = xm[t] if t < M else zeros()
        h = torch.where(first, inp, state)
        mb = t - idx
        if 0 <= mb < M:
            key = prng.fold_in(rng_stage, mb)
            h, a = T.transformer_apply(
                stage, h, cfg=stage_cfg,
                mask=maskm[mb] if maskm is not None else None, rng=key,
                train=train, with_aux=True)
            aux = aux + a
        outs.append(h)
        if t < ticks - 1:
            state = col.ppermute(h, group)
    # stage s finishes microbatch m at tick m + s: the last stage's outputs
    # at ticks P-1 .. M+P-2 are the result, in order
    final = torch.cat(outs[P_ - 1:], dim=0)
    last = torch.full((), idx == P_ - 1, device=xm.device)
    final = col.psum(torch.where(last, final, torch.zeros_like(final)),
                     group)
    return final, col.psum(aux, group) / M


def pipeline_transformer(model: T.Transformer, x: torch.Tensor, *, cfg,
                         mesh, axis: str = "pp",
                         num_microbatches: Optional[int] = None,
                         dp_axis: Optional[str] = None,
                         mask: Optional[torch.Tensor] = None,
                         rng: Optional[torch.Tensor] = None,
                         train: bool = False, with_aux: bool = False,
                         local: bool = False):
    """The stack pipelined over ``mesh``'s ``axis``, numerically
    ``transformer_apply``'s (dropout aside: keyed per stage and
    microbatch). ``num_microbatches`` M defaults to the stage count.

    With ``local=False`` x (b, n, dim) and ``mask`` (b, n) are the whole
    batch, the same on every rank; microbatch m is rows ``m * b/M ..``,
    and over ``dp_axis`` each rank runs its ``1/dp`` of every microbatch
    (JAX's ``P(None, dp)`` on the microbatch axis); the result is the
    whole (b, n, dim) on every rank and the aux is averaged over dp. With
    ``local=True`` x is this rank's rows, split into M contiguous
    microbatches, and the result is this rank's rows."""
    num_stages = mesh.size(axis)
    _check(cfg, num_stages)
    if train and rng is None and (cfg.attn_dropout > 0
                                  or cfg.ff_dropout > 0):
        raise ValueError(
            "pipeline_transformer(train=True) with nonzero dropout requires "
            "an explicit `rng` key")
    M = num_microbatches or num_stages
    b, n, d = x.shape
    if b % M:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    xm = x.reshape(M, b // M, n, d)
    maskm = mask.reshape(M, b // M, n) if mask is not None else None
    dp = mesh.size(dp_axis) if not local else 1
    if dp > 1:
        mbl = (b // M) // dp
        i = mesh.index(dp_axis)
        xm = xm[:, i * mbl:(i + 1) * mbl]
        if maskm is not None:
            maskm = maskm[:, i * mbl:(i + 1) * mbl]
    out, aux = _schedule(model, xm, maskm, cfg=cfg, group=mesh.group(axis),
                         rng=rng, train=train)
    if dp > 1:
        g = mesh.group(dp_axis)
        out = col.all_gather(out.reshape(M, -1, n, d), g, dim=1)
        aux = col.pmean(aux, g)
    out = out.reshape(-1, n, d)
    return (out, aux) if with_aux else out


def pp_param_specs(model: D.DALLE, axis: str = "pp",
                   ep: Optional[str] = None) -> dict:
    """{parameter name: ``placement.Spec``}: the transformer stack's
    layers split over ``axis`` by depth (each stage stores only its own
    ``depth/P``), everything else (embeddings and head) whole on every
    stage; for ``parallel/train.py::setup_sharded``. ``ep`` also splits
    each stage's MoE expert stacks over that axis (dp x pp x ep; the
    experts' sum over ep runs inside the stage, ``ops/moe.py``), and
    raises JAX's ``ValueError`` for a model without MoE."""
    from dalle_pytorch_tpu_torch.parallel.placement import Spec
    specs = {name: Spec(axis, staged=True)
             if name.startswith("transformer.layers.")
             else Spec() for name, _ in model.named_parameters()}
    if ep is not None:
        moe = [n for n in specs if n.startswith("transformer.layers.")
               and n.endswith((".ff.moe.w1", ".ff.moe.w2"))]
        if not moe:
            raise ValueError(
                f"ep={ep!r} requested but the param tree has no "
                "['transformer']['ff']['moe'] subtree — the model was "
                "built without MoE (moe_experts=0) or the MoE param "
                "layout moved; update pp_param_specs' path to match")
        for n in moe:
            specs[n] = Spec(axis, (ep, None, None), staged=True)
    return specs


def pp_dalle_loss_fn(mesh, *, axis: str = "pp",
                     num_microbatches: Optional[int] = None):
    """``loss(model, batch, rng)`` for ``parallel/train.py``'s step with
    the transformer pipelined over ``axis``; ``batch`` is this rank's
    rows, the same on every stage. Every stage computes the whole loss
    (plus ``moe_aux_coef`` times the aux in a MoE model) and returns its
    share, the loss / P."""
    group = mesh.group(axis)

    def loss(model: D.DALLE, batch: dict, rng) -> torch.Tensor:
        cfg = model.cfg
        if cfg.transformer.reversible:
            raise NotImplementedError(
                "pipeline parallelism does not support reversible=True")
        text, image_ids = batch["text"], batch["image"]
        tokens = D.embed_prompt(model, text, image_ids)
        mask = batch.get("mask")
        if mask is not None:
            pad = torch.ones((mask.shape[0], image_ids.shape[1]),
                             dtype=torch.bool, device=mask.device)
            mask = torch.cat([mask.bool(), pad], dim=1)
        h, aux = pipeline_transformer(
            model.transformer, tokens, cfg=cfg.transformer, mesh=mesh,
            axis=axis, num_microbatches=num_microbatches, mask=mask,
            rng=rng, train=True, with_aux=True, local=True)
        value = D.ce_from_hidden(model, h, text, image_ids)
        if cfg.moe_experts:
            value = value + cfg.moe_aux_coef * aux
        return value / group.size

    loss.model_axis = axis
    return loss
