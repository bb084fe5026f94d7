"""The training step, on one device or across the ranks of a mesh.

Port of ``dalle_pytorch_tpu/parallel/train.py``'s ``make_train_step``
(``:32``), ``accumulate_grads`` (``:79``), ``setup_sharded`` (``:117``)
for the replicated placement and the pipeline's stage placement, and the
three models' loss closures, ``vae_loss_fn`` (``:235``), ``dalle_loss_fn``
(``:257``) and ``clip_loss_fn`` (``:270``). There is no jit: the step
runs eagerly on the rank's device, and the parameters and the
optimizer's moments update in place (where JAX returns new trees). An
optional scalar ``batch['lr_scale']`` (the resilience supervisor's
re-warm after a NaN rollback) scales that step's update, as JAX's step
does; a missing key is a scale of 1.

Across ranks (``mesh``), what GSPMD inserts in JAX is written out. The
loss a rank's backward starts from is its share (``parallel/
collectives.py``): the whole loss of its rows for a plain step, its part
of it under ``sp`` or ``pp`` (the loss function's ``model_axis``). After
the backward, and after ``accumulate_grads`` (once per update, not per
microbatch), ``reduce_grads`` sums the shares and the gradients of
parameters replicated over the model axis over it, then averages
everything over ``dp``; stage-local parameters (``pp``) are averaged
over ``dp`` only. All of it travels in one float32 buffer per group.
The loss returned is the global batch's, and every parameter's gradient
is that loss's gradient, whatever axis split the work, so the
global-norm clip and ``lr_scale`` act on the global gradient (under
``pp`` the norm adds the stages' squared norms over the pp group). A
plain data-parallel step draws its dropout and Gumbel noise as rows of
the global batch's draw (``prng.batch_rows``), as JAX's dp step does;
the ``sp`` and ``pp`` bodies draw for their own shard, as JAX's
``shard_map`` bodies do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dalle_pytorch_tpu_torch.cli.common import Optimizer
from dalle_pytorch_tpu_torch.models import clip as C
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel import collectives as col
from dalle_pytorch_tpu_torch.parallel.mesh import replicate


def _rows(batch: dict) -> int:
    for v in batch.values():
        if getattr(v, "ndim", 0) >= 1:
            return int(v.shape[0])
    return 0


def _stage_local(param_specs: Optional[dict], name: str,
                 axis: Optional[str]) -> bool:
    return bool(param_specs) and axis is not None \
        and param_specs.get(name) == axis


def reduce_grads(model: torch.nn.Module, loss: torch.Tensor, mesh,
                 model_axis: Optional[str] = None,
                 param_specs: Optional[dict] = None,
                 dp_axis: str = "dp") -> torch.Tensor:
    """Sum the loss shares and the replicated parameters' gradients over
    ``model_axis``, then average them and the stage-local ones over
    ``dp_axis``; returns the global loss. A parameter with no gradient
    (an embedding a pipeline stage never reads) counts as zeros, so every
    rank's buffer has the same layout."""
    mp, dp = mesh.group(model_axis), mesh.group(dp_axis)
    if mp.size == 1 and dp.size == 1:
        return loss.detach()
    params = [(n, p) for n, p in model.named_parameters()
              if p.requires_grad and not p.is_meta]
    local = [p for n, p in params if _stage_local(param_specs, n,
                                                  model_axis)]
    shared = [p for n, p in params if not _stage_local(param_specs, n,
                                                       model_axis)]

    def flat(ps):
        return [(p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).float() for p in ps]

    loss = loss.detach().float().reshape(1)
    buf = torch.cat(flat(shared) + [loss])
    col.psum_(buf, mp)
    buf = torch.cat([buf] + flat(local))
    if dp.size > 1:
        col.psum_(buf, dp)
        buf /= dp.size
    off = 0
    for p in shared + [None] + local:
        if p is None:
            loss = buf[off]
            off += 1
            continue
        n = p.numel()
        p.grad = buf[off:off + n].view(p.shape).to(p.dtype)
        off += n
    return loss


def _global_norm(model: torch.nn.Module, mesh, model_axis: Optional[str],
                 param_specs: Optional[dict]) -> torch.Tensor:
    """The L2 norm of every parameter's gradient across the stages: the
    stage-local squares summed over ``model_axis``."""
    local = shared = None
    for n, p in model.named_parameters():
        if p.grad is None or p.is_meta:
            continue
        sq = p.grad.float().square().sum()
        if _stage_local(param_specs, n, model_axis):
            local = sq if local is None else local + sq
        else:
            shared = sq if shared is None else shared + sq
    dev = next(p for p in model.parameters() if not p.is_meta).device
    local = local if local is not None else torch.zeros((), device=dev)
    shared = shared if shared is not None else torch.zeros((), device=dev)
    return (col.psum(local, mesh.group(model_axis)) + shared).sqrt()


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    grad_accum: int = 1, mesh=None,
                    param_specs: Optional[dict] = None,
                    dp_axis: str = "dp") -> Callable:
    """``step(model, batch, rng) -> loss``: gradients of
    ``loss_fn(model, batch, rng)``, one optimizer update, the loss
    detached. ``grad_accum > 1`` averages the gradients of that many
    microbatches (``accumulate_grads``) before the one update. A scalar
    ``batch['lr_scale']`` is taken out of (a copy of) the batch before
    the loss sees it, and multiplies this step's update (for Adam, its
    learning rate); the schedule still advances by one update.

    With a ``mesh`` the batch is this rank's rows and the step is the
    global batch's (module docstring), its microbatches the global
    batch's (``microbatch_rows``); ``param_specs`` marks the pipeline's
    stage-local parameters (``pp_param_specs``)."""
    model_axis = getattr(loss_fn, "model_axis", None)
    dp = mesh.group(dp_axis) if mesh is not None else col.SELF
    fn = loss_fn
    if model_axis is None and dp.size > 1:
        def fn(model, batch, rng):
            with prng.batch_rows(dp.index * _rows(batch)):
                return loss_fn(model, batch, rng)

    def step(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        batch = dict(batch)
        lr_scale = batch.pop("lr_scale", None)
        if grad_accum <= 1:
            loss = fn(model, batch, rng)
            loss.backward()
        else:
            loss = accumulate_grads(fn, model,
                                    microbatch_rows(batch, dp, grad_accum),
                                    rng, grad_accum)
        norm = None
        if mesh is not None:
            loss = reduce_grads(model, loss, mesh, model_axis, param_specs,
                                dp_axis)
            if optimizer.clip > 0 and model_axis is not None and any(
                    v == model_axis for v in (param_specs or {}).values()):
                norm = _global_norm(model, mesh, model_axis, param_specs)
        optimizer.step(1.0 if lr_scale is None else float(lr_scale),
                       grad_norm=norm)
        return loss.detach()

    return step


def _split(batch: dict, grad_accum: int) -> dict:
    """The entries of ``batch`` with a leading axis, each checked to split
    into ``grad_accum`` microbatches."""
    if not isinstance(batch, dict):
        raise TypeError("grad accumulation expects a dict batch")
    split = {k: v for k, v in batch.items() if getattr(v, "ndim", 0) >= 1}
    for k, v in split.items():
        if v.shape[0] % grad_accum:
            raise ValueError(f"batch entry {k!r} of {v.shape[0]} rows does "
                             f"not split into {grad_accum} microbatches")
    return split


def microbatch_rows(batch: dict, group: col.Group, grad_accum: int) -> dict:
    """This rank's rows of the global batch (the group's ranks' rows in
    rank order) laid out for ``accumulate_grads``: its chunk ``i`` is its
    ``1/size`` slice of the global batch's microbatch ``i``, as JAX's
    ``accumulate_grads`` splits the global batch into ``grad_accum``
    contiguous microbatches and shards each over dp. So each microbatch
    pairs with the same dropout and noise rows and (CLIP) the same
    negatives as in JAX. The rows travel by one all-gather per entry."""
    if group.size == 1 or grad_accum <= 1:
        return batch
    out = dict(batch)
    for k, v in _split(batch, grad_accum).items():
        whole = col.all_gather(v.detach(), group, dim=0)
        m = v.shape[0] // grad_accum
        out[k] = whole.reshape(grad_accum, group.size, m, *v.shape[1:])[
            :, group.index].reshape(v.shape)
    return out


def accumulate_grads(loss_fn: Callable, model: torch.nn.Module, batch: dict,
                     rng: torch.Tensor, grad_accum: int) -> torch.Tensor:
    """Mean loss over ``grad_accum`` microbatches, leaving their mean
    gradient in the parameters' ``.grad``. Entries of ``batch`` with a
    leading axis split on it; other entries pass whole. Microbatch ``i``
    sees ``fold_in(rng, i)``. Gradients add up in f32 and are cast to
    each parameter's dtype once, at the end (bf16 sums would compound
    rounding as ``grad_accum`` grows)."""
    split = _split(batch, grad_accum)
    rest = {k: v for k, v in batch.items() if k not in split}
    params = [p for p in model.parameters() if p.requires_grad]
    sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
    total = None
    for i in range(grad_accum):
        micro = {k: v.chunk(grad_accum, dim=0)[i] for k, v in split.items()}
        loss = loss_fn(model, {**micro, **rest}, prng.fold_in(rng, i))
        loss.backward()
        for s, p in zip(sums, params):
            if p.grad is not None:
                s += p.grad.float()
                p.grad = None
        total = loss.detach() if total is None else total + loss.detach()
    inv = 1.0 / grad_accum
    for s, p in zip(sums, params):
        p.grad = (s * inv).to(p.dtype)
    return total * inv


def vae_loss_fn(cfg, *, smooth_l1: bool = False,
                temperature=None) -> Callable:
    """``loss(vae, batch, rng)``: a ``DiscreteVAE``'s reconstruction loss
    on batch ``{'images': (b, H, W, C)}``, the Gumbel noise under
    ``rng``: the mean squared error (the model's own loss), or with
    ``smooth_l1`` the training scripts' Huber (delta 1) plus the mean
    squared error. ``temperature`` overrides ``cfg.temperature``."""

    def loss(vae, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        imgs = batch["images"]
        recon = V.vae_apply(vae, imgs, cfg=cfg, rng=rng,
                            temperature=temperature)
        mse = (imgs - recon).square().mean()
        if not smooth_l1:
            return mse
        d = (imgs - recon).abs()
        huber = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
        return huber + mse

    return loss


def dalle_loss_fn(vae=None) -> Callable:
    """``loss(model, batch, rng)``: DALLE's training loss on batch
    ``{'text': (b, t), 'image': ids (b, n) or raw images (b, H, W, C),
    'mask': optional (b, t)}``; raw images go through the VAE encoder
    ``vae``."""

    def loss(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        return D.dalle_apply(model, batch["text"], batch["image"],
                             mask=batch.get("mask"), vae=vae, rng=rng,
                             train=True, return_loss=True)

    return loss


def clip_loss_fn(mesh=None, dp_axis: str = "dp") -> Callable:
    """``loss(clip, batch, rng)``: CLIP's InfoNCE loss on batch
    ``{'text': (b, t), 'images': (b, H, W, C), 'mask': optional (b, t)}``
    (no randomness: ``rng`` is unused). The similarity matrix spans the
    whole batch: across ``dp`` each rank gathers every rank's image
    latents (``collectives.all_gather``, whose backward sums the
    cotangents back) and returns the mean loss of its own rows, so the
    dp average is the global batch's loss."""
    group = mesh.group(dp_axis) if mesh is not None else col.SELF

    def loss(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        tl = C.encode_text(model, batch["text"], batch.get("mask"))
        il = col.all_gather(C.encode_image(model, batch["images"]), group,
                            dim=0)
        return C.info_nce(model, tl, il, offset=group.index * tl.shape[0])

    return loss


# -- placement ---------------------------------------------------------------

def _owner(param_specs: Optional[dict], name: str, model: torch.nn.Module,
           axis: str, stages: int) -> Optional[int]:
    """The stage holding a stage-local parameter (None: on every
    stage)."""
    if not param_specs or param_specs.get(name) != axis:
        return None
    depth = len(model.transformer.layers)
    return int(name.split(".")[2]) // (depth // stages)


def _spec_axis(param_specs: Optional[dict]) -> Optional[str]:
    axes = {v for v in (param_specs or {}).values() if v}
    if len(axes) > 1:
        raise ValueError(f"param specs over several axes {sorted(axes)}")
    return next(iter(axes), None)


def setup_sharded(model: torch.nn.Module, optimizer: Optimizer, mesh,
                  param_specs: Optional[dict] = None):
    """Place ``model``'s parameters and ``optimizer``'s moments on the
    mesh, in place; returns (model, optimizer). Replicated (no specs):
    every rank gets the values of the world's first rank, so the
    replicas start identical (the moments too when the optimizer already
    holds some: a restored state is placed, not re-initialised). With
    ``pp_param_specs`` each stage keeps only its layers (the others move
    to the meta device and leave the optimizer), which are made equal
    over ``dp``, and everything else is replicated."""
    axis = _spec_axis(param_specs)
    stages = mesh.size(axis)
    here = mesh.index(axis)
    if axis is not None:
        depth = len(model.transformer.layers)
        if depth % stages:
            raise ValueError(f"depth {depth} not divisible by pipeline "
                             f"stages {stages}")
        per = depth // stages
        for i, layer in enumerate(model.transformer.layers):
            if i // per != here:
                layer.to("meta")
        optimizer.retain(model)
    shared, local = [], []
    for name, p in model.named_parameters():
        if p.is_meta:
            continue
        state = optimizer.adam.state.get(p, {})
        tensors = [p] + [state[k] for k in ("exp_avg", "exp_avg_sq")
                         if k in state]
        own = _owner(param_specs, name, model, axis, stages)
        (shared if own is None else local).extend(tensors)
    replicate(mesh, shared)
    replicate(mesh, local, [a for a in mesh.axis_names if a != axis])
    return model, optimizer


def checkpoint_state(model: torch.nn.Module, optimizer: Optimizer, ema,
                     mesh=None, param_specs: Optional[dict] = None):
    """What ``checkpoint.save`` writes: (model, optimizer, ema) as they
    are, or under a stage placement the whole trees, gathered from the
    stages of the first data-parallel rank's pipeline (every rank of that
    pipeline must call it; the others get None back)."""
    axis = _spec_axis(param_specs)
    if mesh is None or axis is None:
        return model, optimizer, ema
    if mesh.index("dp") != 0:
        return None
    from dalle_pytorch_tpu_torch.compat import to_jax
    g, stages = mesh.group(axis), mesh.size(axis)
    full, mu, nu, em = {}, {}, {}, {}
    dev = next(q for q in model.parameters() if not q.is_meta).device
    for name, p in model.named_parameters():
        own = _owner(param_specs, name, model, axis, stages)
        state = optimizer.adam.state.get(p, {}) if not p.is_meta else {}
        for out, t, dtype in (
                (full, p, p.dtype),
                (mu, state.get("exp_avg"), p.dtype),
                (nu, state.get("exp_avg_sq"), p.dtype),
                (em, None if ema is None or p.is_meta else ema[name],
                 torch.float32)):
            if out is em and ema is None:
                continue
            if p.is_meta or t is None:
                t = torch.zeros(p.shape, dtype=dtype, device=dev)
            if own is not None:
                t = col.broadcast(t.detach(), g, own)
            out[name] = t.detach()
    trees = (to_jax.tree(model, full),
             optimizer.state_tree(model, (mu, nu)),
             to_jax.tree(model, em) if ema is not None else None)
    return trees
