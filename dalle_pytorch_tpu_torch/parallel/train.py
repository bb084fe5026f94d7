"""The training step, on one device or across the ranks of a mesh.

Port of ``dalle_pytorch_tpu/parallel/train.py``'s ``make_train_step``
(``:32``), ``accumulate_grads`` (``:79``), ``setup_sharded`` (``:117``),
the placement rules ``dalle_param_specs`` (``:164-215``) and
``dalle_moe_param_specs`` (``:218-228``), and the three models' loss
closures, ``vae_loss_fn`` (``:235``), ``dalle_loss_fn`` (``:257``) and
``clip_loss_fn`` (``:270``). There is no jit: the step
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
global-norm clip and ``lr_scale`` act on the global gradient (the norm
adds each piece's squares over the axes that split its parameter).

Under a placement that splits parameters (``parallel/placement.py``:
tp, fsdp and ep see the same rows, as JAX splits the batch over dp
only) every rank of such an axis computes the same loss, and its
backward starts from its share, the loss / the axis' size. A piece of a
parameter (a tp or ep slice, a layer an fsdp or pp rank stores) then
holds the whole loss's gradient of that piece; a parameter whole on the
axis sums its ranks' gradients over it. A
plain data-parallel step draws its dropout and Gumbel noise as rows of
the global batch's draw (``prng.batch_rows``), as JAX's dp step does;
the ``sp`` and ``pp`` bodies draw for their own shard, as JAX's
``shard_map`` bodies do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.cli.common import Optimizer
from dalle_pytorch_tpu_torch.models import clip as C
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel import collectives as col
from dalle_pytorch_tpu_torch.parallel import placement as PL
from dalle_pytorch_tpu_torch.parallel.mesh import replicate


def _rows(batch: dict) -> int:
    for v in batch.values():
        if getattr(v, "ndim", 0) >= 1:
            return int(v.shape[0])
    return 0


def _sum_axes(mesh, model_axis: Optional[str], param_specs: Optional[dict],
              dp_axis: str) -> Tuple[str, ...]:
    """The axes whose ranks' gradients add up to the loss's: the model
    axis (the loss's shares) and the axes that split parameters but not
    the rows (every rank's backward starts from its share of the loss)."""
    rep = PL.replica_axes(param_specs, mesh, (model_axis, dp_axis))
    return tuple(a for a in mesh.axis_names
                 if (a == model_axis and mesh.size(a) > 1) or a in rep)


def reduce_grads(model: torch.nn.Module, loss: torch.Tensor, mesh,
                 model_axis: Optional[str] = None,
                 param_specs: Optional[dict] = None,
                 dp_axis: str = "dp") -> torch.Tensor:
    """Sum each parameter's gradient over the summed axes (the loss's
    model axis, and the tp, fsdp and ep axes) that do not split it, and
    the loss shares over the model axis; then average everything over
    ``dp_axis``. Returns the global loss. A piece of a parameter (a tp
    or ep slice, an fsdp or pipeline layer) already holds the whole
    loss's gradient of that piece and is not summed over its axis. A
    parameter with no gradient (an embedding a pipeline stage never
    reads) counts as zeros, so every rank's buffers have the same
    layout."""
    axes = _sum_axes(mesh, model_axis, param_specs, dp_axis)
    dp = mesh.group(dp_axis)
    if not axes and dp.size == 1:
        return loss.detach()
    buckets: dict = {}
    for n, p in model.named_parameters():
        if not p.requires_grad or p.is_meta:
            continue
        spec = PL.spec_of(param_specs, n)
        key = tuple(a for a in axes if a not in spec.axes())
        buckets.setdefault(key, []).append(p)
    loss_key = (model_axis,) if model_axis in axes else ()
    loss = loss.detach().float().reshape(1)

    def flat(ps):
        return [(p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1).float() for p in ps]

    order = sorted(set(buckets) | {loss_key}, key=lambda k: (len(k), k))
    bufs = []
    for key in order:
        parts = flat(buckets.get(key, [])) + ([loss] if key == loss_key
                                              else [])
        buf = torch.cat(parts) if parts else None
        for a in key:
            col.psum_(buf, mesh.group(a))
        bufs.append(buf)
    if dp.size > 1:
        whole = torch.cat(bufs)
        col.psum_(whole, dp)
        whole /= dp.size
        bufs = list(whole.split([b.numel() for b in bufs]))
    for key, buf in zip(order, bufs):
        off = 0
        for p in buckets.get(key, []):
            n = p.numel()
            p.grad = buf[off:off + n].view(p.shape).to(p.dtype)
            off += n
        if key == loss_key:
            loss = buf[off]
    return loss


def _global_norm(model: torch.nn.Module, mesh,
                 param_specs: Optional[dict]) -> torch.Tensor:
    """The L2 norm of the whole model's gradient: each piece's squares
    summed over the axes that split its parameter, so every element
    counts once. Every rank sums the same buckets in the same order (a
    bucket it holds nothing of counts zero)."""
    live = tuple(a for a in mesh.axis_names if mesh.size(a) > 1)

    def key(spec):
        return tuple(a for a in live if a in spec.axes())

    dev = next(p for p in model.parameters() if not p.is_meta).device
    sq = {key(s): torch.zeros((), device=dev)
          for s in list((param_specs or {}).values()) + [PL.REPLICATED]
          if s is not None}
    for n, p in model.named_parameters():
        if p.grad is None or p.is_meta:
            continue
        k = key(PL.spec_of(param_specs, n))
        sq[k] = sq[k] + p.grad.float().square().sum()
    total = torch.zeros((), device=dev)
    for k in sorted(sq, key=lambda k: (len(k), k)):
        v = sq[k]
        for a in k:
            v = col.psum(v, mesh.group(a))
        total = total + v
    return total.sqrt()


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
    batch's (``microbatch_rows``); ``param_specs`` is the placement
    ``setup_sharded`` made (``dalle_param_specs``,
    ``dalle_moe_param_specs``, ``pp_param_specs``). The ranks of an axis
    that splits parameters but not the rows (tp, fsdp, ep) compute the
    same loss, and each one's backward starts from its share of it."""
    model_axis = getattr(loss_fn, "model_axis", None)
    dp = mesh.group(dp_axis) if mesh is not None else col.SELF
    shares = 1
    if mesh is not None:
        for a in PL.replica_axes(param_specs, mesh, (model_axis, dp_axis)):
            shares *= mesh.size(a)

    def fn(model, batch, rng):
        if model_axis is None and dp.size > 1:
            with prng.batch_rows(dp.index * _rows(batch)):
                value = loss_fn(model, batch, rng)
        else:
            value = loss_fn(model, batch, rng)
        return value / shares if shares > 1 else value

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
        if shares > 1:
            loss = loss.detach() * shares
        norm = None
        if mesh is not None:
            loss = reduce_grads(model, loss, mesh, model_axis, param_specs,
                                dp_axis)
            if optimizer.clip > 0 and PL.splits(param_specs, mesh):
                norm = _global_norm(model, mesh, param_specs)
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

def _layer_spec(name: str, tp: Optional[str],
                fsdp: Optional[str]) -> PL.Spec:
    """JAX's ``_dalle_rule`` (``train.py:164-198``) for one parameter of
    a stack layer, in the torch layout (``nn.Linear.weight`` is (out,
    in)): qkv and w1 column-parallel (rows split), with w1's bias; out
    and w2 row-parallel (columns split), their biases whole; layer norms
    and MoE weights whole; every one split over the depth by ``fsdp``."""
    sub = name.rsplit(".", 2)
    leaf, mod = sub[-1], sub[-2]
    if ".attn." in name or ".ff." in name:
        if leaf == "weight" and mod in ("qkv", "w1") and ".moe." not in name:
            return PL.Spec(fsdp, (tp, None))
        if leaf == "weight" and mod in ("out", "w2") and ".moe." not in name:
            return PL.Spec(fsdp, (None, tp))
        if leaf == "bias" and mod == "w1":
            return PL.Spec(fsdp, (tp,))
    return PL.Spec(fsdp)


def _fit(spec: PL.Spec, shape, depth: Optional[int], mesh) -> PL.Spec:
    """``spec`` with each axis that does not divide its dimension (or the
    depth) dropped to whole (JAX's ``mesh=`` fallback, ``:206-213``)."""
    dims = tuple(a if a is None or shape[i] % mesh.size(a) == 0 else None
                 for i, a in enumerate(spec.dims))
    layers = spec.layers
    if layers is not None and depth % mesh.size(layers):
        layers = None
    return dataclasses.replace(spec, layers=layers, dims=dims)


def dalle_param_specs(model: torch.nn.Module, tp: Optional[str] = None,
                      fsdp: Optional[str] = None, mesh=None) -> dict:
    """{parameter name: ``placement.Spec``} for a DALLE (or a bare
    ``Transformer``): JAX's ``dalle_param_specs`` (``train.py:201-215``).
    Megatron over ``tp`` (qkv and w1 column-parallel, out and w2
    row-parallel, one psum after each), the vocabulary head
    column-parallel, the embeddings and layer norms whole, and every
    layer parameter stored over ``fsdp`` in contiguous blocks of layers.
    With ``mesh``, an axis that does not divide its dimension falls back
    to whole; without it, ``setup_sharded`` refuses such a spec."""
    depth = len(PL.stack_of(model))
    out = {}
    for name, p in model.named_parameters():
        if PL.layer_of(name) is not None:
            spec = _layer_spec(name, tp, fsdp)
        elif name == "logits_proj.weight":
            spec = PL.Spec(None, (tp, None))
        elif name == "logits_proj.bias":
            spec = PL.Spec(None, (tp,))
        else:
            spec = PL.REPLICATED
        out[name] = _fit(spec, p.shape, depth, mesh) if mesh is not None \
            else spec
    return out


def dalle_moe_param_specs(model: torch.nn.Module, axis: str = "ep") -> dict:
    """{parameter name: ``placement.Spec``}: the MoE expert stacks split
    over ``axis`` on their expert dimension, the router and everything
    else whole (JAX's ``dalle_moe_param_specs``, ``train.py:218-228``).
    Every rank holds the same tokens, so routing and capacity are the
    same on every rank; each runs its E/ep experts and the combine is one
    psum over ``axis`` (``ops/moe.py``)."""
    from dalle_pytorch_tpu_torch.ops.moe import moe_param_specs
    out = {name: PL.REPLICATED for name, _ in model.named_parameters()}
    found = False
    for name in list(out):
        head, _, leaf = name.rpartition(".ff.moe.")
        if head and PL.layer_of(name) is not None:
            out[name] = moe_param_specs(axis)[leaf]
            found = True
    if not found:
        raise KeyError("moe")
    return out


def setup_sharded(model: torch.nn.Module, optimizer: Optimizer, mesh,
                  param_specs: Optional[dict] = None):
    """Place ``model``'s parameters and ``optimizer``'s moments on the
    mesh, in place; returns (model, optimizer).

    Every tensor takes the values of the root of each mesh axis that
    does not split the depth of its parameter, so replicas start
    identical (a restored optimizer state is placed, not
    re-initialised). Under ``param_specs`` (``dalle_param_specs``,
    ``dalle_moe_param_specs``, ``pp_param_specs``) a rank then keeps
    only its pieces: the layers of other depth blocks go to the meta
    device and leave the optimizer, and each split dimension keeps this
    rank's slice, the moments following their parameter by name (never
    by shape). The modules learn their groups (``placement.attach``). A
    spec the mesh cannot place raises ``ValueError``."""
    specs = param_specs or {}
    PL.check(model, specs, mesh)
    moved = False
    if specs:
        stack = PL.stack_of(model)
        base = "transformer." if hasattr(model, "transformer") else ""
        for i, layer in enumerate(stack):
            # a layer's parameters share its depth split (placement.attach)
            name = f"{base}layers.{i}." + next(iter(
                dict(layer.named_parameters())))
            spec = PL.spec_of(specs, name)
            own = PL.owner(name, spec, mesh, len(stack))
            if own is not None and own != mesh.index(spec.layers):
                layer.to("meta")
                moved = True
    if moved:
        optimizer.retain(model)
    groups: dict = {}
    for name, p in model.named_parameters():
        if p.is_meta:
            continue
        spec = PL.spec_of(specs, name)
        axes = tuple(a for a in mesh.axis_names if a != spec.layers)
        state = optimizer.adam.state.get(p, {})
        groups.setdefault(axes, []).extend(
            [p] + [state[k] for k in ("exp_avg", "exp_avg_sq")
                   if k in state])
    for axes in sorted(groups, key=lambda k: (len(k), k), reverse=True):
        replicate(mesh, groups[axes], axes)
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = PL.spec_of(specs, name)
            if not any(mesh.size(a) > 1 for a in spec.dims if a):
                continue
            if p.is_meta:
                p.data = torch.empty(PL.local_shape(p.shape, spec, mesh),
                                     dtype=p.dtype, device="meta")
                continue
            state = optimizer.adam.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = PL.shard(state[k], name, spec, mesh)
            p.data = PL.shard(p.data, name, spec, mesh)
    if specs:
        PL.attach(model, specs, mesh)
    return model, optimizer


def checkpoint_state(model: torch.nn.Module, optimizer: Optimizer, ema,
                     mesh=None, param_specs: Optional[dict] = None):
    """What ``checkpoint.save`` writes: (model, optimizer, ema) as they
    are, or under a placement that splits parameters the whole trees,
    gathered in JAX's layout on the ranks of the first data-parallel
    rank (every one of them must call it; the others get None back). A
    checkpoint saved under tp, fsdp, ep or pp therefore resumes a
    one-process run, and the other way round."""
    specs = param_specs or {}
    if mesh is None or not PL.splits(specs, mesh):
        return model, optimizer, ema
    if mesh.index("dp") != 0:
        return None
    from dalle_pytorch_tpu_torch.compat import to_jax
    depth = len(PL.stack_of(model))
    full, mu, nu, em = {}, {}, {}, {}
    dev = next(q for q in model.parameters() if not q.is_meta).device
    for name, p in model.named_parameters():
        spec = PL.spec_of(specs, name)
        own = PL.owner(name, spec, mesh, depth)
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
            out[name] = PL.gather(t, name, spec, mesh, own)
    trees = (to_jax.tree(model, full),
             optimizer.state_tree(model, (mu, nu)),
             to_jax.tree(model, em) if ema is not None else None)
    return trees
