"""The training step on one device.

Port of ``dalle_pytorch_tpu/parallel/train.py``'s ``make_train_step``
(``:32``), ``accumulate_grads`` (``:79``) and the three models' loss
closures, ``vae_loss_fn`` (``:235``), ``dalle_loss_fn`` (``:257``) and
``clip_loss_fn`` (``:270``): the step ``bench.py::setup_train`` and
``time_steps`` drive.
There is no jit and no sharding: the step runs eagerly on the model's
device, and the parameters and the optimizer's moments update in place
(where JAX returns new trees). An optional scalar ``batch['lr_scale']``
(the resilience supervisor's re-warm after a NaN rollback) scales that
step's update, as JAX's step does; a missing key is a scale of 1.
"""

from __future__ import annotations

from typing import Callable

import torch

from dalle_pytorch_tpu_torch.cli.common import Optimizer
from dalle_pytorch_tpu_torch.models import clip as C
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.ops import prng


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    grad_accum: int = 1) -> Callable:
    """``step(model, batch, rng) -> loss``: gradients of
    ``loss_fn(model, batch, rng)``, one optimizer update, the loss
    detached. ``grad_accum > 1`` averages the gradients of that many
    microbatches (``accumulate_grads``) before the one update. A scalar
    ``batch['lr_scale']`` is taken out of (a copy of) the batch before
    the loss sees it, and multiplies this step's update (for Adam, its
    learning rate); the schedule still advances by one update."""

    def step(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        batch = dict(batch)
        lr_scale = batch.pop("lr_scale", None)
        if grad_accum <= 1:
            loss = loss_fn(model, batch, rng)
            loss.backward()
        else:
            loss = accumulate_grads(loss_fn, model, batch, rng, grad_accum)
        optimizer.step(1.0 if lr_scale is None else float(lr_scale))
        return loss.detach()

    return step


def accumulate_grads(loss_fn: Callable, model: torch.nn.Module, batch: dict,
                     rng: torch.Tensor, grad_accum: int) -> torch.Tensor:
    """Mean loss over ``grad_accum`` microbatches, leaving their mean
    gradient in the parameters' ``.grad``. Entries of ``batch`` with a
    leading axis split on it; other entries pass whole. Microbatch ``i``
    sees ``fold_in(rng, i)``. Gradients add up in f32 and are cast to
    each parameter's dtype once, at the end (bf16 sums would compound
    rounding as ``grad_accum`` grows)."""
    if not isinstance(batch, dict):
        raise TypeError("grad accumulation expects a dict batch")
    split = {k: v for k, v in batch.items() if getattr(v, "ndim", 0) >= 1}
    rest = {k: v for k, v in batch.items() if k not in split}
    for k, v in split.items():
        if v.shape[0] % grad_accum:
            raise ValueError(f"batch entry {k!r} of {v.shape[0]} rows does "
                             f"not split into {grad_accum} microbatches")
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


def clip_loss_fn() -> Callable:
    """``loss(clip, batch, rng)``: CLIP's InfoNCE loss on batch
    ``{'text': (b, t), 'images': (b, H, W, C), 'mask': optional (b, t)}``
    (no randomness: ``rng`` is unused)."""

    def loss(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        return C.clip_apply(model, batch["text"], batch["images"],
                            text_mask=batch.get("mask"), return_loss=True)

    return loss
