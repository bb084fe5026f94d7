"""The training step on one device.

Port of ``dalle_pytorch_tpu/parallel/train.py``'s ``make_train_step``
(``:32``), ``accumulate_grads`` (``:79``) and ``dalle_loss_fn``
(``:257``), the step ``bench.py::setup_train`` and ``time_steps`` drive.
There is no jit and no sharding: the step runs eagerly on the model's
device, and the parameters and the optimizer's moments update in place
(where JAX returns new trees). The ``lr_scale`` batch entry of the
resilience supervisor is a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from dalle_pytorch_tpu_torch.cli.common import Optimizer
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import prng


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    grad_accum: int = 1) -> Callable:
    """``step(model, batch, rng) -> loss``: gradients of
    ``loss_fn(model, batch, rng)``, one optimizer update, the loss
    detached. ``grad_accum > 1`` averages the gradients of that many
    microbatches (``accumulate_grads``) before the one update."""

    def step(model, batch: dict, rng: torch.Tensor) -> torch.Tensor:
        if grad_accum <= 1:
            loss = loss_fn(model, batch, rng)
            loss.backward()
        else:
            loss = accumulate_grads(loss_fn, model, batch, rng, grad_accum)
        optimizer.step()
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
