"""Per-step keys, the learning-rate schedule and the optimizer.

Port of three functions of ``dalle_pytorch_tpu/cli/common.py``:
``step_rng`` (``:266``), ``resolve_schedule`` (``:277``) and
``make_optimizer`` (``:307``). ``args`` carries the JAX CLI's flag names
(``lr``, ``lr_schedule`` 'constant' | 'cosine', ``warmup_steps``,
``decay_steps``, ``lr_end_ratio``, ``n_epochs``, ``clip_grad_norm``);
the CLIs themselves are a later slice.

The optimizer is Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root; ``torch.optim.Adam`` computes the same update,
``lr * m_hat / (sqrt(v_hat) + eps)``), under optax's schedules evaluated
at the update count: update ``i`` (from 0) uses ``schedule(i)``, so a
warm-up from 0 makes the first update zero, as in optax. The optional
global-norm clip is ``torch.nn.utils.clip_grad_norm_``, which scales by
``max_norm / (norm + 1e-6)`` where optax's ``clip_by_global_norm``
scales by ``max_norm / norm``: a relative difference of ``1e-6 / norm``
whenever the clip acts.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Iterable, Optional

import torch

from dalle_pytorch_tpu_torch.ops import prng


def step_rng(key: torch.Tensor, step: int) -> torch.Tensor:
    """``fold_in(key, step)``: the key of training step ``step``."""
    return prng.fold_in(key, step)


def resolve_schedule(args, steps_per_epoch: int = 0, start_epoch: int = 0,
                     resume_meta: Optional[dict] = None) -> dict:
    """The learning-rate schedule in effect, as a JSON-safe snapshot. The
    cosine horizon is, in order: an explicit ``decay_steps``, the one
    persisted in ``resume_meta['lr_schedule']``, or the whole run
    ``(start_epoch + n_epochs) * steps_per_epoch - warmup_steps``."""
    snap = (resume_meta or {}).get("lr_schedule") or {}
    decay = 0
    if args.lr_schedule == "cosine":
        decay = args.decay_steps or int(snap.get("decay_steps") or 0) \
            or max((start_epoch + args.n_epochs) * steps_per_epoch
                   - args.warmup_steps, 1)
        if snap.get("decay_steps") and args.decay_steps \
                and int(snap["decay_steps"]) != args.decay_steps:
            print(f"warning: --decay_steps {args.decay_steps} overrides "
                  f"the resumed run's horizon ({snap['decay_steps']} "
                  f"steps)", file=sys.stderr, flush=True)
    return {"schedule": args.lr_schedule, "lr": args.lr,
            "warmup_steps": args.warmup_steps, "decay_steps": decay,
            "lr_end_ratio": args.lr_end_ratio,
            "epochs_total": int(snap.get("epochs_total")
                                or (start_epoch + args.n_epochs))}


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: init + (end - init) * min(max(count, 0), steps) \
        / steps


def _warmup_cosine(peak: float, warmup: int, decay_steps: int,
                   end: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end): linear warm-up, then cosine from peak to end over
    ``decay_steps - warmup`` updates."""
    warm = _linear(0.0, peak, warmup)
    horizon = decay_steps - warmup
    alpha = end / peak

    def cosine(count: int) -> float:
        count = min(count, horizon)
        c = 0.5 * (1.0 + math.cos(math.pi * count / horizon))
        return peak * ((1.0 - alpha) * c + alpha)

    return lambda count: warm(count) if count < warmup \
        else cosine(count - warmup)


class Optimizer:
    """Adam under a schedule, with an optional global-norm clip. ``step``
    applies the gradients the parameters hold, advances the schedule and
    clears the gradients."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], clip: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def step(self) -> None:
        if self.clip > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1


def make_optimizer(args, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 0, start_epoch: int = 0,
                   schedule: Optional[dict] = None) -> Optimizer:
    """Adam over ``params`` under the requested schedule, with
    ``args.clip_grad_norm`` > 0 adding the global-norm clip. ``schedule``
    is a ``resolve_schedule`` snapshot, resolved from the flags when
    None."""
    if schedule is None:
        schedule = resolve_schedule(args, steps_per_epoch, start_epoch)
    if args.lr_schedule == "constant" and not args.warmup_steps:
        sched = lambda count: args.lr                       # noqa: E731
    elif args.lr_schedule == "constant":
        sched = _linear(0.0, args.lr, args.warmup_steps)
    else:
        sched = _warmup_cosine(
            args.lr, args.warmup_steps,
            args.warmup_steps + schedule["decay_steps"],
            args.lr * args.lr_end_ratio)
    return Optimizer(params, sched, getattr(args, "clip_grad_norm", 0.0))
