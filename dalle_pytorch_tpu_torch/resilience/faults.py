"""Deterministic fault injection for bring-up and the training loop.

Port of the training hooks of ``dalle_pytorch_tpu/resilience/faults.py``
(``maybe_activate_from_env`` ``:227``, ``on_backend_init`` ``:259-270``,
``maybe_signal``, ``corrupt_batch`` and ``corrupt_loss`` ``:271-310``).
A ``FaultPlan`` names the faults to fire; the hooks are no-ops unless a
plan is active (set by ``activate``/``injected``, or from the
``DALLE_FAULTS`` JSON environment variable in a CLI run), and each
training fault fires at most once per activation. The serving faults of
the JAX plan (replicas, workers, transports) are not ported: a plan
naming one is refused (``TypeError``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import time
from typing import Optional

import torch


class FaultInjected(RuntimeError):
    """Raised by hooks that simulate a hard failure."""


@dataclasses.dataclass
class FaultPlan:
    # backend bring-up: sleep (wedge) this long per claim attempt, and/or
    # raise on the first N attempts (0-indexed attempts < fail_attempts)
    backend_init_hang_s: float = 0.0
    backend_init_fail_attempts: int = 0
    # deliver SIGTERM to this process just before this step
    sigterm_at_step: int = -1
    # replace the batch's float leaves with NaN at this step
    nan_at_step: int = -1
    # report the STEP LOSS as NaN at this step (for batches with no float
    # leaves, such as train_dalle's token ids)
    nan_loss_at_step: int = -1


_active: Optional[FaultPlan] = None
_fired: set = set()

ENV = "DALLE_FAULTS"


def activate(plan: FaultPlan) -> FaultPlan:
    global _active
    _active = plan
    _fired.clear()
    return plan


def deactivate() -> None:
    global _active
    _active = None
    _fired.clear()


def maybe_activate_from_env() -> Optional[FaultPlan]:
    """Activate the plan of the ``DALLE_FAULTS`` JSON variable; a no-op
    when it is unset or a plan is already active."""
    if _active is not None:
        return _active
    raw = os.environ.get(ENV, "")
    if not raw:
        return None
    return activate(FaultPlan(**json.loads(raw)))


@contextlib.contextmanager
def injected(**kwargs):
    """``with faults.injected(nan_at_step=3): ...`` — scoped activation."""
    activate(FaultPlan(**kwargs))
    try:
        yield _active
    finally:
        deactivate()


def _once(key: str) -> bool:
    if key in _fired:
        return False
    _fired.add(key)
    return True


def on_backend_init(attempt: int = 0) -> None:
    """Inside the deadline-bounded device claim: wedge and/or fail."""
    p = _active
    if p is None:
        return
    if p.backend_init_hang_s > 0:
        time.sleep(p.backend_init_hang_s)
    if attempt < p.backend_init_fail_attempts:
        raise FaultInjected(
            f"injected backend init failure (attempt {attempt})")


def maybe_signal(step: int) -> None:
    """SIGTERM to this process before step ``sigterm_at_step``; the
    supervisor turns it into a preemption checkpoint."""
    p = _active
    if p is not None and step == p.sigterm_at_step and _once("sigterm"):
        os.kill(os.getpid(), signal.SIGTERM)


def corrupt_batch(batch, step: int):
    """NaN-poison every floating tensor of ``batch`` (a dict, list or
    tensor) at step ``nan_at_step``. A batch with no float leaves raises
    instead of consuming the one-shot fire (use ``nan_loss_at_step``)."""
    p = _active
    if p is None or step != p.nan_at_step or not _once("nan"):
        return batch
    poisoned = []

    def poison(x):
        if isinstance(x, dict):
            return {k: poison(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(poison(v) for v in x)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            poisoned.append(True)
            return torch.full_like(x, math.nan)
        return x

    out = poison(batch)
    if not poisoned:
        raise FaultInjected(
            f"nan_at_step={step} fired but the batch has no float leaves "
            "to poison (integer token ids?) — this fault cannot simulate "
            "a NaN loss on this training path; use nan_loss_at_step")
    return out


def corrupt_loss(loss: float, step: int) -> float:
    """NaN as the step loss at ``nan_loss_at_step`` (the supervisor's
    check calls it on every step's loss)."""
    p = _active
    if p is None or step != p.nan_loss_at_step or not _once("nan_loss"):
        return loss
    return float("nan")
