"""Deterministic fault injection for bring-up, the training loop and
the replica set.

Port of ``dalle_pytorch_tpu/resilience/faults.py``: the training hooks
(``maybe_activate_from_env`` ``:227``, ``on_backend_init`` ``:259-270``,
``maybe_signal``, ``corrupt_batch`` and ``corrupt_loss`` ``:271-310``)
and the serving hooks thread replicas reach (``on_replica_chunk``
``:324``, ``on_scale_add_bringup`` ``:493``, ``on_upgrade_drain``
``:509``, ``on_migrate_transfer`` ``:535``, ``on_migrate_import``
``:561``, ``on_canary_gate`` ``:577``, ``on_replica_bringup`` ``:619``).
A ``FaultPlan`` names the faults to fire; the hooks are no-ops unless a
plan is active (set by ``activate``/``injected``, or from the
``DALLE_FAULTS`` JSON environment variable in a CLI run), and each fault
fires at most once per activation. A thread replica has no process to
kill, so the two SIGKILL rows (``upgrade_drain_sigkill_replica``,
``migrate_crash_source_at_transfer``) raise ``FaultInjected`` there, as
JAX's hooks do on a thread set. The faults of child workers, transports
and the gateway come with process isolation (ROADMAP.md queue 1 item
2b): a plan naming one is refused (``TypeError``).
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
    # the replica set (serve/replica.py): the replica the faults below
    # target; crash (raise out of its loop) or hang (stall it for
    # replica_hang_s, so the heartbeat deadline trips) once it has
    # dispatched this many decode chunks; fail its first N bring-ups
    fault_replica: int = 0
    replica_crash_at_chunk: int = -1
    replica_hang_at_chunk: int = -1
    replica_hang_s: float = 30.0
    replica_flaky_bringup: int = 0
    # the elastic fleet: fail the first N bring-ups of a replica born
    # from add_replica; kill this replica as a rolling upgrade starts
    # draining it; fail the canary gate on this replica's new engine
    scale_add_bringup_crash: int = 0
    upgrade_drain_sigkill_replica: int = -1
    upgrade_canary_fail_replica: int = -1
    # live migration: kill the SOURCE replica as its slot snapshot is
    # asked for; the TARGET replica reports page exhaustion at import
    migrate_crash_source_at_transfer: int = -1
    migrate_reject_target: int = -1


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


# ---------------------------------------------------------------------------
# the replica set's hooks
# ---------------------------------------------------------------------------

def on_replica_chunk(replica: int, chunk: int) -> None:
    """Before each step of a replica's loop, with the decode chunks it has
    dispatched: ``replica_crash_at_chunk`` raises (the supervisor fences,
    reclaims and replays), ``replica_hang_at_chunk`` sleeps
    ``replica_hang_s`` outside the engine lock (the heartbeat stalls as
    on a wedged device sync). ``fault_replica`` only, once each."""
    p = _active
    if p is None or replica != p.fault_replica:
        return
    if p.replica_crash_at_chunk >= 0 \
            and chunk >= p.replica_crash_at_chunk \
            and _once("replica_crash"):
        raise FaultInjected(
            f"injected replica {replica} crash at chunk {chunk}")
    if p.replica_hang_at_chunk >= 0 \
            and chunk >= p.replica_hang_at_chunk \
            and _once("replica_hang"):
        time.sleep(p.replica_hang_s)


def on_scale_add_bringup(replica: int, attempt: int) -> None:
    """In the bring-up of a replica born from ``add_replica``: fail its
    first ``scale_add_bringup_crash`` attempts."""
    p = _active
    if p is None:
        return
    if attempt < p.scale_add_bringup_crash:
        raise FaultInjected(
            f"injected scale-out bring-up kill (replica {replica}, "
            f"attempt {attempt})")


def on_upgrade_drain(replica: int, pid: Optional[int]) -> None:
    """Just before ``rolling_upgrade`` drains ``replica``: SIGKILL its
    child process. A thread replica has none (``pid`` None), and a fault
    that cannot fire must not pass vacuously: it raises instead."""
    p = _active
    if p is None or replica != p.upgrade_drain_sigkill_replica \
            or not _once("upgrade_drain_sigkill"):
        return
    if pid is None:
        raise FaultInjected(
            "upgrade_drain_sigkill_replica fired but the replica has no "
            "child process to kill — run with isolation='process', or "
            "this fault proves nothing")
    os.kill(pid, signal.SIGKILL)
    time.sleep(0.3)         # let the death become observable


def on_migrate_transfer(replica: int, pid: Optional[int]) -> None:
    """Just before the supervisor asks ``replica`` (the migration SOURCE)
    for a slot snapshot: SIGKILL its child. On a thread replica it raises
    ``FaultInjected``, which the supervisor turns into the replay
    fallback."""
    p = _active
    if p is None or replica != p.migrate_crash_source_at_transfer \
            or not _once("migrate_crash_source"):
        return
    if pid is None:
        raise FaultInjected(
            "migrate_crash_source_at_transfer fired but the replica "
            "has no child process to kill — run with "
            "isolation='process', or this fault proves nothing")
    os.kill(pid, signal.SIGKILL)
    time.sleep(0.3)


def on_migrate_import(replica: int) -> None:
    """Just before a snapshot is offered to ``replica`` (the migration
    TARGET): with ``migrate_reject_target`` naming it, the target
    reports page exhaustion."""
    p = _active
    if p is None or replica != p.migrate_reject_target \
            or not _once("migrate_reject_target"):
        return
    raise FaultInjected(
        f"injected migration target rejection (replica {replica}: "
        f"page pool exhausted)")


def on_canary_gate(replica: int, version: str) -> None:
    """In ``rolling_upgrade``'s health gate, after ``replica``'s new
    engine answered its canaries: fail the gate for
    ``upgrade_canary_fail_replica``."""
    p = _active
    if p is None or replica != p.upgrade_canary_fail_replica \
            or not _once("upgrade_canary_fail"):
        return
    raise FaultInjected(
        f"injected canary health-gate failure (replica {replica}, "
        f"version {version!r})")


def on_replica_bringup(replica: int, attempt: int) -> None:
    """In the supervisor's bring-up: fail attempts below
    ``replica_flaky_bringup`` of ``fault_replica``'s lifetime count (the
    circuit breaker's exercise)."""
    p = _active
    if p is None or replica != p.fault_replica:
        return
    if attempt < p.replica_flaky_bringup:
        raise FaultInjected(
            f"injected replica {replica} bring-up failure "
            f"(attempt {attempt})")
