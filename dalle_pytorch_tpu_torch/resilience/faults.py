"""Deterministic fault injection for bring-up, the training loop and
the replica set.

Port of ``dalle_pytorch_tpu/resilience/faults.py``: the training hooks
(``maybe_activate_from_env`` ``:227``, ``on_backend_init`` ``:259-270``,
``maybe_signal``, ``corrupt_batch`` and ``corrupt_loss`` ``:271-310``),
the replica set's (``on_replica_chunk`` ``:324``, ``on_scale_add_bringup``
``:493``, ``on_upgrade_drain`` ``:509``, ``on_migrate_transfer``
``:535``, ``on_migrate_import`` ``:561``, ``on_canary_gate`` ``:577``,
``on_replica_bringup`` ``:619``), the process workers' hard and
network rows (``child_plan_for`` ``:347``, ``on_worker_chunk``
``:370-490``) and the gateway's (``on_gateway_dispatch`` and
``gateway_flood`` ``:592-615``). A ``FaultPlan`` names the faults to fire; the hooks are
no-ops unless a plan is active (set by ``activate``/``injected``, or from
the ``DALLE_FAULTS`` JSON environment variable in a CLI run), and each
fault fires at most once per activation.

A worker process gets its plan from the parent at spawn, once per
activation per replica (``child_plan_for``): the hard rows kill the child
for real, and fire-once must live in the process that survives them.
The two SIGKILL rows of the set (``upgrade_drain_sigkill_replica``,
``migrate_crash_source_at_transfer``) kill a child process; a thread
replica has none, and there they raise ``FaultInjected``.
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
    # process workers (serve/worker.py), fault_replica only: the worker
    # kills itself with a real SIGKILL or SIGSEGV once it has dispatched
    # this many chunks; allocates real memory until its RSS watchdog
    # exits 137 (needs the set's child_rss_limit_mb); emits one corrupt
    # frame
    replica_sigkill_at_chunk: int = -1
    replica_segv_at_chunk: int = -1
    replica_oom_at_chunk: int = -1
    replica_garbage_frame_at_chunk: int = -1
    # the network rows: half a frame then an RST (socket), half a frame
    # then a FIN (socket), silent for replica_hang_s with the connection
    # open, one frame delivered twice, two frames swapped
    replica_conn_reset_at_chunk: int = -1
    replica_torn_frame_at_chunk: int = -1
    replica_stall_socket_at_chunk: int = -1
    replica_dup_frame_at_chunk: int = -1
    replica_reorder_frames_at_chunk: int = -1
    # the gateway (serve/gateway.py): once it has routed this many
    # requests, the cell that took the latest one dies whole, and the
    # gateway must fence it and replay what it held on a survivor;
    # tenant_flood names an abusive tenant and its burst, which the
    # isolation check reads through gateway_flood() and sends itself.
    # -1/"" = off; each fires at most once per activation
    gateway_cell_down_at_request: int = -1
    tenant_flood: str = ""
    tenant_flood_requests: int = 0


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


def child_plan_for(replica: int) -> Optional[dict]:
    """The active plan as a dict for ``replica``'s worker spawn, at most
    once per activation per replica: a restarted child must come up
    clean, or a hard kill would fire forever."""
    p = _active
    if p is None or replica != p.fault_replica:
        return None
    if not _once(f"child_plan_{replica}"):
        return None
    return dataclasses.asdict(p)


# held at module level: the injected OOM's allocations must outlive the
# hook until the watchdog (or the kernel) ends the process
_oom_ballast: list = []


def on_worker_chunk(replica: int, chunk: int, *, emit_frame=None,
                    rss_limit_mb: int = 0, rss_mb=None, transport=None,
                    sender=None) -> None:
    """In a process worker's loop before each step: the rows only a
    process survives being injected with. A real ``os.kill`` (SIGKILL or
    SIGSEGV) of the worker; 64 MiB allocations, touched, until ``rss_mb()``
    passes ``rss_limit_mb`` (at most 256 of them); one garbage frame
    through ``emit_frame``; and the network rows through ``transport``
    (``send_partial_frame``, ``reset_hard``) and ``sender`` (its sequence
    number). ``fault_replica`` only, once each."""
    p = _active
    if p is None or replica != p.fault_replica:
        return
    if p.replica_sigkill_at_chunk >= 0 \
            and chunk >= p.replica_sigkill_at_chunk \
            and _once("worker_sigkill"):
        os.kill(os.getpid(), signal.SIGKILL)
    if p.replica_segv_at_chunk >= 0 \
            and chunk >= p.replica_segv_at_chunk \
            and _once("worker_segv"):
        os.kill(os.getpid(), signal.SIGSEGV)
    if p.replica_oom_at_chunk >= 0 \
            and chunk >= p.replica_oom_at_chunk \
            and _once("worker_oom"):
        if not rss_limit_mb or rss_mb is None:
            raise FaultInjected(
                "replica_oom_at_chunk fired but the worker has no RSS "
                "limit to exhaust — run the replica set with "
                "child_rss_limit_mb set, or this fault proves nothing")
        import numpy as np
        for _ in range(256):            # a hard cap: never OOM the host
            if rss_mb() > rss_limit_mb:
                return                  # the watchdog kills next
            _oom_ballast.append(np.ones((64, 1024, 1024), np.uint8))
        raise FaultInjected(
            f"allocated {len(_oom_ballast) * 64} MiB without crossing "
            f"rss_limit_mb={rss_limit_mb} — limit too high to exercise")
    if p.replica_garbage_frame_at_chunk >= 0 \
            and chunk >= p.replica_garbage_frame_at_chunk \
            and emit_frame is not None and _once("worker_garbage"):
        emit_frame(b"\xde\xad\xbe\xef not a frame")

    def heartbeat_frame(seq: int) -> bytes:
        from dalle_pytorch_tpu_torch.serve import ipc
        return ipc.encode_frame(ipc.HEARTBEAT, {"snap": None}, seq)

    def need_socket(fault: str) -> None:
        if getattr(transport, "kind", "") != "socket":
            raise FaultInjected(
                f"{fault} fired but the worker is not on a socket "
                f"transport — a pipe has no stream tearing to inject; "
                f"run with transport='socket', or this fault proves "
                f"nothing")

    if p.replica_conn_reset_at_chunk >= 0 \
            and chunk >= p.replica_conn_reset_at_chunk \
            and sender is not None and _once("worker_conn_reset"):
        need_socket("replica_conn_reset_at_chunk")
        frame = heartbeat_frame(sender.seq)
        transport.send_partial_frame(frame, len(frame) // 2)
        transport.reset_hard()
    if p.replica_torn_frame_at_chunk >= 0 \
            and chunk >= p.replica_torn_frame_at_chunk \
            and sender is not None and _once("worker_torn_frame"):
        need_socket("replica_torn_frame_at_chunk")
        # the split lands inside the ipc header
        frame = heartbeat_frame(sender.seq)
        transport.send_partial_frame(frame, 3)
        transport.close()
    if p.replica_stall_socket_at_chunk >= 0 \
            and chunk >= p.replica_stall_socket_at_chunk \
            and _once("worker_stall"):
        time.sleep(p.replica_hang_s)
    if p.replica_dup_frame_at_chunk >= 0 \
            and chunk >= p.replica_dup_frame_at_chunk \
            and emit_frame is not None and sender is not None \
            and _once("worker_dup"):
        frame = heartbeat_frame(sender.seq)
        sender.seq += 1
        emit_frame(frame)
        emit_frame(frame)
    if p.replica_reorder_frames_at_chunk >= 0 \
            and chunk >= p.replica_reorder_frames_at_chunk \
            and emit_frame is not None and sender is not None \
            and _once("worker_reorder"):
        a = sender.seq
        sender.seq += 2
        emit_frame(heartbeat_frame(a + 1))
        emit_frame(heartbeat_frame(a))


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
    """Just before ``rolling_upgrade`` drains ``replica``: a real SIGKILL
    of its child process, and a pause for the death to become visible
    (the drain finds a corpse). A thread replica has none (``pid``
    None), and a fault that cannot fire must not pass vacuously: it
    raises instead."""
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


def on_gateway_dispatch(dispatched: int) -> bool:
    """Called by the gateway after each routing decision with the count
    of requests routed so far: True exactly once, when
    ``gateway_cell_down_at_request`` is reached (the gateway then kills
    the cell the latest request landed on)."""
    p = _active
    if p is None or p.gateway_cell_down_at_request < 0:
        return False
    return dispatched >= p.gateway_cell_down_at_request \
        and _once("gateway_cell_down")


def gateway_flood() -> Optional[dict]:
    """``{"tenant": name, "requests": burst}`` once when
    ``tenant_flood`` is set, else None: the caller sends the flood (the
    gateway submits nothing on its own); the plan records who flooded
    and how hard."""
    p = _active
    if p is None or not p.tenant_flood or not _once("tenant_flood"):
        return None
    return {"tenant": str(p.tenant_flood),
            "requests": int(p.tenant_flood_requests)}


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
