"""Supervised training: preemption checkpoints, auto-resume, loss-spike
rollback — the step protocol the training CLIs share.

Port of ``dalle_pytorch_tpu/resilience/supervisor.py``. Around every
step of ``cli/common.py::run_supervised_loop``:

  * ``pre_step``   — the fault hooks (simulated SIGTERM, NaN batch) and,
                     after a rollback, the learning-rate re-warm as the
                     batch's ``lr_scale`` (``parallel/train.py``'s step
                     scales that update by it);
  * ``check_step`` — NaN/Inf and loss-spike detection against a running
                     median; a bad step returns ``ROLLBACK`` and the CLI
                     restores the newest valid anchor checkpoint,
                     bounded by ``max_rollbacks``;
  * ``end_step``   — cadence checkpoints (``{name}-step{N}``), retention
                     GC, and preemption: a SIGTERM/SIGINT sets a flag,
                     the step in flight finishes, one checkpoint is
                     written and ``Preempted`` unwinds the loop.

``find_auto_resume`` compares mid-epoch step checkpoints with epoch
checkpoints by training progress and returns the newest valid one.
Every event is a ``utils/metrics.py::structured_event`` record. With the
CLI's ``save_state`` writing the whole training state, the seeded
per-epoch data order and ``fold_in(key, global_step)`` keys, an
interrupted and resumed run equals an uninterrupted one bit for bit.
"""

from __future__ import annotations

import math
import signal
import statistics
import threading
from collections import deque
from typing import Callable, Optional

from dalle_pytorch_tpu_torch.resilience import faults


def _ckpt():
    from dalle_pytorch_tpu_torch import checkpoint
    return checkpoint


class Preempted(Exception):
    """Raised by ``end_step`` after the preemption checkpoint commits; the
    CLI catches it and exits cleanly. ``path`` is the saved checkpoint."""

    def __init__(self, path: Optional[str]):
        super().__init__(f"preempted; state saved to {path!r}")
        self.path = path


class TrainingDiverged(FloatingPointError):
    """Non-finite/spiking loss with no valid checkpoint to roll back to,
    or the rollback budget is exhausted."""


def _progress_key(manifest: dict, epoch_from_name: Optional[int]):
    """Order checkpoints by training progress: an epoch-``e`` checkpoint
    means "epochs through e complete" -> (e+1, 0); a step checkpoint's
    manifest meta carries (epoch, step_in_epoch) directly."""
    meta = manifest.get("meta", {}) or {}
    if "step_in_epoch" in meta and "epoch" in meta:
        return (int(meta["epoch"]), int(meta["step_in_epoch"]))
    e = meta.get("epoch", epoch_from_name)
    return (int(e) + 1, 0) if e is not None else (0, 0)


def find_auto_resume(models_dir: str, name: str):
    """Newest VALID checkpoint for ``name`` — step (mid-epoch) and epoch
    checkpoints compared by training progress. Returns (path, manifest) or
    None. Invalid candidates (truncated payloads, missing manifests) are
    skipped by ``checkpoint.validate``; stray ``.ckpt-tmp-*`` staging dirs
    from a killed writer never match either name template."""
    candidates = []
    found = _ckpt().latest_valid(models_dir, name)
    if found is not None:
        path, epoch = found
        candidates.append((path, epoch))
    found = _ckpt().latest_valid_step(models_dir, name)
    if found is not None:
        candidates.append((found[0], None))
    best = None
    for path, epoch in candidates:
        try:
            manifest = _ckpt().load_manifest(path)
        except (OSError, ValueError):
            continue
        key = _progress_key(manifest, epoch)
        if best is None or key > best[0]:
            best = (key, path, manifest)
    return (best[1], best[2]) if best is not None else None


class TrainSupervisor:
    OK = "ok"
    ROLLBACK = "rollback"

    def __init__(self, *, name: str, models_dir: str,
                 save_state: Callable[[str], str],
                 metrics=None,
                 save_every: int = 0, keep: int = 3,
                 spike_factor: float = 0.0, spike_window: int = 16,
                 max_rollbacks: int = 2, rewarm_steps: int = 0):
        self.name = name
        self.models_dir = models_dir
        self.save_state = save_state
        self.metrics = metrics
        self.save_every = max(int(save_every), 0)
        self.keep = max(int(keep), 1)
        self.spike_factor = float(spike_factor)
        self.spike_window = max(int(spike_window), 4)
        self.max_rollbacks = int(max_rollbacks)
        self.rewarm_steps = max(int(rewarm_steps), 0)
        self._losses: deque = deque(maxlen=self.spike_window)
        self._anchors: list = []        # rollback candidates, oldest first
        self._rollbacks = 0
        self._rewarm_from: Optional[int] = None
        self._preempted = threading.Event()
        self._prev_handlers: dict = {}
        self._signals = 0
        faults.maybe_activate_from_env()

    # -- signals -----------------------------------------------------------

    def install_signal_handlers(self) -> "TrainSupervisor":
        """SIGTERM/SIGINT -> preemption flag (checkpoint after the current
        step); a SECOND signal falls through to the previous handler so a
        wedged save can still be killed. Main thread only (signal module
        contract) — a no-op elsewhere."""
        if threading.current_thread() is not threading.main_thread():
            return self

        def handler(signum, frame):
            self._signals += 1
            if self._signals > 1:
                prev = self._prev_handlers.get(signum)
                if callable(prev):
                    prev(signum, frame)
                else:
                    raise KeyboardInterrupt
                return
            self._preempted.set()
            self._emit("preempt_signal", signum=int(signum))

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, handler)
        return self

    def close(self) -> None:
        """Restore the pre-install signal handlers (so repeated in-process
        CLI runs — tests — do not stack supervisors)."""
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    # -- the per-step protocol --------------------------------------------

    def pre_step(self, step: int, batch):
        """Fault hooks + LR re-warm. Call right before the train step with
        the sharded batch; returns the (possibly fault-poisoned) batch,
        with an ``lr_scale`` float added every step when re-warm is
        configured (1.0 outside a re-warm window)."""
        faults.maybe_signal(step)
        batch = faults.corrupt_batch(batch, step)
        if self.rewarm_steps > 0 and isinstance(batch, dict):
            batch = dict(batch)
            batch["lr_scale"] = self.lr_scale(step)
        return batch

    def lr_scale(self, step: int) -> float:
        """1.0 normally; after a rollback at step s, a linear ramp from
        1/(rewarm_steps+1) back to 1.0 over ``rewarm_steps`` steps — the
        optimizer re-approaches the spike region gently."""
        if self.rewarm_steps <= 0 or self._rewarm_from is None:
            return 1.0
        frac = (step - self._rewarm_from) / (self.rewarm_steps + 1)
        if frac >= 1.0:
            self._rewarm_from = None
            return 1.0
        return max(frac, 1.0 / (self.rewarm_steps + 1))

    def check_step(self, step: int, loss: float) -> str:
        """OK, or ROLLBACK when the loss is NaN/Inf or spikes past
        ``spike_factor`` x the running median. On ROLLBACK the caller
        restores from ``self.rollback_target`` (set here, newest VALID
        anchor) and continues FORWARD through the data — every step
        since that anchor is discarded (the save cadence bounds the
        loss), as in the JAX package. No anchor / exhausted budget raises
        TrainingDiverged."""
        # loss-level fault injection (nan_loss_at_step): the hook that
        # reaches training paths whose batches have no float leaves
        loss = faults.corrupt_loss(loss, step)
        bad_reason = None
        if not math.isfinite(loss):
            bad_reason = f"non-finite loss {loss}"
        elif (self.spike_factor > 0
              and len(self._losses) >= self.spike_window // 2):
            med = statistics.median(self._losses)
            if med > 0 and loss > self.spike_factor * med:
                bad_reason = (f"loss spike {loss:.4g} > "
                              f"{self.spike_factor:g} x median {med:.4g}")
        if bad_reason is None:
            self._losses.append(loss)
            return self.OK

        target = self.rollback_target()
        if target is None:
            self._emit("diverged", step=step, reason=bad_reason,
                       detail="no valid checkpoint to roll back to")
            raise TrainingDiverged(
                f"step {step}: {bad_reason}; no valid checkpoint to roll "
                "back to (enable --save_every)")
        if self._rollbacks >= self.max_rollbacks:
            self._emit("diverged", step=step, reason=bad_reason,
                       detail=f"rollback budget ({self.max_rollbacks}) "
                              "exhausted")
            raise TrainingDiverged(
                f"step {step}: {bad_reason}; {self._rollbacks} rollbacks "
                "already spent — training is diverging, not glitching")
        self._rollbacks += 1
        if self.rewarm_steps > 0:
            self._rewarm_from = step
        self._emit("rollback", step=step, reason=bad_reason,
                   checkpoint=target, rollbacks=self._rollbacks,
                   rewarm_steps=self.rewarm_steps)
        return self.ROLLBACK

    def rollback_target(self) -> Optional[str]:
        """Newest registered anchor that still passes ``validate`` (the
        disk copy, not our memory of it, is what restore will read)."""
        for path in reversed(self._anchors):
            ok, _ = _ckpt().validate(path)
            if ok:
                return path
        return None

    def register_checkpoint(self, path: str) -> None:
        """Make ``path`` a rollback anchor (epoch saves call this too, so
        a fresh epoch boundary is always preferred over an older cadence
        checkpoint)."""
        if path in self._anchors:
            self._anchors.remove(path)
        self._anchors.append(path)

    def end_step(self, steps_done: int) -> None:
        """After the step committed and counters advanced (``steps_done`` =
        completed optimizer steps): cadence checkpoint + retention GC, then
        the preemption checkpoint + ``Preempted`` if a signal arrived."""
        saved = None
        if self.save_every and steps_done % self.save_every == 0:
            saved = self._save_step(steps_done, kind="cadence")
        if self._preempted.is_set():
            if saved is None:
                saved = self._save_step(steps_done, kind="preempt")
            self._emit("preempted", step=steps_done, checkpoint=saved)
            raise Preempted(saved)

    def _save_step(self, steps_done: int, kind: str) -> str:
        path = _ckpt().step_ckpt_path(self.models_dir, self.name, steps_done)
        path = self.save_state(path)
        self.register_checkpoint(path)
        removed = _ckpt().gc_steps(self.models_dir, self.name, self.keep)
        for r in removed:
            if r in self._anchors:
                self._anchors.remove(r)
        self._emit("step_checkpoint", step=steps_done, path=path,
                   trigger=kind, gc_removed=len(removed))
        return path

    # -- events ------------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        if self.metrics is not None:
            self.metrics.resilience(kind, **fields)
        else:
            from dalle_pytorch_tpu_torch.utils.metrics import structured_event
            print(structured_event(kind, **fields), flush=True)
