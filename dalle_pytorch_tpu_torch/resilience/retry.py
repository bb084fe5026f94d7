"""Bring-up under a deadline, with backoff and jitter.

Port of ``dalle_pytorch_tpu/resilience/retry.py`` (``:33-156``): the
serving front end claims its device through ``retry_with_backoff``, so a
claim that hangs or fails surfaces as a structured ``BringupError``
instead of a hung server.

* ``call_with_deadline`` runs the claim in a daemon thread and raises
  ``DeadlineExceeded`` if it does not finish in time (the thread is
  abandoned: a pending claim cannot be cancelled);
* ``retry_with_backoff`` retries with exponential backoff and jitter,
  handing a ``bringup_retry`` record per failure to ``on_event``;
* ``BringupError`` carries the terminal ``bringup_failure`` record.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional, Sequence

from dalle_pytorch_tpu_torch.utils.metrics import structured_event


class DeadlineExceeded(TimeoutError):
    """A bring-up attempt did not finish inside its deadline."""


class BringupError(RuntimeError):
    """Terminal bring-up failure; ``record`` describes every attempt."""

    def __init__(self, record: dict):
        super().__init__(
            f"{record.get('label', 'bring-up')} failed after "
            f"{record.get('attempts')} attempt(s): "
            f"{(record.get('errors') or ['?'])[-1]}")
        self.record = record


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``deadline_s`` bounds each attempt (None: no deadline); the wait
    after attempt ``a`` is ``min(base * multiplier**a, max_backoff)``
    scaled by a uniform draw in ``[1 - jitter, 1 + jitter]``."""
    max_attempts: int = 3
    deadline_s: Optional[float] = 600.0
    base_backoff_s: float = 5.0
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 120.0
    jitter: float = 0.25

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        base = min(self.base_backoff_s * self.backoff_multiplier ** attempt,
                   self.max_backoff_s)
        if self.jitter <= 0:
            return base
        r = rng if rng is not None else random
        return base * r.uniform(1.0 - self.jitter, 1.0 + self.jitter)


def failure_record(label: str, errors: Sequence[str], attempts: int,
                   elapsed_s: float, **extra) -> dict:
    """The structured record of a terminal bring-up failure."""
    return structured_event("bringup_failure", label=label,
                            attempts=attempts, errors=list(errors),
                            elapsed_s=round(elapsed_s, 3), **extra)


def call_with_deadline(fn: Callable, deadline_s: Optional[float],
                       label: str = "bring-up"):
    """``fn()`` in a daemon thread, waited for at most ``deadline_s``:
    its result, or its exception re-raised, or ``DeadlineExceeded``.
    ``deadline_s`` None or <= 0 calls ``fn`` inline."""
    if not deadline_s or deadline_s <= 0:
        return fn()
    box: dict = {}

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:          # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True,
                         name=f"deadline:{label}")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        raise DeadlineExceeded(
            f"{label} did not finish within {deadline_s:g} s")
    if "error" in box:
        raise box["error"]
    return box.get("result")


def retry_with_backoff(fn: Callable, policy: RetryPolicy, *,
                       label: str = "bring-up",
                       on_event: Optional[Callable[[dict], None]] = None,
                       rng: Optional[random.Random] = None,
                       sleep: Callable[[float], None] = time.sleep):
    """``fn(attempt)`` under ``policy``: each attempt deadline-bounded,
    failures retried after a jittered exponential backoff. Exhausted
    attempts raise ``BringupError``."""
    errors: list = []
    t0 = time.monotonic()
    for attempt in range(max(policy.max_attempts, 1)):
        try:
            return call_with_deadline(lambda: fn(attempt),
                                      policy.deadline_s, label)
        except (KeyboardInterrupt, SystemExit):
            # an operator abort exits now, not after max_attempts sleeps
            raise
        except BaseException as e:          # noqa: BLE001 — recorded, rethrown
            errors.append(f"{type(e).__name__}: {e}")
            if attempt < max(policy.max_attempts, 1) - 1:
                delay = policy.backoff(attempt, rng)
                if on_event is not None:
                    on_event(structured_event(
                        "bringup_retry", label=label, attempt=attempt + 1,
                        error=errors[-1], backoff_s=round(delay, 3)))
                sleep(delay)
    record = failure_record(label, errors, max(policy.max_attempts, 1),
                            time.monotonic() - t0,
                            deadline_s=policy.deadline_s)
    if on_event is not None:
        on_event(record)
    raise BringupError(record)
