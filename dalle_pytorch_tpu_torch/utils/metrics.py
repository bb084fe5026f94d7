"""Training metrics: throughput counters and JSONL logging.

Port of ``dalle_pytorch_tpu/utils/metrics.py``: ``structured_event`` (the
resilience records) and ``MetricsLogger`` (per-step loss and units a
second, echoed to stdout every ``log_interval`` steps and appended as
JSONL). As in JAX, only the primary rank prints and writes (every rank
holds the same global loss), and the rate scales to the run: a rank
counts the units of its own batch, ``data_parallel`` ranks each read
different rows (the ranks of one sp or pp group the same ones), so the
run's rate is the rank's times ``data_parallel``, and the rate per chip
divides that by the ``n_devices`` ranks of the mesh.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


def structured_event(kind: str, **fields) -> dict:
    """The resilience record: every failure, retry, rollback, preemption
    and resume event has this one shape."""
    return {"time": time.time(), "event": "resilience", "kind": kind,
            **fields}


class MetricsLogger:
    """Per-step metrics with wall-clock throughput, echoed to stdout and
    appended as JSONL (one object per record)."""

    def __init__(self, path: Optional[str] = None, log_interval: int = 10,
                 n_devices: int = 1, data_parallel: int = 1):
        from dalle_pytorch_tpu_torch.parallel.multihost import is_primary
        self.primary = is_primary()
        self.path = path if self.primary else None
        self.n_devices = max(int(n_devices), 1)
        self.data_parallel = max(int(data_parallel), 1)
        self.log_interval = log_interval
        self._t_last = time.perf_counter()
        self._units_since = 0
        self._lock = threading.Lock()
        self._fh = None
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def _write(self, rec: dict) -> None:
        if not self.path:
            return
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def step(self, step: int, loss: float, *, epoch: Optional[int] = None,
             units: int = 0, unit_name: str = "tokens", **extra) -> None:
        """Call once per train step; prints and writes every
        ``log_interval`` steps. ``units`` is the step's work (tokens,
        images...)."""
        self._units_since += units
        if step % self.log_interval != 0:
            return
        now = time.perf_counter()
        dt = max(now - self._t_last, 1e-9)
        rate = self._units_since / dt * self.data_parallel
        rec = {
            "step": step, "loss": float(loss),
            f"{unit_name}_per_sec": round(rate, 2),
            f"{unit_name}_per_sec_per_chip": round(rate / self.n_devices,
                                                   2),
            "time": time.time(),
        }
        if epoch is not None:
            rec["epoch"] = epoch
        rec.update(extra)
        self._t_last = now
        self._units_since = 0
        head = f"epoch {epoch} " if epoch is not None else ""
        if not self.primary:
            return
        print(f"{head}step {step}  loss {rec['loss']:.6f}  "
              f"{rec[f'{unit_name}_per_sec_per_chip']:.1f} "
              f"{unit_name}/s/chip", flush=True)
        self._write(rec)

    def event(self, **fields) -> None:
        """Free-form record (epoch summaries, checkpoint writes...)."""
        self._write({"time": time.time(), **fields})

    def resilience(self, kind: str, **fields) -> None:
        """Structured failure/retry/rollback record: echoed to stdout and
        appended like any other event."""
        rec = structured_event(kind, **fields)
        detail = {k: v for k, v in rec.items() if k not in ("time", "event")}
        if not self.primary:
            return
        print(f"[resilience] {json.dumps(detail)}", flush=True)
        self._write(rec)
