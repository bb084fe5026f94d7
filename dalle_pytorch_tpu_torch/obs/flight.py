"""The flight recorder: a bounded, always-on ring of recent structured
events and span records, served at ``GET /debug/events``.

Port of ``dalle_pytorch_tpu/obs/flight.py`` (``:41-125``). ``tail``
gives the replica set's typed refusals their recent context; ``since``
is what a process worker ships to the parent's mirror of its ring with
every snapshot frame (``serve/worker.py``). ``RecordingMetrics``
quacks like
``utils.metrics.MetricsLogger`` (``event``/``resilience``/``step``): it
lands every record in the ring and forwards it to the real sink when one
is configured, so the ring is on with no JSONL file.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional, Tuple

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded ring of recent records, each under a sequence number."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def record(self, rec: dict) -> dict:
        """Append a shallow copy of ``rec``."""
        rec = dict(rec)
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, rec))
        return rec

    def dump(self) -> List[dict]:
        """Everything retained, oldest first."""
        with self._lock:
            return [dict(rec) for _, rec in self._ring]

    def tail(self, n: int) -> List[dict]:
        """The newest ``n`` records, oldest of them first."""
        with self._lock:
            items = list(self._ring)[-max(int(n), 0):] if n > 0 else []
        return [dict(rec) for _, rec in items]

    def since(self, seq: int) -> Tuple[int, List[dict]]:
        """Records newer than ``seq`` -> (new seq, records). Records that
        rotated out between two calls are gone: the ring bounds the
        frames as well as the memory."""
        with self._lock:
            out = [dict(rec) for s, rec in self._ring if s > seq]
            return self._seq, out


class RecordingMetrics:
    """Tee every structured event into a ``FlightRecorder`` and forward
    it to the configured sink, if any."""

    def __init__(self, flight: FlightRecorder, inner=None):
        self.flight = flight
        self.inner = inner

    def event(self, **fields) -> None:
        self.flight.record(fields)
        if self.inner is not None:
            self.inner.event(**fields)

    def resilience(self, kind: str, **fields) -> None:
        from dalle_pytorch_tpu_torch.utils.metrics import structured_event
        self.flight.record(structured_event(kind, **fields))
        if self.inner is not None:
            self.inner.resilience(kind, **fields)

    def step(self, *args, **kwargs) -> None:
        # train-step records are not serve events: forward only
        if self.inner is not None:
            self.inner.step(*args, **kwargs)


def wrap_metrics(flight: FlightRecorder,
                 metrics: Optional[object]) -> RecordingMetrics:
    """Wrap ``metrics`` in a ring tee, never chaining two rings."""
    if isinstance(metrics, RecordingMetrics):
        metrics = metrics.inner
    return RecordingMetrics(flight, metrics)
