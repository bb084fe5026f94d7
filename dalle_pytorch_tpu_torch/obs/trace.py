"""Per-request tracing: where did a request's milliseconds go?

Port of ``dalle_pytorch_tpu/obs/trace.py`` (``:41-197``). One ``Trace``
per submitted request, carried on its ``RequestHandle``: a TILING
sequence of spans, each starting where the previous one ended
(``span(name, now)`` records ``[last_t, now)``), so the span durations
sum to the latency the caller saw. The single engine stamps

  ``submit``         zero-length marker at queue admission
  ``queue_wait``     the queue wait, closed at the engine's pop
  ``prefill_admit``  pop -> slotted (cold prefill or warm admission)
  ``decode_chunk``   one harvested chunk's tokens
  ``evict``          a paged-pool eviction (the request replays)
  ``postprocess``    VAE decode and CLIP score

and a replica set adds ``route`` (the replica chosen), ``migrate_out``
/ ``migrate_in`` / ``migrate`` (a live slot migration) and
``replayed_from`` (``replay``: a failover's gap, opening the next
attempt). A process worker's stand-in handle traces in the child; its
spans ride the result frame home (``wire_spans``) and join the caller's
trace (``merge_wire``).

Timestamps are ``perf_counter`` values from the caller; spans are dicts
of JSON scalars.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

# the keys every span record has; the rest is per-span metadata
SPAN_KEYS = ("event", "span", "trace_id", "request_id", "attempt",
             "t0", "dur_s")


def new_trace_id(request_id: int) -> str:
    """The request id (unique per queue) and entropy (unique across
    queues and restarts)."""
    return f"{int(request_id) & 0xFFFFFFFF:08x}-{os.urandom(6).hex()}"


class Trace:
    """Append-only span timeline of ONE request; thread-safe (the engine
    and the postprocess worker stamp the same trace)."""

    __slots__ = ("trace_id", "request_id", "attempt", "_spans",
                 "_last_t", "_lock")

    def __init__(self, trace_id: str, request_id: int, t0: float,
                 attempt: int = 0):
        self.trace_id = str(trace_id)
        self.request_id = int(request_id)
        self.attempt = int(attempt)
        self._spans: List[dict] = []
        self._last_t = float(t0)
        self._lock = threading.Lock()

    def span(self, name: str, now: float, **meta) -> dict:
        """Record [last span's end, ``now``) under ``name`` and advance
        the tiling pointer. Returns the record (flight-recorder
        material)."""
        with self._lock:
            rec = {"event": "span", "span": str(name),
                   "trace_id": self.trace_id,
                   "request_id": self.request_id,
                   "attempt": self.attempt,
                   "t0": self._last_t,
                   "dur_s": max(float(now) - self._last_t, 0.0)}
            rec.update(meta)
            self._spans.append(rec)
            self._last_t = float(now)
            return rec

    def has_in_attempt(self, name: str) -> bool:
        """Was ``name`` stamped in the current attempt?"""
        with self._lock:
            for rec in reversed(self._spans):
                if rec["attempt"] != self.attempt:
                    break
                if rec["span"] == name:
                    return True
            return False

    def replay(self, now: float, reason: str = "", **meta) -> dict:
        """Mark a failover or migration-fallback replay: the gap since
        the last span goes under ``replayed_from`` (labelled, never
        credited to decode) and the next attempt opens. Returns the
        marker record."""
        with self._lock:
            prev = self.attempt
            self.attempt = prev + 1
            rec = {"event": "span", "span": "replayed_from",
                   "trace_id": self.trace_id,
                   "request_id": self.request_id,
                   "attempt": self.attempt,
                   "from_attempt": prev,
                   "t0": self._last_t,
                   "dur_s": max(float(now) - self._last_t, 0.0),
                   "reason": str(reason)}
            rec.update(meta)
            self._spans.append(rec)
            self._last_t = float(now)
            return rec

    def wire_spans(self) -> List[dict]:
        """A copy of the spans (JSON-scalar dicts): what a process worker
        attaches to a result frame."""
        with self._lock:
            return [dict(rec) for rec in self._spans]

    def merge_wire(self, spans, now: float) -> int:
        """Absorb a worker's spans into this trace and re-anchor the
        tiling pointer at ``now`` (the absorb time), where the next
        span (postprocess) starts. Malformed entries are skipped (an
        advisory field never fences a replica); returns how many
        merged."""
        merged = 0
        with self._lock:
            for rec in spans or ():
                if not isinstance(rec, dict) or "span" not in rec \
                        or "dur_s" not in rec:
                    continue
                rec = dict(rec)
                rec.setdefault("event", "span")
                rec["trace_id"] = self.trace_id
                self._spans.append(rec)
                merged += 1
            self._last_t = float(now)
        return merged

    def summary(self) -> dict:
        """What ``Result.trace`` (and the HTTP body) carries: spans
        summed by name in first-seen order, the replay edges and the sum
        of all spans, which tiles back to the caller's latency."""
        with self._lock:
            order: List[str] = []
            agg: dict = {}
            replays: List[dict] = []
            total = 0.0
            for rec in self._spans:
                name = rec["span"]
                dur = float(rec["dur_s"])
                total += dur
                if name not in agg:
                    order.append(name)
                    agg[name] = {"name": name, "n": 0, "total_s": 0.0}
                agg[name]["n"] += 1
                agg[name]["total_s"] += dur
                if name == "replayed_from":
                    replays.append({
                        "from_attempt": int(rec.get("from_attempt", 0)),
                        "reason": rec.get("reason", ""),
                        "gap_s": round(dur, 6)})
            for name in order:
                agg[name]["total_s"] = round(agg[name]["total_s"], 6)
            return {"trace_id": self.trace_id,
                    "request_id": self.request_id,
                    "attempts": self.attempt + 1,
                    "replays": replays,
                    "spans": [agg[n] for n in order],
                    "span_total_s": round(total, 6)}


def attach(handle, request_id: int, now: float,
           trace_id: Optional[str] = None, attempt: int = 0) -> Trace:
    """Create a trace and attach it to ``handle``."""
    tr = Trace(trace_id or new_trace_id(request_id), request_id,
               t0=now, attempt=attempt)
    handle.trace = tr
    return tr
