"""Live token streams: the channel between the engine thread and one
SSE writer.

Port of ``dalle_pytorch_tpu/serve/stream.py`` (``:37-317``). ``TokenSink``
is a bounded, thread-safe event channel: the engine's harvest pushes each
chunk's tokens at their ABSOLUTE sequence positions, the postprocess
worker pushes preview frames, ``RequestHandle.fulfill`` closes it. Three
rules:

* the engine never blocks on a slow consumer: a full ring sheds its
  OLDEST droppable event (tokens, preview), counts the drop and prefixes
  the consumer's next read with an ``overflow`` event naming the gap;
* replays deliver nothing twice: each sink keeps a high-water mark and
  drops positions below it, so an evicted request's replay streams each
  position once;
* terminal events are never dropped; a best-of-N group shares one
  channel across its sinks (``TokenSink.group``), which ends once every
  member has closed;
* a gateway's sinks are ``replayable``: a cell's cancelled close (the
  request is about to be replayed on another cell into the same sink)
  is ignored, and only the gateway's ``close(result, force=True)`` or a
  real completion ends the sample.

``sse_bytes`` frames an event for the wire; ``pack_image`` /
``unpack_image`` carry a pixel grid as base64 bytes, bit-exact.
"""

from __future__ import annotations

import base64
import threading
from collections import deque
from typing import Iterator, List, Optional

from dalle_pytorch_tpu_torch.utils.metrics import structured_event

# event kinds a consumer can see (heartbeats are generated by the
# reader when the channel is quiet — they are never queued, so a slow
# consumer can't drown in its own keepalives)
TOKENS = "tokens"
PREVIEW = "preview"
SAMPLE_DONE = "sample_done"
OVERFLOW = "overflow"
HEARTBEAT = "heartbeat"

# kinds the drop policy may discard under overflow; terminal events
# survive any backlog
_DROPPABLE = (TOKENS, PREVIEW)


def pack_image(img) -> dict:
    """A pixel grid as a JSON-safe dict (shape/dtype/base64 raw bytes)
    — exact: no float text round-trip, so the SSE final frame is
    bit-comparable to the non-streamed ``Result.image``."""
    import numpy as np
    a = np.ascontiguousarray(img)
    return {"shape": list(a.shape), "dtype": a.dtype.name,
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def unpack_image(d: dict):
    import numpy as np
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        [int(s) for s in d["shape"]])


def sse_bytes(event: dict) -> bytes:
    """One event in server-sent-events wire framing: ``event:`` names
    the kind, ``data:`` carries the JSON payload, a blank line ends
    the frame (the browser/EventSource contract)."""
    import json
    kind = event.get("event", "message")
    payload = {k: v for k, v in event.items() if k != "event"}
    return (f"event: {kind}\ndata: {json.dumps(payload)}\n\n").encode()


class _Channel:
    """The shared half of a sink (or of a group of sinks): one lock,
    one condition, one bounded event ring, one drop ledger, and the
    group-atomic close countdown."""

    def __init__(self, max_events: int, expected_closes: int,
                 metrics=None):
        if max_events < 4:
            raise ValueError(f"max_events must be >= 4, got "
                             f"{max_events}")
        if expected_closes < 1:
            raise ValueError(f"expected_closes must be >= 1, got "
                             f"{expected_closes}")
        # one Condition is both the channel lock and the consumer wakeup
        self.cond = threading.Condition()
        self.events: deque = deque()
        self.max_events = int(max_events)
        self.expected_closes = int(expected_closes)
        self.closed_n = 0
        self.closed = False
        self.dropped = 0            # lifetime drops (stats)
        self._unreported = 0        # drops since the last overflow event
        self.metrics = metrics

    def push(self, event: dict) -> None:
        """Producer side. Terminal events always land; droppable ones
        shed the oldest droppable entry when the ring is full — the
        engine thread returns immediately either way."""
        with self.cond:
            if self.closed:
                return
            terminal = event.get("event") not in _DROPPABLE
            if len(self.events) >= self.max_events:
                victim = None
                for k, e in enumerate(self.events):
                    if e.get("event") in _DROPPABLE:
                        victim = k
                        break
                if victim is not None:
                    del self.events[victim]
                elif not terminal:
                    # ring full of terminal events (pathological tiny
                    # ring): shed the NEWEST droppable — this one
                    self._drop(event)
                    return
                else:
                    self.events.append(event)
                    self.cond.notify_all()
                    return
                self._drop(None)
            self.events.append(event)
            self.cond.notify_all()

    def _drop(self, event) -> None:
        # under self.cond
        if self._unreported == 0 and self.metrics is not None:
            try:
                self.metrics.event(**structured_event(
                    "serve_stream_overflow",
                    max_events=self.max_events))
            except Exception:   # noqa: BLE001 — observability must
                pass            # never break the engine thread
        self.dropped += 1
        self._unreported += 1

    def close_one(self) -> None:
        with self.cond:
            self.closed_n += 1
            if self.closed_n >= self.expected_closes:
                self.closed = True
            self.cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Consumer side: the next event, a synthetic ``overflow``
        marker when drops happened since the last read, or None on
        timeout / end-of-stream (distinguish via ``done``)."""
        with self.cond:
            self.cond.wait_for(
                lambda: self.events or self.closed or self._unreported,
                timeout)
            if self._unreported:
                n, self._unreported = self._unreported, 0
                return {"event": OVERFLOW, "dropped": n,
                        "total_dropped": self.dropped}
            if self.events:
                return self.events.popleft()
            return None

    @property
    def done(self) -> bool:
        with self.cond:
            return self.closed and not self.events \
                and not self._unreported


class TokenSink:
    """One request's end of a stream channel. Attached to the
    ``RequestHandle`` by the server (``handle.sink``); the engine's
    harvest pushes into it, ``RequestHandle.fulfill`` closes it.

    A plain stream is a group of one. A best-of-N stream shares one
    channel across N sinks (``TokenSink.group(n)``) — every event
    carries its ``sample`` tag, and the channel ends only when ALL
    members have reached a terminal result (group-atomic close)."""

    def __init__(self, request_id: int = -1, sample: int = 0,
                 max_events: int = 256, metrics=None,
                 _channel: Optional[_Channel] = None):
        self.request_id = int(request_id)
        self.sample = int(sample)
        self._ch = _channel if _channel is not None \
            else _Channel(max_events, expected_closes=1, metrics=metrics)
        self._hwm = 0               # absolute-position delivery mark
        self._hwm_lock = threading.Lock()
        self._closed = False
        self._close_lock = threading.Lock()
        self.result = None          # this sample's terminal Result
        # set by the tier above the engine (the gateway): a non-forced
        # cancelled close is then a failover artifact, not the end
        self.replayable = False

    @classmethod
    def group(cls, n: int, *, max_events: int = 256,
              metrics=None) -> List["TokenSink"]:
        """N sinks over ONE shared channel — the multiplexed stream of
        a best-of-N group. The channel closes when all N close."""
        ch = _Channel(max_events, expected_closes=int(n),
                      metrics=metrics)
        return [cls(sample=i, _channel=ch) for i in range(int(n))]

    # -- producer side (engine / postprocess threads) -----------------------

    def push_tokens(self, pos: int, tokens) -> None:
        """Deliver freshly harvested tokens at absolute sequence
        position ``pos``. Re-delivered positions (eviction/failover
        replay, migration resume) below the high-water mark are
        dropped, so the consumer sees every position exactly once."""
        toks = [int(t) for t in tokens]
        pos = int(pos)
        with self._hwm_lock:
            end = pos + len(toks)
            if end <= self._hwm:
                return              # full replay duplicate
            if pos < self._hwm:
                toks = toks[self._hwm - pos:]
                pos = self._hwm
            self._hwm = end
        self._ch.push({"event": TOKENS, "sample": self.sample,
                       "request_id": self.request_id,
                       "pos": pos, "tokens": toks})

    def push_preview(self, tokens_done: int, image,
                     final: bool = False) -> None:
        """One progressive preview frame (the VAE decode of the padded
        image-token prefix). ``final`` marks the completed-prefix
        frame — byte-identical to the non-streamed ``Result.image``."""
        self._ch.push({"event": PREVIEW, "sample": self.sample,
                       "request_id": self.request_id,
                       "tokens_done": int(tokens_done),
                       "final": bool(final),
                       "image": pack_image(image)})

    def close(self, result, force: bool = False) -> None:
        """Terminal: called from ``RequestHandle.fulfill`` (the one
        funnel every terminal path goes through). Idempotent — the
        first close wins, matching fulfill's first-write-wins. On a
        replayable sink a non-forced CANCELLED close is a no-op; the
        owner passes ``force=True`` at its own terminal."""
        if self.replayable and not force \
                and getattr(result, "status", None) == "cancelled":
            return
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self.result = result
        ev = {"event": SAMPLE_DONE, "sample": self.sample,
              "request_id": self.request_id,
              "status": getattr(result, "status", "error"),
              "reason": getattr(result, "reason", "") or ""}
        score = getattr(result, "clip_score", None)
        if score is not None:
            ev["clip_score"] = float(score)
        toks = getattr(result, "tokens", None)
        if toks is not None:
            ev["n_tokens"] = int(len(toks))
        self._ch.push(ev)
        self._ch.close_one()

    # -- consumer side ------------------------------------------------------

    @property
    def done(self) -> bool:
        """Channel fully terminal AND drained."""
        return self._ch.done

    @property
    def closed(self) -> bool:
        """This sample reached a terminal result (producer view)."""
        return self._closed

    @property
    def dropped(self) -> int:
        return self._ch.dropped

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        return self._ch.get(timeout)

    def events(self, heartbeat_s: Optional[float] = None
               ) -> Iterator[dict]:
        """Iterate the stream to the end. With ``heartbeat_s``, a
        ``heartbeat`` event is synthesized whenever the channel is
        quiet that long — the SSE keepalive (generated at read time,
        never queued)."""
        wait = heartbeat_s if heartbeat_s is not None else 0.25
        while True:
            ev = self.get(timeout=wait)
            if ev is not None:
                yield ev
                continue
            if self._ch.done:
                return
            if heartbeat_s is not None:
                yield {"event": HEARTBEAT}
