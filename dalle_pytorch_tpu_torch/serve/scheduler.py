"""Requests, results and the priority queue the engine pulls from.

Port of ``dalle_pytorch_tpu/serve/scheduler.py`` (``:41-80,113-520``),
with only the fields the engine reads: ``SamplingParams``, ``Request``
(with ``cfg_scale``, per-request classifier-free guidance), ``Result``
(with the postprocess stage's ``clip_score``), ``RequestHandle`` (a
first-write-wins future), ``RequestQueue`` (bounded, (priority, arrival)
order, deadline reaping, ``requeue`` at the original position) and the
prompt-length buckets. Wire formats, tenants, streams, sample groups and
short grids come with the HTTP server's slice.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

OK = "ok"
DEADLINE_EXCEEDED = "deadline_exceeded"
ERROR = "error"


def prefill_buckets(text_seq_len: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) ``text_seq_len``:
    admission pads every prompt up to its bucket, so prefill sees a
    small fixed set of shapes."""
    if text_seq_len < 1:
        raise ValueError(f"text_seq_len must be >= 1, got {text_seq_len}")
    out: List[int] = []
    b = 1
    while b < text_seq_len:
        out.append(b)
        b *= 2
    out.append(text_seq_len)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding a length-``n`` prompt (buckets ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket "
                     f"{buckets[-1]}")


def group_by_bucket(handles: Sequence["RequestHandle"],
                    buckets: Sequence[int]
                    ) -> Dict[int, List["RequestHandle"]]:
    """Handles keyed by the bucket their prompt pads up to, pop order
    kept within a bucket: one prefill per key."""
    groups: Dict[int, List[RequestHandle]] = defaultdict(list)
    for h in handles:
        groups[bucket_for(len(h.request.codes), buckets)].append(h)
    return groups


class ServeRejected(RuntimeError):
    """Typed submit-time rejection; ``record`` says why."""

    def __init__(self, record: dict):
        super().__init__(f"{record.get('reason', 'rejected')} "
                         f"(queue_depth={record.get('queue_depth')})")
        self.record = record


class QueueFull(ServeRejected):
    """The bounded queue is at capacity."""


class InvalidRequest(ServeRejected):
    """Empty prompt, or longer than the model's text span."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    filter_thres: float = 0.5
    top_p: float = 0.0

    def __post_init__(self):
        if self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got "
                             f"{self.temperature}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: ``codes`` is the unpadded prompt.
    ``cfg_scale > 0`` asks for classifier-free guidance: the engine
    admits a cond/uncond slot pair and image tokens sample from
    ``l_u + cfg_scale * (l_c - l_u)``, ``generate_images``' ``guidance``
    (0, the default, is off)."""
    codes: Tuple[int, ...]
    seed: int = 0
    sampling: SamplingParams = SamplingParams()
    priority: int = 0                    # lower runs first
    deadline_s: Optional[float] = None   # relative to submit time
    cfg_scale: float = 0.0               # classifier-free guidance
    request_id: int = -1                 # assigned by the queue
    submit_t: float = 0.0                # perf_counter, set by the queue

    def __post_init__(self):
        if self.cfg_scale < 0:
            raise ValueError(f"cfg_scale must be >= 0, got "
                             f"{self.cfg_scale}")

    @property
    def deadline_t(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.submit_t + self.deadline_s


@dataclasses.dataclass
class Result:
    """Terminal state of a request: ``tokens`` are the image ids (no
    text offset), ``text_tokens`` the completed text span, ``image`` the
    decoded (H, W, C) image and ``clip_score`` its CLIP score against
    ``text_tokens`` when postprocessing ran them."""
    status: str
    request_id: int
    tokens: object = None
    text_tokens: object = None
    image: object = None
    clip_score: Optional[float] = None
    reason: str = ""
    queued_s: float = 0.0
    decode_s: float = 0.0
    total_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK


class RequestHandle:
    """Future for one request. ``fulfill`` is first-write-wins."""

    def __init__(self, request: Request):
        self.request = request
        self._done = threading.Event()
        self._result: Optional[Result] = None
        self._lock = threading.Lock()
        # arrival order within the priority class; a requeue keeps it
        self.queue_seq: int = -1

    def done(self) -> bool:
        return self._done.is_set()

    def fulfill(self, result: Result) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._result = result
            self._done.set()
        return True

    def result(self, timeout: Optional[float] = None) -> Result:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} not done after "
                f"{timeout}s (still queued or decoding)")
        return self._result


class RequestQueue:
    """Bounded, thread-safe priority queue: ``submit`` raises
    ``QueueFull``/``InvalidRequest``; ``pop_ready`` hands out up to ``n``
    requests in (priority, arrival) order and separates those whose
    deadline already passed."""

    def __init__(self, max_depth: int = 64,
                 max_prompt_len: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.max_depth = int(max_depth)
        self.max_prompt_len = max_prompt_len
        self.clock = clock
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.submitted = 0
        self.requeued = 0

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def submit(self, request: Request) -> RequestHandle:
        now = self.clock()
        with self._lock:
            n = len(request.codes)
            if n == 0 or (self.max_prompt_len is not None
                          and n > self.max_prompt_len):
                raise InvalidRequest({"reason": "invalid_prompt",
                                      "prompt_len": n,
                                      "queue_depth": len(self._heap)})
            if len(self._heap) >= self.max_depth:
                raise QueueFull({"reason": "queue_full",
                                 "queue_depth": len(self._heap)})
            request = dataclasses.replace(request,
                                          request_id=self.submitted,
                                          submit_t=now)
            self.submitted += 1
            handle = RequestHandle(request)
            handle.queue_seq = next(self._seq)
            heapq.heappush(self._heap, (request.priority, handle.queue_seq,
                                        handle))
            return handle

    def requeue(self, handle: RequestHandle, count: bool = True) -> None:
        """Put an admitted request back at its ORIGINAL arrival position
        (``(priority, queue_seq)``): page backpressure and eviction. Not
        subject to ``max_depth``; a handle already in line is not added
        twice. ``count=False`` leaves it out of ``requeued`` (a plain
        hand-off, not backpressure)."""
        with self._lock:
            if any(entry[2] is handle for entry in self._heap):
                return
            if count:
                self.requeued += 1
            heapq.heappush(self._heap, (handle.request.priority,
                                        handle.queue_seq, handle))

    def pop_ready(self, n: int, now: Optional[float] = None
                  ) -> Tuple[List[RequestHandle], List[RequestHandle]]:
        """Up to ``n`` ready handles, and every deadline-expired one."""
        if now is None:
            now = self.clock()
        ready: List[RequestHandle] = []
        with self._lock:
            keep, dead = [], []
            for entry in self._heap:
                dt = entry[2].request.deadline_t
                (dead if dt is not None and now > dt else keep).append(entry)
            if dead:
                heapq.heapify(keep)
                self._heap = keep
            while self._heap and len(ready) < n:
                ready.append(heapq.heappop(self._heap)[2])
        return ready, [e[2] for e in dead]
