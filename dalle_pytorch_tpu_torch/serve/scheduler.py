"""Requests, results and the priority queue the engine pulls from.

Port of ``dalle_pytorch_tpu/serve/scheduler.py`` (``:33-635``):
``SamplingParams``, ``Request`` (``cfg_scale``, per-request
classifier-free guidance; ``tenant``, the admitting tenant;
``stream``, a live token sink; ``n_samples``, a best-of-N group;
``image_seq_len_override``, a short grid), ``Result`` (the postprocess
stage's ``clip_score``, ``weights_version``, the trace summary and a
group's ranked ``samples``), ``RequestHandle`` (a first-write-wins
future with its trace and sink), ``RequestQueue`` (bounded, (priority,
arrival) order, deadline reaping, ``requeue`` at the original position,
typed ``serve_reject`` records, ``close``/``drain`` for shutdown) and the
prompt-length buckets. For the replica set: ``RequestHandle
.replay_version`` (the weights generation a request is pinned to) and
the wire forms of ``Request``, ``RequestHandle`` and ``Result``
(``to_wire`` / ``from_wire``), which a live migration's payload and a
process worker's frames (``serve/ipc.py``) carry. For the gateway
(``serve/gateway.py``, JAX ``:637-706``): ``WeightedFairQueue``, the
base queue's ``_order_key``/``_on_pop`` hooks it overrides, and the
virtual tags ``RequestHandle.vstart``/``vfinish`` it stamps once.

Overload is structured: a reject raises a ``ServeRejected`` whose
``record`` is a ``structured_event("serve_reject", ...)`` (the HTTP
400/429/503 body), and every terminal state is one of ``Result.status``'s
strings.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dalle_pytorch_tpu_torch.obs import trace as otrace
from dalle_pytorch_tpu_torch.utils.metrics import structured_event

# Result.status values: the full set of terminal request states
OK = "ok"
REJECTED = "rejected"
DEADLINE_EXCEEDED = "deadline_exceeded"
CANCELLED = "cancelled"
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


class QueueClosed(ServeRejected):
    """The server is shutting down: a submit racing ``close()`` gets this
    instead of landing in a queue nobody drains."""


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
    (0, the default, is off). ``stream`` asks for a live token sink
    (``serve/stream.py``), ``n_samples > 1`` for a best-of-N group
    (``serve/fanout.py``), ``image_seq_len_override`` (0 = off) for a
    short grid: decode stops once that many image tokens are sampled."""
    codes: Tuple[int, ...]
    seed: int = 0
    sampling: SamplingParams = SamplingParams()
    priority: int = 0                    # lower runs first
    deadline_s: Optional[float] = None   # relative to submit time
    cfg_scale: float = 0.0               # classifier-free guidance
    tenant: str = ""                     # admitting tenant
    stream: bool = False                 # live token sink wanted
    n_samples: int = 1                   # best-of-N group size
    image_seq_len_override: int = 0      # 0 = full grid
    request_id: int = -1                 # assigned by the queue
    submit_t: float = 0.0                # perf_counter, set by the queue

    def __post_init__(self):
        if self.cfg_scale < 0:
            raise ValueError(f"cfg_scale must be >= 0, got "
                             f"{self.cfg_scale}")
        if self.n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got "
                             f"{self.n_samples}")
        if self.image_seq_len_override < 0:
            raise ValueError(f"image_seq_len_override must be >= 0, "
                             f"got {self.image_seq_len_override}")

    @property
    def deadline_t(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.submit_t + self.deadline_s

    def to_wire(self, now: float) -> dict:
        """A flat dict of JSON scalars and lists (exact round trip). The
        deadline ships as the budget LEFT at ``now``: the receiver
        re-anchors it on its own clock."""
        return {
            "id": int(self.request_id),
            "codes": [int(c) for c in self.codes],
            "seed": int(self.seed),
            "priority": int(self.priority),
            "temperature": float(self.sampling.temperature),
            "filter_thres": float(self.sampling.filter_thres),
            "top_p": float(self.sampling.top_p),
            "deadline_left_s": (None if self.deadline_s is None
                                else max(self.deadline_t - now, 0.0)),
            "cfg_scale": float(self.cfg_scale),
            "tenant": str(self.tenant),
            "stream": bool(self.stream),
            "n_samples": int(self.n_samples),
            "image_seq_len_override": int(self.image_seq_len_override),
        }

    @classmethod
    def from_wire(cls, d: dict, now: float) -> "Request":
        """Inverse of ``to_wire``, validated by construction; ``submit_t``
        is ``now``. A field a peer did not send takes its default."""
        deadline = d["deadline_left_s"]
        return cls(
            codes=tuple(int(c) for c in d["codes"]),
            seed=int(d["seed"]),
            sampling=SamplingParams(
                temperature=float(d["temperature"]),
                filter_thres=float(d["filter_thres"]),
                top_p=float(d["top_p"])),
            priority=int(d["priority"]),
            deadline_s=None if deadline is None else float(deadline),
            cfg_scale=float(d.get("cfg_scale", 0.0)),
            tenant=str(d.get("tenant", "")),
            stream=bool(d.get("stream", False)),
            n_samples=int(d.get("n_samples", 1)),
            image_seq_len_override=int(
                d.get("image_seq_len_override", 0)),
            request_id=int(d["id"]),
            submit_t=float(now))


@dataclasses.dataclass
class Result:
    """Terminal state of a request: ``tokens`` are the image ids (no
    text offset), ``text_tokens`` the completed text span, ``image`` the
    decoded (H, W, C) image and ``clip_score`` its CLIP score against
    ``text_tokens`` when postprocessing ran them. ``weights_version``
    names the weights that decoded the tokens, ``trace`` is the handle's
    trace summary (``obs/trace.py``) and ``samples`` a group's member
    results, best first."""
    status: str
    request_id: int
    tokens: object = None
    text_tokens: object = None
    image: object = None
    clip_score: Optional[float] = None
    reason: str = ""
    weights_version: str = ""
    queued_s: float = 0.0
    decode_s: float = 0.0
    total_s: float = 0.0
    trace: Optional[dict] = None
    samples: Optional[list] = None

    @property
    def ok(self) -> bool:
        return self.status == OK

    def to_wire(self) -> dict:
        """JAX's flat-dict form: token arrays as int lists; ``image``,
        ``clip_score``, ``trace`` and ``samples`` never cross the process
        boundary (postprocess and group assembly stay in the parent)."""
        return {
            "id": int(self.request_id),
            "status": str(self.status),
            "tokens": (None if self.tokens is None
                       else [int(t) for t in self.tokens]),
            "text_tokens": (None if self.text_tokens is None
                            else [int(t) for t in self.text_tokens]),
            "reason": str(self.reason),
            "weights_version": str(self.weights_version),
            "queued_s": float(self.queued_s),
            "decode_s": float(self.decode_s),
            "total_s": float(self.total_s),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Result":
        """Inverse of ``to_wire``: int32 token arrays; an unknown status
        raises ``ValueError``."""
        status = str(d["status"])
        if status not in (OK, REJECTED, DEADLINE_EXCEEDED, CANCELLED,
                          ERROR):
            raise ValueError(f"unknown Result.status {status!r}")
        toks, text = d["tokens"], d["text_tokens"]
        return cls(
            status=status, request_id=int(d["id"]),
            tokens=None if toks is None else np.asarray(
                [int(t) for t in toks], np.int32),
            text_tokens=None if text is None else np.asarray(
                [int(t) for t in text], np.int32),
            reason=str(d["reason"]),
            # .get: a peer that stamps no version decodes as unversioned
            weights_version=str(d.get("weights_version", "")),
            queued_s=float(d["queued_s"]),
            decode_s=float(d["decode_s"]),
            total_s=float(d["total_s"]))


class RequestHandle:
    """Future for one request. ``fulfill`` is first-write-wins, attaches
    the trace summary and closes the sink: every terminal path
    (completion, postprocess, expiry, error, cancel) goes through it, so
    a stream ends exactly once, and a fenced replica waking late cannot
    overwrite the result of the replay that reclaimed its request."""

    def __init__(self, request: Request):
        self.request = request
        self._done = threading.Event()
        self._result: Optional[Result] = None
        self._lock = threading.Lock()
        # the request's span timeline, attached at submit (None for
        # hand-built handles, which trace nothing)
        self.trace: Optional[otrace.Trace] = None
        # arrival order within the priority class; a requeue keeps it
        self.queue_seq: int = -1
        # the live TokenSink of a streamed request (serve/stream.py)
        self.sink = None
        # the weights generation this request first routed to (the
        # replica set's router sets it); while pinned, a failover replay
        # goes only to a replica of that generation: tokens are
        # byte-identical per generation, not across them. None: unpinned
        self.replay_version: Optional[str] = None
        # the WeightedFairQueue's virtual start/finish tags, stamped once
        # at the first insert: a requeue keeps its place in the fair order
        self.vstart: Optional[float] = None
        self.vfinish: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def fulfill(self, result: Result) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            if self.trace is not None and result.trace is None:
                result.trace = self.trace.summary()
            self._result = result
            self._done.set()
        # outside the lock: closing the sink can wake a consumer that
        # calls back into the handle; a sink failure must not lose the
        # result
        if self.sink is not None:
            try:
                self.sink.close(result)
            except Exception:   # noqa: BLE001
                pass
        return True

    def result(self, timeout: Optional[float] = None) -> Result:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} not done after "
                f"{timeout}s (still queued or decoding)")
        return self._result

    def to_wire(self, now: float) -> dict:
        """The request's wire form, its arrival position (``seq``) and
        its trace identity."""
        d = {**self.request.to_wire(now), "seq": int(self.queue_seq)}
        if self.trace is not None:
            d["trace_id"] = self.trace.trace_id
            d["attempt"] = int(self.trace.attempt)
        return d

    @classmethod
    def from_wire(cls, d: dict, now: float) -> "RequestHandle":
        """A stand-in handle rebuilt from ``to_wire``'s form, with a trace
        under the wire's trace id and attempt."""
        handle = cls(Request.from_wire(d, now))
        handle.queue_seq = int(d["seq"])
        tid = d.get("trace_id")
        if tid is not None:
            otrace.attach(handle, handle.request.request_id, now,
                          trace_id=str(tid),
                          attempt=int(d.get("attempt", 0)))
        return handle


class RequestQueue:
    """Bounded, thread-safe priority queue: ``submit`` raises
    ``QueueFull``, ``InvalidRequest`` (empty, or longer than
    ``max_prompt_len``) or, after ``close()``, ``QueueClosed``, each with
    its ``serve_reject`` record (also handed to ``on_event``), and counts
    ``rejected``; ``pop_ready`` hands out up to ``n`` requests in
    (priority, arrival) order and separates those whose deadline already
    passed."""

    def __init__(self, max_depth: int = 64,
                 max_prompt_len: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 on_event=None):
        self.max_depth = int(max_depth)
        self.max_prompt_len = max_prompt_len
        self.clock = clock
        self.on_event = on_event
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._closed = False
        self._drained = False
        self.submitted = 0
        self.rejected = 0
        self.requeued = 0

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def _order_key(self, handle: RequestHandle):
        """The heap's primary sort key for one handle (under ``_lock``):
        the priority here, FIFO within a class through ``queue_seq``;
        ``WeightedFairQueue`` orders by (priority, virtual finish). The
        key must not change across requeues of a handle."""
        return handle.request.priority

    def _on_pop(self, handle: RequestHandle) -> None:
        """Called under ``_lock`` for each handle ``pop_ready`` hands out
        (``WeightedFairQueue`` advances its virtual clock); a no-op here."""

    def close(self) -> None:
        """Refuse further submits (``QueueClosed``); set before the
        shutdown drain so no submit lands after it."""
        with self._lock:
            self._closed = True

    def _reject(self, exc_type, **fields):
        self.rejected += 1
        record = structured_event("serve_reject", **fields)
        if self.on_event is not None:
            self.on_event(record)
        raise exc_type(record)

    def submit(self, request: Request, sink=None) -> RequestHandle:
        """``sink`` (a ``TokenSink``) is attached HERE, under the lock
        that publishes the handle: attached after, the engine thread
        could pop, prefill and harvest the first chunk before it."""
        now = self.clock()
        with self._lock:
            if self._closed:
                self._reject(QueueClosed, reason="queue_closed",
                             queue_depth=len(self._heap),
                             priority=request.priority)
            n = len(request.codes)
            if n == 0 or (self.max_prompt_len is not None
                          and n > self.max_prompt_len):
                self._reject(InvalidRequest, reason="invalid_prompt",
                             prompt_len=n,
                             max_prompt_len=self.max_prompt_len,
                             queue_depth=len(self._heap),
                             priority=request.priority)
            if len(self._heap) >= self.max_depth:
                self._reject(QueueFull, reason="queue_full",
                             queue_depth=len(self._heap),
                             max_depth=self.max_depth,
                             priority=request.priority)
            rid = self.submitted
            self.submitted += 1
            request = dataclasses.replace(request, request_id=rid,
                                          submit_t=now)
            handle = RequestHandle(request)
            handle.queue_seq = next(self._seq)
            handle.sink = sink
            # every submitted request is traced: the zero-length submit
            # span anchors the timeline where the caller's clock starts
            otrace.attach(handle, rid, now).span(
                "submit", now, priority=int(request.priority),
                prompt_len=n)
            heapq.heappush(self._heap, (self._order_key(handle),
                                        handle.queue_seq, handle))
            return handle

    def requeue(self, handle: RequestHandle, count: bool = True) -> None:
        """Put an admitted request back at its ORIGINAL arrival position
        (``(priority, queue_seq)``): page backpressure and eviction. Not
        subject to ``max_depth`` or ``close()``; a handle already in line
        is not added twice, and one arriving after ``drain()`` is
        fulfilled ``cancelled`` on the spot (nobody pops a drained
        queue). ``count=False`` leaves it out of ``requeued`` (a plain
        hand-off, not backpressure)."""
        with self._lock:
            if self._drained:
                handle.fulfill(Result(
                    status=CANCELLED, request_id=handle.request.request_id,
                    reason="server shutdown"))
                return
            if any(entry[2] is handle for entry in self._heap):
                return
            if count:
                self.requeued += 1
            heapq.heappush(self._heap, (self._order_key(handle),
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
                popped = heapq.heappop(self._heap)[2]
                self._on_pop(popped)
                ready.append(popped)
        return ready, [e[2] for e in dead]

    def drain(self) -> List[RequestHandle]:
        """Remove and return everything still queued (shutdown: the
        server fulfils them ``cancelled``); the queue is dead after."""
        with self._lock:
            self._drained = True
            out = [h for _, _, h in self._heap]
            self._heap.clear()
        return out


class WeightedFairQueue(RequestQueue):
    """Start-time fair queueing across tenants. A request of tenant ``i``
    (weight ``w_i``, cost ``c`` from ``cost_fn``, 1.0 by default) is
    stamped at its first insert with

        vstart  = max(V, F_i)          # V: the system virtual time
        vfinish = vstart + c / w_i     # F_i := vfinish

    and the heap drains by (priority, vfinish, queue_seq): priority
    classes still come first, and within one tenants share the work in
    proportion to their weights. ``V`` advances to each popped request's
    vstart, so an idle tenant resumes at ``V`` (no banked credit) and a
    drained backlog owes nothing. The tags are stamped once, so a
    requeue (eviction, failover, a gateway replay) re-enters at the
    request's original virtual position, as ``queue_seq`` keeps arrival
    order in the base queue."""

    def __init__(self, max_depth: int = 64,
                 max_prompt_len: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 on_event=None,
                 weight_of: Optional[Callable[[str], float]] = None,
                 cost_fn: Optional[Callable[[Request], float]] = None):
        super().__init__(max_depth=max_depth,
                         max_prompt_len=max_prompt_len,
                         clock=clock, on_event=on_event)
        self.weight_of = weight_of if weight_of is not None \
            else (lambda tenant: 1.0)
        self.cost_fn = cost_fn if cost_fn is not None \
            else (lambda request: 1.0)
        self._vtime = 0.0
        self._ftime: Dict[str, float] = {}

    def _order_key(self, handle: RequestHandle):
        if handle.vfinish is None:
            tenant = handle.request.tenant
            weight = max(float(self.weight_of(tenant)), 1e-9)
            vstart = max(self._vtime, self._ftime.get(tenant, 0.0))
            handle.vstart = vstart
            handle.vfinish = vstart + \
                float(self.cost_fn(handle.request)) / weight
            self._ftime[tenant] = handle.vfinish
        return (handle.request.priority, handle.vfinish)

    def _on_pop(self, handle: RequestHandle) -> None:
        if handle.vstart is not None:
            self._vtime = max(self._vtime, handle.vstart)

    def virtual_time(self) -> float:
        with self._lock:
            return self._vtime

    def finish_tag(self, tenant: str) -> float:
        """The tenant's last virtual finish tag (0.0 if never seen): at
        or below ``virtual_time()`` the tenant carries no debt."""
        with self._lock:
            return self._ftime.get(tenant, 0.0)
