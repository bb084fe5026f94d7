"""Best-of-N sample groups.

Port of ``dalle_pytorch_tpu/serve/fanout.py`` (``:36-223``).
``Request.n_samples = N`` admits N member requests that share the prompt,
member ``i`` seeded ``sample_seed(seed, i)`` (member 0 with the user's
seed), and returns a ``GroupFuture`` whose result is the set ranked by
CLIP score. A member is an ordinary request: its tokens equal a
standalone request's at the derived seed, and under the paged layout
with the prefix cache the siblings share the prompt's pages. Admission is
atomic (a member rejected cancels those already admitted) and so is
completion (one ranked result once every member is terminal); cancelling
the group cancels every member, whose slots the engine then reaps.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.stream import TokenSink

_MIX = 0x9E3779B9          # golden-ratio increment (splitmix)


def sample_seed(seed: int, i: int) -> int:
    """The per-sample RNG seed for member ``i`` of a group seeded with
    ``seed``. Index 0 returns ``seed`` itself, so best-of-1 is
    byte-identical to a plain request; higher indices get a 32-bit
    avalanche mix (finalizer from splitmix/murmur) — distinct streams
    from one user-visible seed, reproducible standalone by submitting
    the derived seed directly."""
    i = int(i)
    if i == 0:
        return int(seed)
    x = (int(seed) + i * _MIX) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def group_pages_saved(n_samples: int, prompt_len: int,
                      page_size: int) -> int:
    """KV pages the COW prompt share saves for one completed group,
    versus N independent prefills: each of the N−1 siblings retains
    the leader's whole prompt pages instead of allocating its own
    (the boundary partial page is forked private, so it saves
    nothing). 0 for dense layouts (no pages to share) and for
    singleton groups."""
    n, p = int(n_samples), int(page_size)
    if n <= 1 or p <= 0:
        return 0
    return (n - 1) * (int(prompt_len) // p)


def rank_samples(results: List[S.Result]) -> List[S.Result]:
    """Member results best-first: successful samples before failed
    ones, by CLIP score descending within the successes, original
    sample index as the deterministic tiebreak (covers CLIP-disabled
    deployments, where every score is None)."""
    def key(pair):
        i, r = pair
        score = r.clip_score if r.clip_score is not None else 0.0
        return (0 if r.ok else 1, -float(score), i)
    return [r for _, r in sorted(enumerate(results), key=key)]


class GroupFuture:
    """Handle for one best-of-N group: duck-types the parts of
    ``RequestHandle`` the server and gateway consume (``request``,
    ``done()``, ``result(timeout)``, ``fulfill(result)``), so a group
    rides every existing sweep — deadline, cancel, shutdown —
    unchanged.

    ``result`` blocks until EVERY member is terminal, then assembles
    one ranked Result: the best sample's tokens/image/score at the
    top level (a best-of-N caller that ignores ``samples`` just gets
    the best image), the full ranked member set in ``.samples``.
    ``fulfill`` is the group cancel: first-write-wins like the
    handle it imitates, and fans the terminal result out to every
    live member so their slots and pages come back."""

    def __init__(self, request: S.Request,
                 members: List[S.RequestHandle],
                 sinks: Optional[List[TokenSink]] = None):
        if not members:
            raise ValueError("a sample group needs >= 1 member")
        # the parent request, stamped with the leader's identity: the
        # group is addressed (gateway flights, stats, cancellation) by
        # its first member's request_id
        self.request = dataclasses.replace(
            request,
            request_id=members[0].request.request_id,
            submit_t=members[0].request.submit_t)
        self.members = members
        self.sinks = sinks or []
        self._lock = threading.Lock()
        self._result: Optional[S.Result] = None

    @property
    def sink(self) -> Optional[TokenSink]:
        """Any member sink reads the whole group's multiplexed channel
        — expose the leader's for the SSE writer."""
        return self.sinks[0] if self.sinks else None

    def done(self) -> bool:
        with self._lock:
            if self._result is not None:
                return True
        return all(m.done() for m in self.members)

    def fulfill(self, result: S.Result) -> bool:
        """Group-terminal override — the cancel path (client
        disconnect, gateway deadline sweep, shutdown). Cancels every
        member that hasn't finished; members' own ``fulfill`` closes
        their sinks, so the stream channel still ends cleanly."""
        with self._lock:
            if self._result is not None:
                return False
            self._result = result
        for m in self.members:
            m.fulfill(dataclasses.replace(
                result, request_id=m.request.request_id,
                samples=None))
        return True

    def result(self, timeout: Optional[float] = None) -> S.Result:
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        outs = []
        for m in self.members:
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            outs.append(m.result(left))   # raises TimeoutError like
            #                               RequestHandle.result
        with self._lock:
            if self._result is not None:
                return self._result       # cancelled while assembling
            ranked = rank_samples(outs)
            best = ranked[0]
            bad = next((r for r in outs if not r.ok), None)
            self._result = S.Result(
                status=S.OK if bad is None else bad.status,
                request_id=self.request.request_id,
                tokens=best.tokens,
                text_tokens=best.text_tokens,
                image=best.image,
                clip_score=best.clip_score,
                reason="" if bad is None else
                       (f"sample {bad.request_id}: "
                        f"{bad.reason or bad.status}"),
                weights_version=best.weights_version,
                queued_s=max(r.queued_s for r in outs),
                decode_s=max(r.decode_s for r in outs),
                total_s=max(r.total_s for r in outs),
                samples=ranked)
            return self._result


def submit_group(queue: S.RequestQueue, request: S.Request, *,
                 metrics=None, max_events: int = 256,
                 sinks: Optional[List[TokenSink]] = None
                 ) -> GroupFuture:
    """Admit one best-of-N group: N member requests (per-sample seeds,
    ``n_samples`` reset to 1 so a member is indistinguishable from a
    standalone request) submitted back-to-back so the prefix cache's
    pending-share window covers the whole set. Admission is atomic —
    if member k is rejected (queue full, closed), the k already-
    admitted members are cancelled before the typed reject propagates,
    so a failed group never leaks half its samples into the engine.
    ``sinks`` are an upstream tier's (the gateway's), one per member
    over one shared channel, used as given."""
    n = int(request.n_samples)
    if sinks is not None:
        if len(sinks) != n:
            raise ValueError(f"sinks must match n_samples: "
                             f"{len(sinks)} != {n}")
        sinks = list(sinks)
    elif request.stream:
        sinks = list(TokenSink.group(n, max_events=max_events,
                                     metrics=metrics))
    else:
        sinks = [None] * n
    members: List[S.RequestHandle] = []
    try:
        for i in range(n):
            member = dataclasses.replace(
                request, seed=sample_seed(request.seed, i),
                n_samples=1, request_id=-1, submit_t=0.0)
            h = queue.submit(member, sink=sinks[i])
            if sinks[i] is not None:
                sinks[i].request_id = h.request.request_id
            members.append(h)
    except Exception:
        for m in members:
            m.fulfill(S.Result(
                status=S.CANCELLED,
                request_id=m.request.request_id,
                reason="group admission failed"))
        raise
    return GroupFuture(request, members,
                       sinks=[s for s in sinks if s is not None])
