"""The multi-cell gateway: one front door over a fleet of servers.

Port of ``dalle_pytorch_tpu/serve/gateway.py`` (``:1-1025``). One
``InferenceServer``, even over a replica set, is one host's worth of
engines. The gateway puts N independent CELLS (each an
``InferenceServer``) behind one submit and HTTP surface, and does three
jobs there:

* PREFIX-AFFINE ROUTING. The rendezvous (highest-random-weight) hash key
  is the prompt's content key (``serve/prefix_cache.py::content_key``:
  model version, layer signature, cache dtype, exact tokens), the same
  key each cell's engine files its prefix cache under. A repeated prompt
  lands on the cell whose cache already holds it. When that cell is
  full the request SPILLS to the cell with the most free slots, as a
  ``gateway_spill`` event.

* TENANCY AT ADMISSION (``serve/tenancy.py``). API keys checked in
  constant time, token-bucket rate limits and fleet-wide page budgets,
  all charged before the shared queue sees the request, so an abusive
  tenant spends only its own quota (a typed 429 with retry-after). The
  shared queue drains by weighted-fair virtual finish time
  (``scheduler.WeightedFairQueue``), its cost in image tokens.

* SLO TIERS AND HEDGED SENDS. A request un-fulfilled past its tier's
  hedge threshold is duplicated onto the next-ranked live cell. The
  first fulfil wins (``RequestHandle.fulfill`` is first-write-wins); the
  loser's cell handle is fulfilled ``cancelled`` from outside. A thread
  cell's engine then reaps the slot; a process cell's child decodes the
  loser to its end, as in JAX (the frames carry no cancel).

A cell that dies (``faults.gateway_cell_down_at_request`` kills one on
purpose) is fenced, and every flight it held is requeued with its
original ``queue_seq`` and virtual tags and replayed on a survivor:
the same tokens, nothing lost.

The gateway itself never touches a device: its cells do.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from dalle_pytorch_tpu_torch.obs import registry as oreg
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.serve import auth
from dalle_pytorch_tpu_torch.serve import prefix_cache as PC
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import tenancy as T
from dalle_pytorch_tpu_torch.utils.metrics import structured_event


class Cell:
    """One ReplicaSet-backed ``InferenceServer`` behind the gateway.
    The gateway tracks its own in-flight count per cell as the load
    signal — cheap, lock-local, and exactly the quantity the spill
    decision needs (stats() walks the whole set)."""

    def __init__(self, name: str, server, index: int):
        self.name = str(name)
        self.server = server
        self.index = int(index)
        self.inflight = 0          # gateway-tracked flights on this cell
        self.routed = 0            # lifetime dispatches (hedges included)
        self.killed = False
        try:
            self.capacity = max(int(server.stats().get("num_slots", 1)),
                                1)
        except Exception:   # noqa: BLE001 — a cell that cannot answer
            # stats at attach time still joins with minimal capacity
            self.capacity = 1

    def alive(self) -> bool:
        return not self.killed and self.server.engine_alive()


@dataclasses.dataclass
class _Flight:
    """Gateway-side bookkeeping for one admitted request, from tenant
    admission to terminal fulfil. ``pages`` is the tenant-budget
    reservation released exactly once (``released`` guards it)."""
    handle: S.RequestHandle
    tenant: str
    pages: int
    key: str = ""
    rank: List[int] = dataclasses.field(default_factory=list)
    cell: Optional[Cell] = None
    cell_handle: Optional[S.RequestHandle] = None
    hedge_cell: Optional[Cell] = None
    hedge_handle: Optional[S.RequestHandle] = None
    dispatch_t: float = 0.0
    replays: int = 0
    released: bool = False
    # gateway-owned stream sinks (serve/stream.py), built ONCE at
    # admission and handed to every dispatch of this flight — replay on
    # a survivor cell re-feeds the SAME sinks, and the per-sink
    # high-water mark dedupes the replayed prefix, so the client's
    # stream never stutters across a cell death
    sinks: Optional[List] = None


# federation: the cell counters the gateway re-exposes with a ``cell``
# label — the per-cell samples MUST sum to the unlabeled fleet value
# (pinned by test), so an operator can read one scrape for both.
_FEDERATED_COUNTERS = (
    ("requests_submitted", "dalle_serve_requests_submitted_total"),
    ("completed", "dalle_serve_requests_completed_total"),
    ("tokens_decoded", "dalle_serve_tokens_decoded_total"),
    ("prefix_hits", "dalle_serve_prefix_hits_total"),
)

_MAX_REPLAYS = 3          # per flight, before a typed error fulfil
_EVENT_RING = 512         # bounded gateway event history


class Gateway:
    """The fleet front door. ``cells`` are started ``InferenceServer``s
    (the gateway does not start them; ``close(close_cells=True)``
    closes them). ``tenants`` is a ``tenancy.TenantTable`` or None (the
    anonymous single-tenant gateway — no auth, no quotas, weight 1).

    ``cfg``/``model_version``/``quantized`` must describe the cells'
    engines: they parameterize the routing key so it matches what each
    cell's PrefixIndex computes at admission. ``affinity=False``
    degrades routing to hash-blind least-loaded — the control arm of
    an affinity comparison, and an escape hatch."""

    def __init__(self, cells: Sequence, *, tenants=None, cfg=None,
                 model_version: str = "v0", quantized: bool = False,
                 affinity: bool = True, queue_depth: int = 256,
                 max_prompt_len: Optional[int] = None,
                 pages_per_request: int = 1,
                 admin_token: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tick_s: float = 0.005,
                 hedge_check_s: float = 0.05,
                 on_event=None):
        if not cells:
            raise ValueError("a gateway needs at least one cell")
        self.cells = [c if isinstance(c, Cell) else Cell(f"cell{i}", c, i)
                      for i, c in enumerate(cells)]
        self.tenants: Optional[T.TenantTable] = tenants
        self.cfg = cfg
        self.model_version = str(model_version)
        self.quantized = bool(quantized)
        self.affinity = bool(affinity)
        self.pages_per_request = max(int(pages_per_request), 0)
        self.clock = clock
        self.tick_s = float(tick_s)
        self.hedge_check_s = float(hedge_check_s)
        self.on_event = on_event
        if admin_token is None:
            import secrets
            admin_token = secrets.token_hex(16)
        self.admin_token = admin_token
        # per-request decode cost for the image-token bucket: the
        # model's image span (every completion decodes exactly this
        # many tokens), or 0 (cost-free) without a cfg
        self.image_tokens = int(cfg.image_seq_len) if cfg is not None \
            else 0
        weight_of = tenants.weight_of if tenants is not None \
            else (lambda name: 1.0)
        # WFQ cost is measured in IMAGE TOKENS, not requests: a
        # completion decodes its image span per sample, so the charge
        # is n_samples x (override or full image_seq_len) — a fan-out
        # tenant pays for N samples' decoded work up front, and a
        # variable-resolution tenant can't multiply its share by
        # splitting work across more, smaller requests (the short grid
        # costs exactly its shorter span). Speculation doesn't change
        # the charge: rejected drafts are never delivered, so the true
        # per-sample token cost is the span at every acceptance rate.
        # Without a cfg there is no token count to meter — fall back to
        # n_samples per request (uniform per-sample cost keeps WFQ
        # exact, just sample-denominated).
        def _wfq_cost(request: S.Request) -> float:
            n = max(int(request.n_samples), 1)
            if not self.image_tokens:
                return float(n)
            span = int(request.image_seq_len_override) \
                or self.image_tokens
            return float(n * span)
        self.queue = S.WeightedFairQueue(
            max_depth=queue_depth, max_prompt_len=max_prompt_len,
            clock=clock, on_event=self._event_sink,
            weight_of=weight_of, cost_fn=_wfq_cost)
        self._lock = threading.Lock()
        self._flights: Dict[int, _Flight] = {}
        self._events: "collections.deque" = collections.deque(
            maxlen=_EVENT_RING)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (lifetime-monotonic; /metrics re-exposes them)
        self.routed = 0
        self.spills = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.replays = 0
        self.cell_downs = 0
        self.completed = 0
        self.expired = 0
        self.hedge_stream_rejects = 0
        # per-tenant e2e latency (submit -> terminal fulfil), the
        # histogram the degradation contract's p95 is read from
        self.registry = oreg.Registry()
        self.hist_e2e = self.registry.histogram(
            "dalle_gateway_e2e_latency_seconds",
            "Gateway end-to-end request latency by tenant")

    # -- events --------------------------------------------------------

    def _event_sink(self, record: dict) -> None:
        self._events.append(record)
        if self.on_event is not None:
            self.on_event(record)

    def _event(self, kind: str, **fields) -> dict:
        record = structured_event(kind, **fields)
        self._event_sink(record)
        return record

    def events(self, kind: Optional[str] = None) -> List[dict]:
        out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Gateway":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._pump, name="gateway-pump", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0,
              close_cells: bool = True) -> None:
        self.queue.close()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for h in self.queue.drain():
            h.fulfill(S.Result(
                status=S.CANCELLED, request_id=h.request.request_id,
                reason="gateway shutdown"))
            self._finish(h.request.request_id, completed=False)
        with self._lock:
            flights = list(self._flights.values())
        for fl in flights:
            fl.handle.fulfill(S.Result(
                status=S.CANCELLED,
                request_id=fl.handle.request.request_id,
                reason="gateway shutdown"))
            self._finish(fl.handle.request.request_id, completed=False)
        if close_cells:
            for cell in self.cells:
                if not cell.killed:
                    cell.server.close(timeout)

    # -- admission -----------------------------------------------------

    def _sample_span(self, override: int) -> int:
        """Per-sample decoded image span: the override grid when the
        request carries one, else the model's full span."""
        return int(override) or self.image_tokens

    def _flight_pages(self, n_samples: int, override: int) -> int:
        """The tenant page charge for one flight, COW-aware: a best-of-
        N group shares its prompt span across all N members (refcounted
        prefix pages), so the true footprint is ONE prompt
        span plus N generation spans — not N full requests. Scaled in
        ``pages_per_request`` units off the model's token geometry; a
        short-grid override shrinks the per-sample generation share
        proportionally. Without a cfg the geometry is unknown — charge
        the conservative N x pages_per_request."""
        base = self.pages_per_request
        n = max(int(n_samples), 1)
        if base == 0:
            return 0
        if n == 1 and not override:
            return base
        if self.cfg is None:
            return base * n
        text = int(self.cfg.text_seq_len)
        gen = self._sample_span(override)
        full = text + int(self.cfg.image_seq_len)
        cow = text + n * gen
        return max(int(round(base * cow / full)), 1)

    def submit(self, codes, *, api_key: str = "", seed: int = 0,
               temperature: float = 1.0, filter_thres: float = 0.5,
               top_p: float = 0.0, priority: int = 0,
               deadline_s: Optional[float] = None,
               cfg_scale: float = 0.0,
               stream: bool = False,
               n_samples: int = 1,
               image_seq_len_override: int = 0) -> S.RequestHandle:
        """The fleet submit: authenticate -> charge tenant quotas ->
        enter the weighted-fair queue. Raises the typed ladder:
        ``tenancy.AuthError`` (401), ``tenancy.TenantThrottled`` (429
        with retry-after), ``scheduler.QueueFull`` / ``InvalidRequest``
        / ``QueueClosed`` — every refusal structured, nothing silent.
        The returned handle is the caller's future; the pump thread
        routes, hedges, and replays behind it. ``stream``/``n_samples``
        /``image_seq_len_override`` ride through to the cell: the
        tenant is charged n_samples x the per-sample span up front
        (decoded-work metering), and the page reservation charges the
        COW footprint, not N cold prefills."""
        n_samples = max(int(n_samples), 1)
        override = int(image_seq_len_override)
        tenant = ""
        pages = 0
        if self.tenants is not None:
            spec = self.tenants.authenticate(api_key)
            tenant = spec.name
            pages = self._flight_pages(n_samples, override)
            self.tenants.admit(
                tenant,
                image_tokens=n_samples * self._sample_span(override),
                pages=pages)
        sinks = None
        if stream:
            from dalle_pytorch_tpu_torch.serve.stream import TokenSink
            sinks = (TokenSink.group(n_samples) if n_samples > 1
                     else [TokenSink()])
            for s in sinks:
                # cell-side failover cancels must not end the client's
                # stream — the replayed dispatch re-feeds these sinks;
                # _finish force-closes them at the flight's terminal
                s.replayable = True
        try:
            handle = self.queue.submit(S.Request(
                codes=tuple(int(c) for c in codes), seed=int(seed),
                sampling=S.SamplingParams(
                    temperature=float(temperature),
                    filter_thres=float(filter_thres),
                    top_p=float(top_p)),
                priority=int(priority), deadline_s=deadline_s,
                cfg_scale=float(cfg_scale), tenant=tenant,
                stream=bool(stream), n_samples=n_samples,
                image_seq_len_override=override),
                sink=sinks[0] if sinks else None)
        except S.ServeRejected:
            if self.tenants is not None:
                # all-or-nothing admission: a queue refusal refunds
                # the page reservation the tenant charge just took
                self.tenants.release(tenant, pages=pages,
                                     completed=False)
            raise
        with self._lock:
            self._flights[handle.request.request_id] = _Flight(
                handle=handle, tenant=tenant, pages=pages,
                sinks=sinks)
        return handle

    def generate(self, codes, timeout: Optional[float] = None,
                 **kwargs) -> S.Result:
        return self.submit(codes, **kwargs).result(timeout)

    # -- routing -------------------------------------------------------

    def _rank(self, key: str) -> List[int]:
        """Rendezvous (HRW) order of ALL cells for one routing key:
        stable under cell death (survivor order unchanged — the
        property that makes affinity survive a fence) and uniform
        across keys. Returns cell indices, best first."""
        def score(cell: Cell) -> int:
            h = hashlib.sha256(f"{key}|{cell.name}".encode())
            return int.from_bytes(h.digest()[:8], "big")
        return [c.index for c in
                sorted(self.cells, key=score, reverse=True)]

    def _pick(self, flight: _Flight) -> Optional[Cell]:
        """Choose the target cell for one dispatch. Affinity mode:
        the highest-ranked ALIVE cell, spilling to the most-free cell
        when the affine one is saturated. Hash-blind mode: least
        loaded alive cell (fewest in-flight, then fewest lifetime
        routed, then index). None when nothing alive has a free
        slot."""
        alive = [c for c in self.cells if c.alive()]
        if not alive:
            return None
        free = [c for c in alive if c.inflight < c.capacity]
        if not free:
            return None
        if not self.affinity:
            return min(free, key=lambda c: (c.inflight, c.routed,
                                            c.index))
        by_index = {c.index: c for c in alive}
        affine = next((by_index[i] for i in flight.rank
                       if i in by_index), None)
        if affine is None:
            return min(free, key=lambda c: (c.inflight, c.routed,
                                            c.index))
        if affine.inflight < affine.capacity:
            return affine
        spill = min(free, key=lambda c: (c.inflight, c.routed, c.index))
        self.spills += 1
        self._event("gateway_spill", tenant=flight.tenant,
                    request=flight.handle.request.request_id,
                    affine=affine.name, cell=spill.name,
                    key=flight.key[:12])
        return spill

    def _send(self, flight: _Flight, cell: Cell, now: float
              ) -> Optional[S.RequestHandle]:
        """Submit one flight's request to ``cell``, deadline re-based
        to the remaining budget. A cell-side typed reject returns None
        (the caller requeues — the shared queue, not the cell, owns
        backpressure for gateway traffic)."""
        r = flight.handle.request
        deadline = None
        if r.deadline_t is not None:
            deadline = max(r.deadline_t - now, 0.001)
        try:
            h = cell.server.submit(
                r.codes, seed=r.seed,
                temperature=r.sampling.temperature,
                filter_thres=r.sampling.filter_thres,
                top_p=r.sampling.top_p, priority=r.priority,
                deadline_s=deadline, cfg_scale=r.cfg_scale,
                tenant=r.tenant, stream=r.stream,
                n_samples=r.n_samples,
                image_seq_len_override=r.image_seq_len_override,
                # the gateway's sinks, not fresh cell-side ones: a
                # replay re-feeds the same sinks and the high-water
                # mark dedupes, so the client stream survives the hop
                sinks=flight.sinks)
        except S.InvalidRequest as e:
            # the CELL can never run this request (e.g. streaming into
            # a process-isolated cell): retrying elsewhere in the same
            # fleet shape would spin forever — terminal typed error
            flight.handle.fulfill(S.Result(
                status=S.ERROR,
                request_id=flight.handle.request.request_id,
                reason=str(e.record.get("reason", "invalid_request"))))
            self._finish(flight.handle.request.request_id,
                         completed=False)
            return None
        except S.ServeRejected:
            return None
        cell.inflight += 1
        cell.routed += 1
        return h

    def _dispatch(self, now: float) -> None:
        free = sum(max(c.capacity - c.inflight, 0)
                   for c in self.cells if c.alive())
        ready, dead = self.queue.pop_ready(free, now)
        for h in dead:
            h.fulfill(S.Result(
                status=S.DEADLINE_EXCEEDED,
                request_id=h.request.request_id,
                reason="deadline exceeded in gateway queue"))
            self.expired += 1
            self._finish(h.request.request_id, completed=False)
        for h in ready:
            with self._lock:
                flight = self._flights.get(h.request.request_id)
            if flight is None or h.done():
                continue
            if not flight.rank:
                flight.key = PC.content_key(
                    h.request.codes, cfg=self.cfg,
                    model_version=self.model_version,
                    quantized=self.quantized) if self.cfg is not None \
                    else hashlib.sha256(repr(h.request.codes).encode()
                                        ).hexdigest()
                flight.rank = self._rank(flight.key)
            cell = self._pick(flight)
            if cell is None:
                # nothing alive has a free slot right now: back into
                # the line at the ORIGINAL position (count=False — a
                # capacity wait is a dispatch stall, not backpressure)
                self.queue.requeue(h, count=False)
                continue
            sent = self._send(flight, cell, now)
            if sent is None:
                self.queue.requeue(h, count=False)
                continue
            flight.cell = cell
            flight.cell_handle = sent
            flight.dispatch_t = now
            self.routed += 1
            affine = bool(self.affinity and flight.rank
                          and flight.rank[0] == cell.index)
            self._event("gateway_route",
                        request=h.request.request_id,
                        tenant=h.request.tenant, cell=cell.name,
                        affine=affine, spilled=not affine
                        if self.affinity else False,
                        key=flight.key[:12])
            if faults.on_gateway_dispatch(self.routed):
                self._cell_down(cell)

    # -- failure + completion sweeps ----------------------------------

    def _cell_down(self, cell: Cell) -> None:
        """Fence one cell: mark it dead and close its server. Every
        in-flight request it held completes ``cancelled`` from the
        cell's own shutdown path; the completion sweep turns each into
        a requeue + replay on a survivor."""
        if cell.killed:
            return
        cell.killed = True
        self.cell_downs += 1
        self._event("gateway_cell_down", cell=cell.name,
                    inflight=cell.inflight)
        try:
            cell.server.close(timeout=10.0)
        except Exception as e:   # noqa: BLE001 — a messy corpse must
            # not take the pump thread down with it
            self._event("gateway_cell_close_error", cell=cell.name,
                        error=repr(e))

    def _replay(self, flight: _Flight) -> None:
        """Zero-loss recovery: the flight's cell died (or rejected it)
        — strip its cell-side state and requeue the ORIGINAL handle.
        queue_seq and the WFQ virtual tags are cached on the handle,
        so the replay re-enters at the exact place in line the
        request always owned; decode on the survivor is byte-identical
        per weights_version (the engines' replay contract)."""
        flight.replays += 1
        self.replays += 1
        flight.cell = None
        flight.cell_handle = None
        flight.hedge_cell = None
        flight.hedge_handle = None
        if flight.replays > _MAX_REPLAYS:
            flight.handle.fulfill(S.Result(
                status=S.ERROR,
                request_id=flight.handle.request.request_id,
                reason=f"gateway replay budget exhausted "
                       f"({_MAX_REPLAYS})"))
            self._finish(flight.handle.request.request_id,
                         completed=False)
            return
        self._event("gateway_replay",
                    request=flight.handle.request.request_id,
                    tenant=flight.tenant, attempt=flight.replays)
        self.queue.requeue(flight.handle)

    def _finish(self, request_id: int, completed: bool) -> None:
        """Terminal bookkeeping for one flight, exactly once: release
        the tenant's page reservation, observe e2e latency, drop the
        flight record."""
        with self._lock:
            flight = self._flights.pop(request_id, None)
        if flight is None or flight.released:
            return
        flight.released = True
        if flight.sinks:
            # the flight's terminal IS the stream's terminal: force-
            # close every member sink so the SSE loop ends even when
            # the cell-side arms never got to fulfil (replay budget
            # exhausted, shutdown, disconnect)
            try:
                result = flight.handle.result(timeout=0)
            except TimeoutError:
                result = S.Result(
                    status=S.CANCELLED,
                    request_id=flight.handle.request.request_id,
                    reason="gateway flight terminated")
            for s in flight.sinks:
                try:
                    s.close(result, force=True)
                except Exception:   # noqa: BLE001 — sink teardown must
                    pass            # never block tenant-page release
        if self.tenants is not None and flight.tenant:
            self.tenants.release(flight.tenant, pages=flight.pages,
                                 completed=completed)
        if completed:
            self.completed += 1
        self.hist_e2e.observe(
            max(self.clock() - flight.handle.request.submit_t, 0.0),
            tenant=flight.tenant or "anonymous")

    def _cancel_cell_handle(self, cell: Optional[Cell],
                            handle: Optional[S.RequestHandle],
                            reason: str) -> None:
        """Cooperative cancel of a cell-side handle the gateway no
        longer wants (hedge loser, late duplicate): an external
        first-write-wins fulfil — the cell engine's harvest skips done
        handles, discards the tokens, and frees the slot at its
        natural completion point."""
        if handle is None or cell is None:
            return
        handle.fulfill(S.Result(
            status=S.CANCELLED, request_id=handle.request.request_id,
            reason=reason))
        cell.inflight = max(cell.inflight - 1, 0)

    def _sweep_flights(self, now: float) -> None:
        with self._lock:
            flights = list(self._flights.values())
        for fl in flights:
            if fl.handle.done():        # expired while queued, or the
                # caller went away (SSE disconnect cancel): any live
                # cell-side arm must be cancelled too, so the engine's
                # done-handle reap frees its slots and pages instead
                # of decoding a stream nobody is reading
                for c, h in ((fl.cell, fl.cell_handle),
                             (fl.hedge_cell, fl.hedge_handle)):
                    if h is not None and not h.done():
                        self._cancel_cell_handle(
                            c, h, "gateway flight terminated")
                self._finish(fl.handle.request.request_id,
                             completed=False)
                continue
            if fl.cell_handle is None:
                continue                # still queued for dispatch
            # primary and hedge race; the first arm with a USABLE
            # terminal result wins (first-write-wins at the caller's
            # handle), the loser is cooperatively cancelled
            arms = [(fl.cell, fl.cell_handle),
                    (fl.hedge_cell, fl.hedge_handle)]
            done_arms = [(c, h) for c, h in arms
                         if h is not None and h.done()]
            if not done_arms:
                continue
            for c, _ in done_arms:
                c.inflight = max(c.inflight - 1, 0)
            winner = next(
                ((c, h, h.result(timeout=0)) for c, h in done_arms
                 if h.result(timeout=0).status
                 in (S.OK, S.DEADLINE_EXCEEDED)), None)
            if winner is not None:
                cell, ch, result = winner
                if cell is fl.hedge_cell:
                    self.hedge_wins += 1
                fl.handle.fulfill(dataclasses.replace(
                    result, request_id=fl.handle.request.request_id))
                for oc, oh in arms:
                    if oh is not None and oh is not ch \
                            and not oh.done():
                        self._cancel_cell_handle(oc, oh,
                                                 "hedge loser")
                self._finish(fl.handle.request.request_id,
                             completed=result.status == S.OK)
                continue
            # every done arm died (cell down / cancelled / rejected)
            pending = [(c, h) for c, h in arms
                       if h is not None and not h.done()]
            if pending:
                # one arm is still racing: promote it to primary
                fl.cell, fl.cell_handle = pending[0]
                fl.hedge_cell = fl.hedge_handle = None
            else:
                self._replay(fl)

    def _sweep_dead_cells(self) -> None:
        for cell in self.cells:
            if not cell.killed and not cell.server.engine_alive():
                self._cell_down(cell)

    def _sweep_hedges(self, now: float) -> None:
        if self.tenants is None:
            return
        with self._lock:
            flights = list(self._flights.values())
        for fl in flights:
            if fl.cell_handle is None or fl.hedge_handle is not None \
                    or fl.handle.done():
                continue
            try:
                spec = self.tenants.spec(fl.tenant)
            except KeyError:
                continue
            hedge_after = spec.hedge_after_s
            if hedge_after is None or \
                    now - fl.dispatch_t < hedge_after:
                continue
            if fl.handle.request.stream:
                # two live arms would BOTH feed the client's sinks —
                # interleaved duplicate events, not a latency win. A
                # slow stream keeps its single arm; the refusal is
                # typed so the operator can see hedging declined.
                self.hedge_stream_rejects += 1
                self._event("gateway_hedge_reject",
                            request=fl.handle.request.request_id,
                            tenant=fl.tenant, reason="stream",
                            after_s=round(now - fl.dispatch_t, 4))
                # stamp so the sweep doesn't re-refuse every tick
                fl.dispatch_t = now
                continue
            by_index = {c.index: c for c in self.cells if c.alive()}
            target = next(
                (by_index[i] for i in fl.rank
                 if i in by_index and i != fl.cell.index
                 and by_index[i].inflight < by_index[i].capacity),
                None)
            if target is None:
                continue
            sent = self._send(fl, target, now)
            if sent is None:
                continue
            fl.hedge_cell = target
            fl.hedge_handle = sent
            self.hedges += 1
            self._event("gateway_hedge",
                        request=fl.handle.request.request_id,
                        tenant=fl.tenant, cell=target.name,
                        after_s=round(now - fl.dispatch_t, 4))

    def _pump(self) -> None:
        last_hedge = 0.0
        while not self._stop.is_set():
            try:
                now = self.clock()
                self._sweep_dead_cells()
                self._sweep_flights(now)
                self._dispatch(now)
                if now - last_hedge >= self.hedge_check_s:
                    self._sweep_hedges(now)
                    last_hedge = now
            except Exception as e:   # noqa: BLE001 — the pump is the
                # gateway's heart; log the beat that failed, keep going
                self._event("gateway_pump_error", error=repr(e))
            self._stop.wait(self.tick_s)

    # -- observability -------------------------------------------------

    def health(self) -> dict:
        alive = [c.name for c in self.cells if c.alive()]
        return {"ok": bool(alive), "cells": len(self.cells),
                "alive_cells": alive}

    def stats(self) -> dict:
        cells = []
        fleet: Dict[str, int] = {k: 0 for k, _ in _FEDERATED_COUNTERS}
        for c in self.cells:
            rec = {"cell": c.name, "alive": c.alive(),
                   "inflight": c.inflight, "capacity": c.capacity,
                   "routed": c.routed}
            if c.alive():
                try:
                    s = c.server.stats()
                    for key, _ in _FEDERATED_COUNTERS:
                        rec[key] = int(s.get(key, 0) or 0)
                        fleet[key] += rec[key]
                except Exception:   # noqa: BLE001 — a dying cell's
                    pass            # stats must not fail the scrape
            cells.append(rec)
        hits = fleet["prefix_hits"]
        done = fleet["completed"]
        out = {
            "cells": cells,
            "alive_cells": sum(1 for c in self.cells if c.alive()),
            "queue_depth": self.queue.depth(),
            "routed": self.routed,
            "spills": self.spills,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "hedge_stream_rejects": self.hedge_stream_rejects,
            "streams_active": sum(
                1 for fl in list(self._flights.values())
                if fl.sinks and not fl.sinks[0].done),
            "replays": self.replays,
            "cell_downs": self.cell_downs,
            "completed": self.completed,
            "expired": self.expired,
            "rejected": self.queue.rejected,
            "fleet": fleet,
            "fleet_prefix_hit_rate": round(hits / max(done, 1), 4),
            "virtual_time": self.queue.virtual_time(),
        }
        if self.tenants is not None:
            out["tenants"] = self.tenants.stats()
        return out

    def metrics_text(self) -> str:
        """One scrape for the whole fleet: gateway counters, per-tenant
        counters, per-tenant latency histograms, and the FEDERATED cell
        counters — each cell's value as a ``cell``-labeled sample plus
        the unlabeled fleet sum, which equals what the cells' own
        /stats report (pinned by test)."""
        stats = self.stats()
        counters = [
            ("dalle_gateway_routed_total",
             "Requests dispatched to cells (hedges excluded)",
             [(None, self.routed)]),
            ("dalle_gateway_spills_total",
             "Dispatches that broke prefix affinity (saturated cell)",
             [(None, self.spills)]),
            ("dalle_gateway_hedges_total",
             "Speculative duplicate sends past the SLO-tier threshold",
             [(None, self.hedges)]),
            ("dalle_gateway_hedge_stream_rejects_total",
             "Hedges refused because the flight is a live stream",
             [(None, self.hedge_stream_rejects)]),
            ("dalle_gateway_replays_total",
             "Zero-loss replays after a cell death or reject",
             [(None, self.replays)]),
            ("dalle_gateway_cell_downs_total",
             "Whole-cell fences", [(None, self.cell_downs)]),
            ("dalle_gateway_requests_completed_total",
             "Requests the gateway fulfilled ok",
             [(None, self.completed)]),
        ]
        if self.tenants is not None:
            ts = self.tenants.stats()
            for key, name, help_text in (
                    ("admitted", "dalle_gateway_tenant_admitted_total",
                     "Requests admitted past tenant quotas"),
                    ("throttled",
                     "dalle_gateway_tenant_throttled_total",
                     "Typed 429 refusals (rate/token/page quota)"),
                    ("completed",
                     "dalle_gateway_tenant_completed_total",
                     "Requests completed per tenant")):
                counters.append((name, help_text,
                                 [({"tenant": t}, rec[key])
                                  for t, rec in sorted(ts.items())]))
        for key, name in _FEDERATED_COUNTERS:
            samples = [({"cell": rec["cell"]}, rec[key])
                       for rec in stats["cells"] if key in rec]
            samples.append((None, stats["fleet"][key]))
            counters.append(
                (name, f"Federated across cells ({key})", samples))
        gauges = [
            ("dalle_gateway_queue_depth",
             "Requests waiting in the weighted-fair queue",
             [(None, stats["queue_depth"])]),
            ("dalle_gateway_alive_cells", "Cells currently serving",
             [(None, stats["alive_cells"])]),
            ("dalle_gateway_streams_active",
             "Gateway flights with a live SSE/token stream",
             [(None, stats["streams_active"])]),
            ("dalle_gateway_cell_inflight",
             "Gateway-tracked in-flight requests per cell",
             [({"cell": rec["cell"]}, rec["inflight"])
              for rec in stats["cells"]]),
        ]
        if self.tenants is not None:
            gauges.append((
                "dalle_gateway_tenant_pages_in_flight",
                "Fleet-wide mapped-page reservations per tenant",
                [({"tenant": t}, rec["pages_in_flight"])
                 for t, rec in sorted(self.tenants.stats().items())]))
        return self.registry.render(counters=counters, gauges=gauges)


# ---------------------------------------------------------------------------
# HTTP front-end
# ---------------------------------------------------------------------------

def make_gateway_http_server(gateway: Gateway, host: str = "127.0.0.1",
                             port: int = 8000,
                             request_timeout_s: float = 600.0):
    """The fleet's HTTP surface: ``POST /generate`` (API key via
    ``Authorization: Bearer`` or ``X-API-Key``; 401/429 with
    Retry-After on the typed tenancy ladder), ``GET /stats`` /
    ``/healthz`` / ``/metrics`` / ``/tenants``, and the authenticated
    ``POST /admin/tenants`` hot reload."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from dalle_pytorch_tpu_torch.serve import server as _srv

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, body: dict, headers=()) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, (dict, list)):
                raise ValueError("body must be JSON")
            return req

        def do_GET(self):
            if self.path == "/healthz":
                body = gateway.health()
                self._send(200 if body["ok"] else 503, body)
            elif self.path == "/stats":
                self._send(200, gateway.stats())
            elif self.path == "/metrics":
                data = gateway.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/tenants":
                t = gateway.tenants
                self._send(200, {"tenants": t.stats()
                                 if t is not None else {}})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _admin_tenants(self):
            if not auth.check_http(self.headers, gateway.admin_token):
                self._send(401, {"error": "bad admin token"})
                return
            if gateway.tenants is None:
                self._send(409, {"error": "gateway has no tenant "
                                          "table to reload"})
                return
            try:
                self._send(200, gateway.tenants.reload(self._body()))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})

        def do_POST(self):
            if self.path == "/admin/tenants":
                self._admin_tenants()
                return
            if self.path != "/generate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                req = self._body()
                codes = req.get("codes")
                if not codes:
                    raise ValueError("need non-empty 'codes'")
                kwargs = {k: req[k] for k in
                          ("seed", "temperature", "filter_thres",
                           "top_p", "priority", "deadline_s",
                           "cfg_scale", "stream", "n_samples",
                           "image_seq_len_override") if k in req}
                handle = gateway.submit(
                    codes, api_key=auth.http_token(
                        self.headers, "X-API-Key"), **kwargs)
            except T.AuthError as e:
                self._send(401, e.record)
                return
            except T.TenantThrottled as e:
                self._send(429, e.record, headers=(
                    ("Retry-After",
                     str(max(int(e.retry_after_s + 0.999), 1))),))
                return
            except S.InvalidRequest as e:
                self._send(400, e.record)
                return
            except S.QueueClosed as e:
                self._send(503, e.record)
                return
            except S.ServeRejected as e:
                self._send(429, e.record)
                return
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            sink = getattr(handle, "sink", None)
            if sink is not None:
                self._stream_sse(handle, sink)
                return
            try:
                result = handle.result(timeout=request_timeout_s)
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
                return
            self._send(_srv._HTTP_STATUS.get(result.status, 500),
                       _srv._result_body(result))

        def _stream_sse(self, handle, sink) -> None:
            """Same SSE contract as the cell server's facade (event
            framing in ``serve/stream.py``): a torn connection fulfils the
            gateway handle cancelled, and the flight sweep cancels the
            cell-side arm so the engine reaps its slots."""
            from dalle_pytorch_tpu_torch.serve import stream as stream_mod
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            try:
                for ev in sink.events(heartbeat_s=5.0):
                    self.wfile.write(stream_mod.sse_bytes(ev))
                    self.wfile.flush()
                result = handle.result(timeout=request_timeout_s)
                self.wfile.write(stream_mod.sse_bytes(
                    {"event": "result", **_srv._result_body(result)}))
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                handle.fulfill(S.Result(
                    status=S.CANCELLED,
                    request_id=handle.request.request_id,
                    reason="client disconnected mid-stream"))
            except TimeoutError:
                pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd


def serve_gateway_http(gateway: Gateway, host: str = "127.0.0.1",
                       port: int = 8000) -> None:
    """Blocking HTTP loop (cli/serve.py's --gateway main)."""
    httpd = make_gateway_http_server(gateway, host, port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        gateway.close()
