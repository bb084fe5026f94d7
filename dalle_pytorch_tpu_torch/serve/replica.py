"""Replica-set serving: N supervised engines behind ONE queue, with
zero-loss failover through deterministic replay.

Port of ``dalle_pytorch_tpu/serve/replica.py``. Sampling is deterministic
in (seed, position), so a request in flight can move: killed
mid-stream, re-queued at its ORIGINAL arrival position
(``RequestQueue.requeue`` keeps ``queue_seq``) and admitted on a
survivor, it replays to the same tokens.

Two isolation shapes:

* ``isolation='thread'``: every replica is an ``Engine`` in this
  process, on the one card, driven by a thread of its own (or, under the
  sync driver, by ``step_once``);
* ``isolation='process'``: every replica's engine runs in a SPAWNED
  child process (``serve/worker.py``: its own interpreter, its own CUDA
  context, its own copy of the weights) behind the typed frames of
  ``serve/ipc.py``. The parent keeps a SHADOW of every handle routed to a
  child and reclaims from it, never from the child: a SIGKILLed process
  answers nothing. Liveness is the child's PID (with its exit decoded:
  SIGKILL, SIGSEGV, the watchdog's 137) over the same heartbeat deadline,
  the heartbeats being frames. ``transport='socket'`` makes the workers
  dial back to a ``WorkerListener`` (``worker_endpoint``) with an
  authenticated HELLO: spawned children, a launcher command a replica
  (``worker_cmd``) or workers started by hand (``worker_cmd=''``), all
  supervised alike; a worker with no local PID is declared dead off its
  socket. ``worker_ckpt`` hands socket workers a checkpoint path instead
  of weights (``worker_use_ema``, ``worker_quantize``).

Supervision (one supervisor per set):

* a thread replica's loop stamps ``Engine.last_heartbeat`` at each step
  and each harvest; CRASH is a loop that recorded an exception, HANG a
  heartbeat older than ``heartbeat_s`` while the thread still runs (a
  first dispatch, ``Engine.compiling``, and a running profiler capture
  are exempt). A process replica's CRASH is a CRASH frame, a protocol
  error or a dead PID, its HANG a frame stream silent past the deadline
  (``compile_grace_s`` while it says it is compiling). Either way the
  replica is FENCED and RECLAIMED: its queued, in-slot and mid-admission
  handles go back to the shared queue at their arrival positions
  (``fulfill`` is first-write-wins, so a late waker cannot race the
  replay). A thread stuck inside a CUDA call is abandoned; a child is
  SIGKILLed first and its transport drained of the frames it wrote
  before dying (those results stand);
* BRING-UP builds a fresh engine (or spawns a fresh child, which joins
  routing at its READY frame, within ``spawn_timeout_s``); repeated
  failure circuit-breaks the replica with exponential backoff
  (``resilience.retry.RetryPolicy``) while the survivors serve;
* DRAIN (``drain_replica``) LIVE-MIGRATES the replica's decoding
  requests to survivors (``Engine.export_slot``/``import_slot``, between
  processes over MIGRATE_OUT / MIGRATE_IN / MIGRATE_ACK: pages, device
  rows and emitted tokens move; replay is the fallback at every rung),
  then fences and reclaims the rest and holds the replica down until
  ``undrain_replica``.

The elastic fleet: ``add_replica`` and ``remove_replica`` (typed
``ScaleError`` for an illegal reshape: past ``max_replicas``, the last
live replica, a retired slot, mid-upgrade); ``rolling_upgrade`` swaps
the weights replica by replica (a new model, or with ``worker_ckpt`` a
new checkpoint path), each new engine gated by canary requests that must
give the first upgraded replica's tokens, an abort rolling the whole
fleet back (``UpgradeAborted``). Every result is stamped with the
``weights_version`` that decoded it, and a failover replay is PINNED to
its generation (``RequestHandle.replay_version``), released only when
that generation has left the fleet. Roles: a ``prefill`` replica hands
warm requests to a ``decode`` replica (live migration, paged KV only).
Routing is least-loaded with page awareness (for a child, off its last
frame). ``serve/autoscale.py`` drives ``add_replica``/``remove_replica``
off the load signals.

On the card. Thread replicas on one weights version share ONE read-only
``DALLE`` module (a rolling upgrade brings the new version's module
once). Every launch stays on the legacy default stream, which orders the
replicas' kernels: K4's split merge shares one counter buffer per device
and relies on that order (``ops/paged_attention.py::_counters``), so no
replica takes a stream of its own. Process replicas each hold their own
CUDA context, counter buffer and launch count; the card time-slices the
contexts. K4's library is built (and loaded) in the parent before the
first replica thread or child exists, so no two build it at once and a
child only loads it.

A replica may span a device mesh (``devices_per_replica`` m above 1): a
thread replica i is a ``serve/mesh_engine.py::MeshEngine`` over
``serve_specs.slice_devices(visible_devices(), i, m)``; a process parent
computes no slice, and each child builds its mesh over its own host's
devices (``serve/worker.py``). The supervision, failover and replay are
unchanged. ``paged_attn='kernel'`` with m above 1 is refused at
construction with the typed ``MeshPagedAttnError``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.obs import flight as oflight
from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience import retry as rretry
from dalle_pytorch_tpu_torch.serve import ipc
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T
from dalle_pytorch_tpu_torch.serve.engine import COUNTERS as _COUNTERS
from dalle_pytorch_tpu_torch.serve.engine import Engine, MigrationError
from dalle_pytorch_tpu_torch.serve.mesh_engine import (MeshEngine,
                                                       MeshPagedAttnError)

# replica lifecycle states (``replica_states()`` / ``stats()``)
RUNNING = "running"
BROKEN = "broken"        # circuit open: waiting out the bring-up backoff
DRAINED = "drained"      # operator drain: down until undrain_replica()
RETIRED = "retired"      # scale-in tombstone: the slot never comes back

ISOLATION_MODES = ("thread", "process")
TRANSPORT_MODES = ("pipe", "socket")
# a ``prefill`` replica admits and prefills, then live-migrates the warm
# request to a decode-capable replica; ``decode`` replicas are offered
# fresh admissions only when no prefill-capable one has room. A
# preference, never a capability
REPLICA_ROLES = ("prefill", "decode", "both")


class ScaleError(RuntimeError):
    """Typed rejection of an illegal fleet reshape; ``record`` is the
    ``serve_scale_reject`` event (the HTTP 409 body)."""

    def __init__(self, record: dict):
        super().__init__(f"{record.get('reason', 'scale rejected')} "
                         f"(op={record.get('op')})")
        self.record = record


class UpgradeAborted(RuntimeError):
    """A rolling upgrade that could not complete safely (a canary failed
    its gate, the new engine did not come up, or died mid-canary). When
    it is raised the fleet is back on the OLD weights; ``record`` is the
    ``serve_upgrade_aborted`` event."""

    def __init__(self, record: dict):
        super().__init__(
            f"rolling upgrade to {record.get('to')!r} aborted at "
            f"replica {record.get('replica')}: {record.get('error')} "
            f"(fleet left on {record.get('fleet_version')!r})")
        self.record = record


class ReplayVersionMismatch(RuntimeError):
    """Guard of version-pinned replay: a request pinned to one weights
    generation was offered a replica of another (the router's filter
    makes it unreachable; this keeps it impossible)."""

    def __init__(self, record: dict):
        super().__init__(
            f"request {record.get('request_id')} is pinned to weights "
            f"{record.get('pinned')!r} but was offered replica "
            f"{record.get('replica')} on {record.get('version')!r}")
        self.record = record


class _Replica:
    """One supervised slot of the set: its engine (or child client) and
    private queue, its loop thread, and the supervisor's bookkeeping."""

    __slots__ = ("index", "state", "engine", "queue", "thread", "stop",
                 "device", "attempt", "bringups", "next_bringup_t",
                 "last_error", "dead", "await_ready", "last_exit", "conns",
                 "version", "canary", "params_override", "ckpt_override",
                 "born_scaled", "role")

    def __init__(self, index: int, device=None, version: str = "0",
                 role: str = "both"):
        self.index = index
        self.state = BROKEN          # until the first bring-up succeeds
        self.engine = None           # Engine, or ipc.ChildEngineClient
        self.queue: Optional[S.RequestQueue] = None
        self.thread: Optional[threading.Thread] = None
        self.stop: Optional[threading.Event] = None
        self.device = device         # a child's device, or a mesh slice
        self.attempt = 0             # consecutive bring-up failures
        self.bringups = 0            # lifetime bring-up calls
        self.next_bringup_t = 0.0
        self.last_error = ""
        self.dead = False            # the loop thread recorded a crash
        self.await_ready = False     # a child spawned, its READY due
        self.last_exit = ""          # the last child's decoded exit
        self.conns = 0               # workers that reached READY here
        self.version = str(version)  # weights generation it serves
        self.canary = False          # upgrading: canaries only, unrouted
        self.params_override = None  # upgrade: bring up on this model
        self.ckpt_override = None    # ... or on this checkpoint path
        self.born_scaled = False     # created by add_replica
        self.role = str(role)


class ReplicaSet:
    """N supervised ``Engine`` replicas behind one shared
    ``scheduler.RequestQueue``, with a single engine's drive surface
    (``step_once``, ``run_until_idle``, ``idle``, ``stats`` and the
    counters). ``model`` is the port's ``DALLE`` on ``device`` (the card
    unless told otherwise); every replica serves it (a process replica
    a copy of it on its own device)."""

    def __init__(self, model, queue: S.RequestQueue, *,
                 replicas: int = 2,
                 num_slots: int = 4,
                 chunk_steps: int = 8,
                 prefill_buckets=None,
                 complete: Optional[Callable] = None,
                 metrics=None, log_every: int = 0,
                 quantize_cache: bool = False,
                 kv: str = "dense",
                 page_size: int = 0,
                 num_pages: int = 0,
                 paged_attn: str = "gather",
                 sparse_reads: bool = False,
                 speculative: int = 0,
                 draft_layers: int = 0,
                 prefix_cache: bool = False,
                 preview_every: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 heartbeat_s: float = 5.0,
                 bringup_policy=None,
                 place_on_devices: bool = True,
                 idle_sleep_s: float = 0.002,
                 isolation: str = "thread",
                 child_rss_limit_mb: int = 0,
                 spawn_timeout_s: float = 120.0,
                 compile_grace_s: float = 120.0,
                 transport: str = "pipe",
                 worker_endpoint: str = "127.0.0.1:0",
                 worker_cmd: Optional[str] = None,
                 attach_token: Optional[str] = None,
                 worker_ckpt: Optional[str] = None,
                 worker_use_ema: bool = False,
                 worker_quantize: str = "none",
                 devices_per_replica: int = 1,
                 weights_version: str = "0",
                 max_replicas: int = 0,
                 roles=None,
                 device=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if isolation not in ISOLATION_MODES:
            raise ValueError(f"isolation must be one of "
                             f"{ISOLATION_MODES}, got {isolation!r}")
        if transport not in TRANSPORT_MODES:
            raise ValueError(f"transport must be one of "
                             f"{TRANSPORT_MODES}, got {transport!r}")
        if transport == "socket" and isolation != "process":
            raise ValueError("transport='socket' requires "
                             "isolation='process' (threads share a "
                             "heap; there is nothing to socket)")
        if worker_cmd is not None and transport != "socket":
            raise ValueError("worker_cmd needs transport='socket' — a "
                             "pipe cannot cross a launcher boundary")
        if worker_ckpt is not None and transport != "socket":
            raise ValueError(
                "worker_ckpt needs transport='socket': its point is "
                "that a worker on ANOTHER host loads weights from its "
                "local checkpoint store instead of receiving them over "
                "the wire")
        self.worker_use_ema = bool(worker_use_ema)
        self.worker_quantize = str(worker_quantize)
        if self.worker_quantize not in ("none", "int8", "int8_kv"):
            raise ValueError(f"worker_quantize must be 'none', 'int8' "
                             f"or 'int8_kv', got {worker_quantize!r}")
        if (self.worker_use_ema or self.worker_quantize != "none") \
                and worker_ckpt is None:
            raise ValueError(
                "worker_use_ema/worker_quantize transform the "
                "checkpoint a worker loads locally — they need "
                "worker_ckpt (without it, pass a model you transformed "
                "yourself)")
        self.devices_per_replica = int(devices_per_replica)
        if self.devices_per_replica < 1:
            raise ValueError(f"devices_per_replica must be >= 1, got "
                             f"{devices_per_replica}")
        if self.devices_per_replica > 1 and paged_attn == "kernel":
            # at construction, not once per circuit-broken bring-up
            raise MeshPagedAttnError(S.structured_event(
                "serve_mesh_paged_attn_unsupported", paged_attn="kernel"))
        self.roles = tuple(str(x) for x in roles) if roles else ()
        for role in self.roles:
            if role not in REPLICA_ROLES:
                raise ValueError(f"replica role must be one of "
                                 f"{REPLICA_ROLES}, got {role!r}")
        if self.roles and len(self.roles) != replicas:
            raise ValueError(
                f"roles names {len(self.roles)} replicas but the set "
                f"starts with {replicas}")
        if self.roles and kv != "paged" \
                and any(x != "both" for x in self.roles):
            raise ValueError(
                "prefill/decode replica roles need kv='paged' (the "
                "prefill->decode handoff live-migrates KV pages)")
        self.weights_version = str(weights_version)
        self.max_replicas = int(max_replicas)
        if self.max_replicas and self.max_replicas < replicas:
            raise ValueError(
                f"max_replicas={max_replicas} is below the initial "
                f"replica count {replicas}")
        # the CLI's fault path (DALLE_FAULTS) must be live before the
        # first bring-up (child plans are cut at spawn)
        faults.maybe_activate_from_env()
        self.device = resolve_device(device)
        self.params = model
        self.cfg = model.cfg
        self.queue = queue
        self.n_replicas = int(replicas)
        self.complete = complete
        # the set-level flight recorder: routing, supervision, scale and
        # upgrade events, and every fenced replica's own ring
        self.flight = oflight.FlightRecorder(capacity=512)
        self.metrics = oflight.wrap_metrics(self.flight, metrics)
        self.fence_dumps: dict = {}
        self.clock = clock
        self.heartbeat_s = float(heartbeat_s)
        self.kv = str(kv)
        self.isolation = str(isolation)
        self.transport = str(transport)
        self.worker_cmd = worker_cmd
        self.child_rss_limit_mb = int(child_rss_limit_mb)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.compile_grace_s = float(compile_grace_s)
        self.worker_ckpt = worker_ckpt
        self._engine_kwargs = dict(
            num_slots=num_slots, chunk_steps=chunk_steps,
            prefill_buckets=prefill_buckets, metrics=metrics,
            log_every=log_every, quantize_cache=quantize_cache,
            kv=kv, page_size=page_size, num_pages=num_pages,
            paged_attn=paged_attn, sparse_reads=sparse_reads,
            speculative=speculative, draft_layers=draft_layers,
            prefix_cache=prefix_cache, preview_every=preview_every)
        # the progressive-preview hook, set by the server after
        # construction (the property hands it to the live engines) and
        # copied onto every thread engine brought up later; a child's
        # stand-in handles have no sink, so process replicas preview
        # nothing
        self._on_preview: Optional[Callable] = None
        self.listener: Optional[T.WorkerListener] = None
        self._blobs: dict = {}       # id(model) -> (model, host state)
        if self.isolation == "process":
            if self.device.type == "cuda" and paged_attn == "kernel":
                # built here, before any child spawns: children load it
                from dalle_pytorch_tpu_torch.ops import paged_attention \
                    as PA
                PA.load_kernel()
            # what crosses the spawn boundary: the model as host state
            # (or nothing, with worker_ckpt: each worker loads the path)
            # and the engine keywords that pickle (the metrics sink and
            # the preview hook stay here)
            self._child_kwargs = dict(
                num_slots=num_slots, chunk_steps=chunk_steps,
                prefill_buckets=prefill_buckets,
                quantize_cache=quantize_cache,
                kv=kv, page_size=page_size, num_pages=num_pages,
                paged_attn=paged_attn, sparse_reads=sparse_reads,
                speculative=speculative, draft_layers=draft_layers,
                prefix_cache=prefix_cache)
            # routing's page arithmetic without an engine here: the
            # engine's own bucket and page-size defaults
            self._buckets = (S.prefill_buckets(self.cfg.text_seq_len)
                             if prefill_buckets is None
                             else tuple(sorted(set(
                                 int(b) for b in prefill_buckets))))
            self._page_size = (int(page_size) or min(16, self.cfg.seq_len)
                               ) if kv == "paged" else 0
            self._num_pages = (int(num_pages) or num_slots * KV.pages_for(
                self.cfg.seq_len, self._page_size) + 1) \
                if kv == "paged" else 0
            if self.transport == "socket":
                host, port = T.parse_endpoint(worker_endpoint)
                self.listener = T.WorkerListener(
                    host, port, token=attach_token,
                    on_event=(lambda rec: self._event(rec.pop("kind"),
                                                      **rec)))
        self.bringup_policy = bringup_policy or rretry.RetryPolicy(
            max_attempts=1, deadline_s=None, base_backoff_s=0.5,
            backoff_multiplier=2.0, max_backoff_s=30.0, jitter=0.0)
        self._idle_sleep_s = float(idle_sleep_s)
        # a child on a host with several cards takes card i % n (thread
        # replicas share the one module on ``device``)
        self._placed = (place_on_devices and self.isolation == "process"
                        and self.device.type == "cuda"
                        and self.device.index is None
                        and torch.cuda.device_count() > 1)
        self.replicas: List[_Replica] = [
            _Replica(i, device=self._device_for(i),
                     version=self.weights_version,
                     role=self.roles[i] if self.roles else "both")
            for i in range(self.n_replicas)]

        # supervisor counters, and the retired engines' counter base: a
        # fenced engine's numbers fold in here at reclaim (less the
        # reclaimed requests' harvested prefixes, which replay
        # re-credits), so the aggregates count distinct delivered tokens
        self._retired = {k: 0 for k in _COUNTERS}
        self._retired_k4 = 0         # fenced children's K4 launches
        self.failovers = 0
        self.reclaimed = 0
        self.expired = 0             # router-side queued-deadline reaps
        self.bringup_failures = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.upgrades = 0
        self._upgrading = False      # one reshape owner at a time
        self.migrations = 0
        self.migrate_fallbacks = 0
        self.migrated_tokens_saved = 0
        self.migration_seconds: List[float] = []
        self._role_sweep_t = 0.0
        # head-of-line page reservations handed back by fenced replicas:
        # {request_id: pages needed}, used by the router until it lands
        self._hol_handoff: dict = {}
        self.hol_handoffs = 0
        self._version_holds: set = set()
        # canary ids are negative: they never meet the queue's ids
        self._canary_ids = itertools.count(-1000, -1)
        self._canary_ref: dict = {}  # (version, k) -> token reference
        self._ctl_lock = threading.Lock()
        self._started = False
        self._ctl_thread: Optional[threading.Thread] = None
        self._ctl_stop = threading.Event()
        self._t_start: Optional[float] = None
        with self._ctl_lock:
            now = self.clock()
            for r in self.replicas:
                self._bring_up(r, now)

    def _device_for(self, i: int):
        """Replica ``i``'s device (a child's spec carries it as text), or
        a thread mesh replica's slice of the visible devices. A process
        parent computes no slice: each child takes its own from its own
        host's devices, and the parent may hold none."""
        if self.devices_per_replica > 1 and self.isolation != "process":
            return SS.slice_devices(SS.visible_devices(), i,
                                    self.devices_per_replica)
        if self._placed:
            return f"cuda:{i % torch.cuda.device_count()}"
        return str(self.device)

    def _host_blob(self, model) -> bytes:
        """``ipc.host_model(model)``, made once a model (the set's and an
        upgrade's at most)."""
        hit = self._blobs.get(id(model))
        if hit is None or hit[0] is not model:
            self._blobs = {k: v for k, v in self._blobs.items()
                           if v[0] is self.params}
            hit = (model, ipc.host_model(model))
            self._blobs[id(model)] = hit
        return hit[1]

    @property
    def on_preview(self) -> Optional[Callable]:
        return self._on_preview

    @on_preview.setter
    def on_preview(self, hook: Optional[Callable]) -> None:
        # the JAX set only copies the hook at bring-up, so the replicas
        # up at construction never preview; here they all do
        self._on_preview = hook
        if self.isolation == "thread":
            for r in self.replicas:
                if r.engine is not None:
                    r.engine.on_preview = hook

    # -- events ---------------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        try:
            self.metrics.event(**S.structured_event(kind, **fields))
        except Exception:   # noqa: BLE001 — observability must never
            pass            # take down supervision

    def _mark_replay(self, h: S.RequestHandle, reason: str,
                     replica: int) -> None:
        """Close the fence gap on a reclaimed handle's trace under
        ``replayed_from`` and open its next attempt."""
        if h.trace is not None:
            self.flight.record(h.trace.replay(
                self.clock(), reason=reason, replica=replica))

    def _scale_error(self, op: str, **fields) -> ScaleError:
        """A typed reshape refusal carrying the set ring's recent
        events (who is mid-upgrade, which bring-up failed)."""
        return ScaleError(S.structured_event(
            "serve_scale_reject", op=op, **fields,
            flight=self.flight.tail(32)))

    def debug_events(self) -> dict:
        """``GET /debug/events``: the set ring, each live replica's ring (a
        child's parent-side mirror), and each fenced replica's last
        dump."""
        out = {"server": self.flight.dump(), "replicas": {},
               "fenced": {str(i): d for i, d in self.fence_dumps.items()}}
        for r in self.replicas:
            if r.engine is not None:
                out["replicas"][str(r.index)] = r.engine.flight.dump()
        return out

    def _on_complete(self, handle: S.RequestHandle,
                     result: S.Result) -> None:
        """Every thread engine's ``complete`` hook: a canary is fulfilled
        here (it never reaches postprocess or the latency accounting),
        the rest flows downstream."""
        if getattr(handle, "canary", False) or self.complete is None:
            handle.fulfill(result)
        else:
            self.complete(handle, result)

    def _child_done(self, handle: S.RequestHandle,
                    result: S.Result) -> None:
        """A child's results (the client's ``on_done``), as
        ``Engine._finish`` hands them on: OK results flow downstream
        (postprocess), anything else and every canary fulfils the
        handle."""
        if result.status == S.OK and self.complete is not None \
                and not getattr(handle, "canary", False):
            self.complete(handle, result)
        else:
            handle.fulfill(result)

    # -- bring-up / circuit breaker -------------------------------------------

    def _bring_up(self, r: _Replica, now: float) -> bool:
        """One bring-up attempt: a fresh private queue and engine. A
        failure schedules the next attempt with backoff (BROKEN in
        between). The engine's ``weights_version`` stamps its results
        and keys its prefix cache, so an upgraded replica never serves
        the previous generation's cached prompt KV."""
        attempt = r.bringups
        r.bringups += 1
        model = self.params if r.params_override is None \
            else r.params_override
        ckpt = self.worker_ckpt if r.ckpt_override is None \
            else r.ckpt_override
        try:
            faults.on_replica_bringup(r.index, attempt)
            if r.born_scaled:
                faults.on_scale_add_bringup(r.index, attempt)
            if self.isolation == "process":
                client = ipc.ChildEngineClient(
                    None if ckpt is not None else self._host_blob(model),
                    index=r.index,
                    engine_kwargs={**self._child_kwargs,
                                   "weights_version": r.version,
                                   "model_version": r.version},
                    device=r.device,
                    ckpt_path=ckpt,
                    ckpt_use_ema=self.worker_use_ema,
                    ckpt_quantize=self.worker_quantize,
                    heartbeat_interval_s=min(
                        max(self.heartbeat_s / 5, 0.01), 0.25),
                    rss_limit_mb=self.child_rss_limit_mb,
                    # a hard-fault plan crosses once per activation per
                    # replica (faults.child_plan_for)
                    fault_plan=faults.child_plan_for(r.index),
                    idle_sleep_s=self._idle_sleep_s,
                    clock=self.clock,
                    on_done=self._child_done,
                    transport=self.transport,
                    listener=self.listener,
                    worker_cmd=self.worker_cmd,
                    num_pages=self._num_pages,
                    devices_per_replica=self.devices_per_replica)
            else:
                queue = S.RequestQueue(
                    max_depth=4 * self._engine_kwargs["num_slots"] + 8,
                    clock=self.clock)
                versioned = dict(weights_version=r.version,
                                 model_version=r.version)
                if self.devices_per_replica > 1:
                    # replica = mesh slice: the same engine surface
                    engine = MeshEngine(model, queue,
                                        complete=self._on_complete,
                                        clock=self.clock, devices=r.device,
                                        **versioned, **self._engine_kwargs)
                else:
                    engine = Engine(model, queue,
                                    complete=self._on_complete,
                                    clock=self.clock, device=self.device,
                                    **versioned, **self._engine_kwargs)
                engine.on_preview = self.on_preview
        except Exception as e:  # noqa: BLE001 — circuit-break, don't die
            r.attempt += 1
            self.bringup_failures += 1
            delay = self.bringup_policy.backoff(min(r.attempt - 1, 20))
            r.next_bringup_t = now + delay
            r.last_error = repr(e)
            r.state = BROKEN
            self._event("serve_replica_bringup_fail", replica=r.index,
                        attempt=attempt, consecutive=r.attempt,
                        backoff_s=round(delay, 3), error=repr(e))
            return False
        if self.isolation == "process":
            # the spawn is asynchronous: RUNNING means spawned, routing
            # waits for READY, and a child that dies or stalls before it
            # is a bring-up failure (nothing to reclaim), not a failover
            r.engine, r.queue = client, None
            r.dead = False
            r.await_ready = True
            r.stop = None
            r.state = RUNNING
            return True
        # an orphan is a handle the fenced engine popped but never
        # admitted: back to the shared queue
        engine.on_fenced_orphan = lambda h: self.queue.requeue(h)
        r.engine, r.queue = engine, queue
        r.attempt = 0
        r.dead = False
        r.last_error = ""
        r.stop = threading.Event()
        r.state = RUNNING
        self._event("serve_replica_up", replica=r.index,
                    bringups=r.bringups,
                    device=(str(self.device)
                            if self.devices_per_replica == 1
                            else [str(d) for d in r.device]))
        if self._started:
            self._spawn(r)
        return True

    # -- fencing and reclaim (failover / drain) -------------------------------

    def _fence_and_reclaim(self, r: _Replica, now: float,
                           reason: str) -> int:
        """Fence the replica's engine, then reclaim every request it held
        (private queue first, then the in-slot and mid-admission handles)
        into the shared queue at their arrival positions. Fencing comes
        first, so from here on this sweep alone owns those handles. A
        child goes another way (``_fence_and_reclaim_child``)."""
        if self.isolation == "process":
            return self._fence_and_reclaim_child(r, now, reason)
        eng, q = r.engine, r.queue
        r.engine, r.queue, r.thread = None, None, None
        if r.stop is not None:
            r.stop.set()
        reclaimed = 0
        if eng is not None:
            eng.fence()
            # a crashed loop left the lock free and the hang fault sleeps
            # outside it; a thread truly stuck INSIDE a step keeps it, and
            # the host bookkeeping below is safe to read anyway
            got = eng._lock.acquire(timeout=0.2)
            try:
                queued = q.drain() if q is not None else []
                slots = [s for s in list(eng.slots) if s is not None]
                inflight = eng.inflight_handles()
                hol = (None if eng.kv != "paged" or eng._hol_rid is None
                       else (eng._hol_rid, eng._hol_need))
            finally:
                if got:
                    eng._lock.release()
            retire = {k: getattr(eng, k, 0) for k in _COUNTERS}
            for s in slots:
                if s.shadow_of is None:
                    retire["tokens_decoded"] -= len(s.emitted)
                    retire["occupancy_sum"] -= len(s.emitted)
            for k in _COUNTERS:
                self._retired[k] += retire[k]
            seen: set = set()
            for h in queued + inflight:
                rid = h.request.request_id
                if h.done() or rid in seen:
                    continue
                seen.add(rid)
                if getattr(h, "canary", False):
                    # an upgrade probe dies with its replica, never
                    # replays as traffic
                    h.fulfill(S.Result(
                        status=S.CANCELLED, request_id=rid,
                        reason="canary cancelled (replica fenced)"))
                    continue
                self._mark_replay(h, reason, r.index)
                self.queue.requeue(h)
                reclaimed += 1
            if hol is not None and hol[0] in seen:
                self._hol_handoff[hol[0]] = hol[1]
                self.hol_handoffs += 1
                self._event("serve_hol_handoff", replica=r.index,
                            request_id=hol[0], pages_needed=hol[1])
        dump = eng.flight.dump() if eng is not None else []
        self.fence_dumps[r.index] = dump
        self.reclaimed += reclaimed
        self._event("serve_replica_fenced", replica=r.index,
                    reason=reason, reclaimed=reclaimed, flight=dump)
        return reclaimed

    def _fence_and_reclaim_child(self, r: _Replica, now: float,
                                 reason: str) -> int:
        """Kill, salvage, fence, reclaim from the shadow. The child is
        SIGKILLed first, so its transport stops growing while the frames
        it wrote before dying are read (their results stand, never
        replayed; the last snapshot is the last consistent counter
        state)."""
        client = r.engine
        r.engine, r.queue, r.thread = None, None, None
        r.await_ready = False
        reclaimed = 0
        if client is not None:
            # a child dead before we came died on its own (its decoded
            # exit is the story); one we kill must not read as an OS kill
            died_on_its_own = not client.alive_proc()
            client.hard_kill()
            r.last_exit = (client.exit_desc() if died_on_its_own
                           else f"hard-killed by supervisor ({reason})")
            client.salvage()
            client.fence()
            handles = client.reclaim()
            retire = client.retire_counters(handles)
            for k in _COUNTERS:
                self._retired[k] += retire.get(k, 0)
            self._retired_k4 += client.paged_decode_launches
            rids = set()
            for h in handles:
                rid = h.request.request_id
                if getattr(h, "canary", False):
                    h.fulfill(S.Result(
                        status=S.CANCELLED, request_id=rid,
                        reason="canary cancelled (replica fenced)"))
                    continue
                rids.add(rid)
                self._mark_replay(h, reason, r.index)
                self.queue.requeue(h)
                reclaimed += 1
            # the last frame's head-of-line reservation hands back as a
            # thread engine's does: the mirror answers for the corpse
            if client.hol is not None and client.hol[0] in rids:
                self._hol_handoff[client.hol[0]] = client.hol[1]
                self.hol_handoffs += 1
                self._event("serve_hol_handoff", replica=r.index,
                            request_id=client.hol[0],
                            pages_needed=client.hol[1])
        # the parent-side mirror of the child's ring: what the victim
        # told us before dying, a consistent prefix
        dump = client.flight.dump() if client is not None else []
        self.fence_dumps[r.index] = dump
        self.reclaimed += reclaimed
        self._event("serve_replica_fenced", replica=r.index,
                    reason=reason, reclaimed=reclaimed,
                    exit=r.last_exit, flight=dump)
        return reclaimed

    def _failover(self, r: _Replica, now: float, reason: str) -> None:
        self.failovers += 1
        self._fence_and_reclaim(r, now, reason)
        r.state = BROKEN
        r.next_bringup_t = now       # the first restart attempt is free

    # -- live KV migration (drain / scale-in / upgrade / roles) ---------------

    def _migrate_targets(self, src: _Replica, pin: Optional[str],
                         exclude_prefill: bool = False) -> List[_Replica]:
        """Replicas that could take a migrated request now: serving, not
        a canary, of the pinned version, with room; decode-capable ones
        first."""
        out = []
        for x in self.replicas:
            if x is src or x.state != RUNNING or x.engine is None \
                    or x.canary:
                continue
            if pin is not None and x.version != pin:
                continue
            if exclude_prefill and x.role == "prefill":
                continue
            if not self._replica_serving(x):
                continue
            if self._capacity(x) <= 0:
                continue
            out.append(x)
        out.sort(key=lambda x: (x.role == "prefill", -self._capacity(x),
                                x.index))
        return out

    def _inslot_requests(self, r: _Replica):
        """``(request_id, handle)`` of every request decoding on ``r``
        (canaries never migrate). A child's is its whole shadow: the
        parent cannot see which entries hold a slot, and the export of a
        queued one answers ``not_found``."""
        if self.isolation == "process":
            return [(rid, h) for rid, h in list(r.engine.shadow.items())
                    if not h.done() and not getattr(h, "canary", False)]
        eng = r.engine
        out = []
        with eng._lock:
            for s in eng.slots:
                if s is not None and s.shadow_of is None \
                        and not s.handle.done() \
                        and not getattr(s.handle, "canary", False):
                    out.append((s.handle.request.request_id, s.handle))
        return out

    def _migrate_fallback(self, src: _Replica, rid: int,
                          handle: Optional[S.RequestHandle],
                          reason: str, detail: str) -> None:
        """A migration giving up: the event, the counter, and — when the
        export already vacated the source slot — the replay itself."""
        self.migrate_fallbacks += 1
        self._event("serve_migrate_fallback", request_id=rid,
                    replica=src.index, reason=reason, error=detail)
        if handle is not None and not handle.done():
            self._mark_replay(handle, f"migration fallback ({reason})",
                              src.index)
            self.queue.requeue(handle)

    def _migrate_from(self, src: _Replica, now: float, reason: str,
                      pin_version: Optional[str] = None,
                      exclude_prefill: bool = False) -> int:
        """Move ``src``'s decoding requests to live targets MID-STREAM
        instead of replaying them from token zero; the planned-downtime
        paths call it just before their fence. Replay stays the fallback:
        a refused export leaves the request for the fence's reclaim, a
        refused import requeues it here. Returns the number moved."""
        if self.kv != "paged" or src.engine is None \
                or not self._replica_serving(src):
            return 0            # a corpse answers nothing: replay does
        proc = self.isolation == "process"
        moved = 0
        for rid, pre in self._inslot_requests(src):
            pin = pre.replay_version or pin_version or src.version
            targets = self._migrate_targets(src, pin, exclude_prefill)
            if not targets:
                break           # nowhere to land: the fence replays
            t0 = time.perf_counter()
            handle: Optional[S.RequestHandle] = None
            try:
                faults.on_migrate_transfer(
                    src.index, src.engine.pid if proc else None)
                if proc:
                    snap = src.engine.export_request(rid)
                    handle = src.engine.shadow.pop(rid, None)
                    if handle is None:
                        raise MigrationError(
                            "not_found", "no shadow handle for the "
                            "exported request")
                else:
                    snap, handle = src.engine.export_request(rid)
            except MigrationError as e:
                if e.reason == "not_found":
                    continue    # finished or not slotted: nothing to move
                self._migrate_fallback(src, rid, handle, e.reason, str(e))
                if not self._replica_serving(src):
                    break       # the source died: the fence replays
                continue
            except faults.FaultInjected as e:
                self._migrate_fallback(src, rid, handle, "source_dead",
                                       str(e))
                continue
            saved = len(snap.get("emitted") or ())
            dst = None
            err_reason, err_detail = "target_pages", ""
            for tgt in targets:
                try:
                    faults.on_migrate_import(tgt.index)
                    if proc:
                        tgt.engine.import_request(snap, handle)
                    else:
                        tgt.engine.import_slot(snap, handle)
                    dst = tgt
                    break
                except MigrationError as e:
                    err_reason, err_detail = e.reason, str(e)
                except faults.FaultInjected as e:
                    err_reason, err_detail = "target_pages", str(e)
            if dst is None:
                # the export credited the prefix to the source; the
                # replay re-credits every token, so un-credit it here
                self._retired["tokens_decoded"] -= saved
                self._retired["occupancy_sum"] -= saved
                self._migrate_fallback(src, rid, handle, err_reason,
                                       err_detail)
                continue
            wall = time.perf_counter() - t0
            moved += 1
            self.migrations += 1
            self.migrated_tokens_saved += saved
            self.migration_seconds.append(wall)
            if handle.trace is not None:
                self.flight.record(handle.trace.span(
                    "migrate", now, src=src.index, dst=dst.index,
                    tokens_saved=saved))
            self._event("serve_migrated", request_id=rid, src=src.index,
                        dst=dst.index, tokens_saved=saved, reason=reason,
                        wall_s=round(wall, 4))
        return moved

    def _role_handoff(self, now: float) -> bool:
        """The disaggregated sweep: each ``prefill`` replica hands its
        warm requests to decode-capable replicas, at most every 50 ms."""
        if self.kv != "paged" or self._upgrading:
            return False
        sources = [r for r in self.replicas
                   if r.state == RUNNING and r.role == "prefill"
                   and r.engine is not None]
        if not sources or now - self._role_sweep_t < 0.05:
            return False
        self._role_sweep_t = now
        did = False
        for r in sources:
            did = bool(self._migrate_from(
                r, now, reason="prefill_handoff",
                exclude_prefill=True)) or did
        return did

    # -- operator drain -------------------------------------------------------

    def drain_replica(self, index: int,
                      reason: str = "operator drain") -> int:
        """Planned maintenance: live-migrate the replica's decoding
        requests to survivors, fence and reclaim the rest (they replay),
        and hold it DOWN until ``undrain_replica``. Returns the requests
        handed on (migrated + reclaimed)."""
        with self._ctl_lock:
            self._reject_mid_upgrade("drain")
            r = self._replica_or_reject("drain", index)
            now = self.clock()
            # racelint: disable=RL003 — deliberate: reshapes are
            # serialized by _ctl_lock end-to-end; migration transfers
            # (and the fault hooks that delay them in tests) run under
            # it so no second reshape can observe a half-moved slot.
            # The data plane (engine/queue locks) is not held here.
            moved = self._migrate_from(r, now, reason=reason)
            n = self._fence_and_reclaim(r, self.clock(), reason)
            r.state = DRAINED
            return moved + n

    def undrain_replica(self, index: int) -> bool:
        """Back into routing: one bring-up attempt now."""
        with self._ctl_lock:
            self._reject_mid_upgrade("undrain")
            r = self.replicas[index]
            if r.state != DRAINED:
                return False
            return self._bring_up(r, self.clock())

    # -- elastic fleet: scale out and in --------------------------------------

    def _replica_or_reject(self, op: str, index: int) -> _Replica:
        if not 0 <= index < len(self.replicas):
            raise self._scale_error(op, replica=index,
                                    reason="no_such_replica",
                                    replicas=len(self.replicas))
        r = self.replicas[index]
        if r.state == RETIRED:
            raise self._scale_error(op, replica=index,
                                    reason="replica_retired")
        return r

    def _reject_mid_upgrade(self, op: str) -> None:
        if self._upgrading:
            raise self._scale_error(op, reason="upgrade_in_progress")

    def add_replica(self, role: str = "both") -> int:
        """Runtime scale-out: one new supervised slot, brought up now; it
        joins routing once serving, and a failed bring-up circuit-breaks
        like a restart. Past ``max_replicas`` (every replica holds its own
        KV pool, so the width is a memory budget) is a typed
        ``ScaleError``. Returns the new index."""
        with self._ctl_lock:
            self._reject_mid_upgrade("add")
            if role not in REPLICA_ROLES:
                raise self._scale_error("add", reason="unknown_role",
                                        role=str(role))
            if role != "both" and self.kv != "paged":
                raise self._scale_error(
                    "add", reason="roles_need_paged_kv", role=role)
            active = [r for r in self.replicas if r.state != RETIRED]
            if self.max_replicas and len(active) >= self.max_replicas:
                raise self._scale_error(
                    "add", reason="scale_out_past_cap",
                    replicas=len(active), max_replicas=self.max_replicas)
            index = len(self.replicas)
            r = _Replica(index, device=self._device_for(index),
                         version=self.weights_version, role=role)
            r.born_scaled = True
            self.replicas.append(r)
            self.n_replicas = len(active) + 1
            self.scale_outs += 1
            self._event("serve_scale_out", replica=index,
                        replicas=self.n_replicas,
                        weights_version=self.weights_version)
            self._bring_up(r, self.clock())
            return index

    def remove_replica(self, index: int, drain: bool = True,
                       reason: str = "operator scale-in") -> int:
        """Runtime scale-in: live-migrate the replica's decoding requests
        (unless ``drain=False``), fence and reclaim the rest, and RETIRE
        the slot for good. Removing the last live replica is a typed
        ``ScaleError``. Returns the requests handed on."""
        with self._ctl_lock:
            self._reject_mid_upgrade("remove")
            r = self._replica_or_reject("remove", index)
            survivors = [x for x in self.replicas
                         if x is not r and x.state != RETIRED]
            if not survivors:
                raise self._scale_error("remove", replica=index,
                                        reason="remove_last_replica")
            now = self.clock()
            # racelint: disable=RL003 — deliberate: scale-in migrates
            # under _ctl_lock so the reshape is atomic against other
            # control-plane ops; the data plane stays unlocked
            moved = self._migrate_from(r, now, reason=reason) \
                if drain else 0
            n = self._fence_and_reclaim(r, self.clock(), reason)
            r.state = RETIRED
            r.params_override = None
            r.ckpt_override = None
            self.n_replicas = len(survivors)
            self.scale_ins += 1
            self._event("serve_scale_in", replica=index, drain=drain,
                        migrated=moved, reclaimed=n,
                        replicas=self.n_replicas)
            return moved + n

    # -- elastic fleet: rolling weight swap -----------------------------------

    def _drive_until(self, pred: Callable[[], bool],
                     timeout_s: float) -> bool:
        """Wait for ``pred`` while the set keeps moving: threaded, the
        loops run, so sleep; under the sync driver, step."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if pred():
                return True
            if self._started:
                time.sleep(0.005)
            else:
                self.step_once()
        return pred()

    def _replica_serving(self, r: _Replica) -> bool:
        """The replica can decode a request now (a child: READY landed
        and the process is believable)."""
        if r.state != RUNNING or r.engine is None:
            return False
        if self.isolation == "process":
            c = r.engine
            return c.ready and not c.crashed and not c.poisoned \
                and not c.fenced and c.alive_proc()
        return True

    def _submit_canaries(self, r: _Replica, version: str,
                         canary_codes, n: int) -> List[S.RequestHandle]:
        """``n`` canary requests straight into replica ``r`` (its private
        queue, or its child): through the shared one a survivor would
        answer them."""
        now = self.clock()
        handles = []
        for k in range(n):
            codes = tuple(canary_codes[k % len(canary_codes)])
            rid = next(self._canary_ids)
            req = S.Request(codes=codes, seed=10_000 + k, request_id=rid,
                            submit_t=now)
            h = S.RequestHandle(req)
            h.queue_seq = rid       # unique (negative), heap-safe
            h.canary = True
            h.replay_version = version
            handles.append(h)
        with self._ctl_lock:
            if self.isolation == "process":
                r.engine.route(handles)
            else:
                for h in handles:
                    r.queue.requeue(h, count=False)
        return handles

    def _abort_upgrade(self, r: _Replica, version: str,
                       old_version: str, error: str,
                       timeout_s: float) -> None:
        """Roll every replica of the new generation back to the old
        weights and raise ``UpgradeAborted``: the fleet ends on
        ``old_version``, never mixed."""
        self._event("serve_upgrade_abort", replica=r.index, to=version,
                    error=error)
        rollback = [x for x in self.replicas
                    if x.state != RETIRED and x.version == version]
        for x in rollback:
            with self._ctl_lock:
                self._fence_and_reclaim(x, self.clock(),
                                        reason="upgrade rollback")
                x.canary = False
                x.version = old_version
                x.params_override = None
                x.ckpt_override = None
                self._bring_up(x, self.clock())
            self._drive_until(lambda x=x: self._replica_serving(x),
                              timeout_s)
        # a retry of the same version compares against fresh references
        for k in [k for k in self._canary_ref if k[0] == version]:
            del self._canary_ref[k]
        raise UpgradeAborted(S.structured_event(
            "serve_upgrade_aborted", replica=r.index, to=version,
            error=error, rolled_back=[x.index for x in rollback],
            fleet_version=old_version, flight=self.flight.tail(64)))

    def rolling_upgrade(self, *, version: str, params=None,
                        ckpt: Optional[str] = None,
                        canary_codes=None, canaries: int = 2,
                        replica_timeout_s: float = 300.0) -> dict:
        """Swap the fleet's weights replica by replica with zero dropped
        requests: ``params`` (the new version's ``DALLE`` module, on the
        set's device), or with ``worker_ckpt`` workers ``ckpt`` (the new
        checkpoint path each worker loads itself). Per replica, in index
        order: live-migrate its work to survivors of ITS generation and
        fence the rest (they replay on the old weights); bring it up on
        the new weights; gate it behind ``canaries`` requests decoded by
        it alone, whose tokens must equal the first upgraded replica's;
        rejoin routing. A failed gate, bring-up or canary aborts and
        rolls the fleet back (``UpgradeAborted``). Then the set's weights
        and version are the new ones. Returns the upgrade record."""
        with self._ctl_lock:
            self._reject_mid_upgrade("upgrade")
            if not version or version == self.weights_version:
                raise self._scale_error(
                    "upgrade", reason="version_unchanged",
                    weights_version=self.weights_version)
            if (params is None) == (ckpt is None):
                raise self._scale_error(
                    "upgrade", reason="need_exactly_one_of_params_or_ckpt")
            if ckpt is not None and self.worker_ckpt is None:
                raise self._scale_error(
                    "upgrade", reason="ckpt_upgrade_needs_worker_ckpt_set")
            if params is not None and self.worker_ckpt is not None:
                raise self._scale_error(
                    "upgrade", reason="params_upgrade_on_worker_ckpt_set")
            self._upgrading = True
        try:
            old_version = self.weights_version
            if canary_codes is None:
                canary_codes = [(1,) * min(2, self.cfg.text_seq_len)]
            record = {"from": old_version, "to": version,
                      "canaries": int(canaries), "replicas": []}
            self._event("serve_upgrade_begin", to=version,
                        from_version=old_version,
                        replicas=self.n_replicas)
            for r in list(self.replicas):
                if r.state == RETIRED:
                    continue
                if r.state == DRAINED:
                    # the drain contract outranks the rollout: it stays
                    # down, and its label moves with the promote
                    self._event("serve_upgrade_skip_drained",
                                replica=r.index, to=version)
                    record["replicas"].append(
                        {"replica": r.index, "skipped": "drained"})
                    continue
                t0 = time.perf_counter()
                # the drain-race row: a real SIGKILL of the child as the
                # planned drain begins (a thread replica raises)
                faults.on_upgrade_drain(
                    r.index, getattr(r.engine, "pid", None)
                    if self.isolation == "process" else None)
                with self._ctl_lock:
                    # racelint: disable=RL003 — deliberate: upgrade
                    # migration runs under _ctl_lock like every other
                    # reshape; see drain_replica() for the full rationale
                    migrated = self._migrate_from(
                        r, self.clock(),
                        reason=f"rolling upgrade to {version}",
                        pin_version=r.version)
                    reclaimed = self._fence_and_reclaim(
                        r, self.clock(),
                        reason=f"rolling upgrade to {version}")
                    r.version = version
                    r.params_override = params
                    r.ckpt_override = ckpt
                    r.canary = True
                    self._bring_up(r, self.clock())
                if not self._drive_until(lambda: self._replica_serving(r),
                                         replica_timeout_s):
                    self._abort_upgrade(
                        r, version, old_version,
                        f"bring-up on new weights timed out "
                        f"(> {replica_timeout_s:g}s): {r.last_error}",
                        replica_timeout_s)
                # taken once serving: a bring-up retry before this is the
                # supervisor at work, one during the canaries a death
                bringups0 = r.bringups
                handles = self._submit_canaries(r, version, canary_codes,
                                                canaries)
                self._drive_until(
                    lambda: all(h.done() for h in handles)
                    or r.bringups != bringups0
                    or not self._replica_serving(r),
                    replica_timeout_s)
                if r.bringups != bringups0 \
                        or not self._replica_serving(r):
                    self._abort_upgrade(
                        r, version, old_version,
                        f"replica died during canary: {r.last_error}",
                        replica_timeout_s)
                if not all(h.done() for h in handles):
                    self._abort_upgrade(
                        r, version, old_version,
                        f"canaries not answered within "
                        f"{replica_timeout_s:g}s", replica_timeout_s)
                try:
                    for k, h in enumerate(handles):
                        res = h.result(timeout=0)
                        if res.status != S.OK:
                            raise RuntimeError(
                                f"canary {k}: {res.status} "
                                f"({res.reason})")
                        if res.weights_version != version:
                            raise RuntimeError(
                                f"canary {k} stamped "
                                f"{res.weights_version!r}, expected "
                                f"{version!r}")
                        toks = np.asarray(res.tokens)
                        ref = self._canary_ref.setdefault((version, k),
                                                          toks)
                        if not np.array_equal(toks, ref):
                            raise RuntimeError(
                                f"canary {k} tokens diverged from the "
                                f"generation reference — two replicas "
                                f"of {version!r} must sample "
                                f"byte-identical streams")
                    faults.on_canary_gate(r.index, version)
                except Exception as e:  # noqa: BLE001 — typed abort
                    self._abort_upgrade(r, version, old_version,
                                        f"canary gate failed: {e}",
                                        replica_timeout_s)
                r.canary = False
                self._event("serve_upgrade_replica", replica=r.index,
                            to=version, migrated=migrated,
                            reclaimed=reclaimed, canaries=len(handles),
                            wall_s=round(time.perf_counter() - t0, 3))
                record["replicas"].append({
                    "replica": r.index, "migrated": migrated,
                    "reclaimed": reclaimed,
                    "wall_s": round(time.perf_counter() - t0, 3)})
            with self._ctl_lock:
                # promote: future bring-ups, scale-outs and stats speak
                # the new generation
                self.weights_version = version
                if params is not None:
                    self.params = params
                if ckpt is not None:
                    self.worker_ckpt = ckpt
                for r in self.replicas:
                    r.params_override = None
                    r.ckpt_override = None
                    if r.state == DRAINED:
                        r.version = version
                self.upgrades += 1
            self._event("serve_upgrade_done", to=version,
                        from_version=old_version,
                        replicas=len(record["replicas"]))
            return record
        finally:
            with self._ctl_lock:
                self._upgrading = False

    # -- supervision ----------------------------------------------------------

    def _check_replicas(self, now: float) -> bool:
        """One supervision sweep: crashed loops and missed heartbeats are
        fenced and reclaimed; broken replicas past their backoff get a
        bring-up attempt. Hang detection needs a loop THREAD: under the
        sync driver the caller is the loop, and crashes surface in
        ``step_once``."""
        did = False
        # a profiler capture slows every thread replica of the process
        # (its stop writes the trace): exempt them all while one runs
        capturing = self.isolation == "thread" and any(
            r.engine is not None and r.engine.capturing()
            for r in self.replicas if r.state == RUNNING)
        for r in self.replicas:
            if r.state == RUNNING and self.isolation == "process":
                did = self._check_child(r, now) or did
            elif r.state == RUNNING:
                if r.dead:
                    self._failover(r, now,
                                   reason=f"crash: {r.last_error}")
                    did = True
                elif r.thread is not None and not r.thread.is_alive():
                    self._failover(r, now, reason="loop thread died")
                    did = True
                elif r.thread is not None and r.engine is not None \
                        and not r.engine.compiling and not capturing \
                        and now - r.engine.last_heartbeat \
                        > self.heartbeat_s:
                    self._failover(
                        r, now,
                        reason=f"missed heartbeat "
                               f"(> {self.heartbeat_s:g}s: hang)")
                    did = True
            elif r.state == BROKEN and now >= r.next_bringup_t:
                did = self._bring_up(r, now) or did
        return did

    def _check_child(self, r: _Replica, now: float) -> bool:
        """One check of a RUNNING child: PID liveness with the exit
        decoded, then the frame stream's heartbeat deadline (alive but
        silent is wedged: hard-killed and fenced like a hang). A child
        that dies before READY never held work: a bring-up failure."""
        c = r.engine
        if c is None:
            return False
        if not c.ready:
            if c.crashed or c.poisoned or not c.alive_proc():
                c.hard_kill()
                self._bringup_fail_async(
                    r, now, f"child died in bring-up: "
                            f"{c.last_error or c.exit_desc()}")
                return True
            if now - c.started_t > self.spawn_timeout_s \
                    and not c.awaiting_operator:
                # a worker an operator starts has no spawn to time out
                c.hard_kill()
                self._bringup_fail_async(
                    r, now, f"child bring-up exceeded "
                            f"{self.spawn_timeout_s:g}s")
                return True
            return False
        if c.crashed:
            r.last_error = f"crash: {c.last_error}"
            self._failover(r, now, reason=r.last_error)
        elif c.poisoned:
            r.last_error = c.last_error
            self._failover(r, now, reason=r.last_error)
        elif not c.alive_proc():
            r.last_error = f"child exited: {c.exit_desc()}"
            self._failover(r, now, reason=r.last_error)
        else:
            # compiling stretches the deadline to compile_grace_s, not
            # forever; the reason names the deadline that expired
            if c.compiling:
                deadline, which = (max(self.heartbeat_s,
                                       self.compile_grace_s),
                                   "compile grace")
            else:
                deadline, which = self.heartbeat_s, "heartbeat"
            if now - c.last_heartbeat <= deadline:
                return False
            self._failover(
                r, now, reason=f"missed {which} deadline (> "
                               f"{deadline:g}s: hang)")
        return True

    def _bringup_fail_async(self, r: _Replica, now: float,
                            msg: str) -> None:
        """A child that died or stalled before READY counts against the
        circuit breaker as a failed constructor does."""
        c = r.engine
        r.engine, r.queue = None, None
        r.await_ready = False
        if c is not None:
            r.last_exit = c.exit_desc()
            c.fence()               # releases the dead child's transport
            # routing waits for READY, so the shadow is empty, but a
            # handle is never dropped on principle
            for h in c.reclaim():
                self.queue.requeue(h)
        r.attempt += 1
        self.bringup_failures += 1
        delay = self.bringup_policy.backoff(min(r.attempt - 1, 20))
        r.next_bringup_t = now + delay
        r.last_error = msg
        r.state = BROKEN
        self._event("serve_replica_bringup_fail", replica=r.index,
                    attempt=r.bringups - 1, consecutive=r.attempt,
                    backoff_s=round(delay, 3), error=msg,
                    exit=r.last_exit)

    def _pump_children(self, now: float) -> bool:
        """Drain every live child's transport: snapshots, harvested
        results, READY. The one place a child's results enter the
        parent (the control loop, or ``step_once``)."""
        did = False
        for r in self.replicas:
            c = r.engine
            if r.state != RUNNING or c is None:
                continue
            did = c.pump() or did
            if r.await_ready and c.ready:
                announced = c.worker_weights_version
                if announced and announced != r.version:
                    # a worker on the wrong generation never joins
                    # routing (a stale dialer during an upgrade)
                    self._bringup_fail_async(
                        r, now, f"worker announced weights "
                                f"{announced!r}, replica expects "
                                f"{r.version!r}")
                    did = True
                    continue
                r.await_ready = False
                r.attempt = 0
                r.last_error = ""
                r.conns += 1
                self._event("serve_replica_up", replica=r.index,
                            bringups=r.bringups, pid=c.pid,
                            transport=c.transport_kind, peer=c.peer,
                            weights_version=r.version)
                did = True
        return did

    # -- routing --------------------------------------------------------------

    def _expire(self, h: S.RequestHandle, now: float) -> None:
        req = h.request
        self.expired += 1
        self._hol_handoff.pop(req.request_id, None)
        self._version_holds.discard(req.request_id)
        self._event("serve_deadline", request_id=req.request_id,
                    where="queued", deadline_s=req.deadline_s,
                    waited_s=round(now - req.submit_t, 4))
        h.fulfill(S.Result(
            status=S.DEADLINE_EXCEEDED, request_id=req.request_id,
            reason=f"deadline_s={req.deadline_s:g} exceeded (queued)",
            weights_version=self.weights_version,
            queued_s=round(now - req.submit_t, 6),
            total_s=round(now - req.submit_t, 6)))

    def _capacity(self, r: _Replica) -> int:
        if self.isolation == "process":
            # the shadow is the parent's truth (the child's reports lag a
            # frame); one queued wave beyond the slots lets the child
            # prefill its next group while it decodes this one
            return max(0, 2 * r.engine.num_slots - len(r.engine.shadow))
        return max(0, r.engine.num_slots - r.engine.active_slots()
                   - r.queue.depth())

    def _pick(self, cands: List[_Replica], caps: dict,
              h: S.RequestHandle) -> _Replica:
        """Least-loaded with page awareness: most free slots first; among
        paged replicas, one whose pool can map the prompt span now (a
        handed-back HOL reservation's exact need, else the full span)
        beats one that would defer it; free pages break ties."""
        pin = h.replay_version
        handoff = self._hol_handoff.get(h.request.request_id)

        def score(r: _Replica):
            if pin is not None and r.version != pin:
                raise ReplayVersionMismatch(S.structured_event(
                    "serve_replay_version_mismatch",
                    request_id=h.request.request_id, pinned=pin,
                    replica=r.index, version=r.version))
            eng = r.engine
            fits, free_pages = True, 0
            if eng.kv == "paged":
                # a process replica's count is its child's last frame
                # (-1: no frame yet, stay optimistic); the child's
                # admission is the authority
                free_pages = eng.pages_free
                if free_pages < 0:
                    return (True, caps[r.index], 0, -r.index)
                if self.isolation == "process":
                    buckets, page_size = self._buckets, self._page_size
                else:
                    buckets, page_size = eng.buckets, eng.page_size
                try:
                    need = handoff if handoff is not None \
                        else KV.pages_for(
                            S.bucket_for(len(h.request.codes), buckets),
                            page_size)
                    fits = free_pages >= need
                except ValueError:
                    fits = True     # over-long: admission answers typed
            return (fits, caps[r.index], free_pages, -r.index)

        return max(cands, key=score)

    def _route(self, now: float) -> bool:
        """Move ready requests from the shared queue into per-replica
        private queues (``requeue(count=False)``: a hand-off keeping the
        handle's arrival position). Queued deadlines are reaped on every
        sweep, even with no live replica."""
        live = [r for r in self.replicas
                if r.state == RUNNING and r.engine is not None
                and not r.canary]
        if self.isolation == "process":
            # READY and believable now: never route into a corpse before
            # the next sweep fences it
            live = [r for r in live if self._replica_serving(r)]
        caps = {r.index: self._capacity(r) for r in live}
        ready, expired = self.queue.pop_ready(sum(caps.values()), now)
        for h in expired:
            self._expire(h, now)
        assigned: dict = {}
        for h in ready:
            pin = h.replay_version
            cands = [r for r in live if caps[r.index] > 0
                     and (pin is None or r.version == pin)]
            # every admission needs a prefill: decode replicas only when
            # no prefill-capable one has room
            cands = [r for r in cands if r.role != "decode"] or cands
            if not cands:
                self._route_hold(h, pin)
                continue
            r = self._pick(cands, caps, h)
            if pin is None:
                # pinned at first routing: a replay decodes on this
                # generation only
                h.replay_version = r.version
            if h.trace is not None:
                if not h.trace.has_in_attempt("queue_wait"):
                    self.flight.record(h.trace.span("queue_wait", now))
                self.flight.record(h.trace.span(
                    "route", now, replica=r.index,
                    weights_version=r.version))
            self._hol_handoff.pop(h.request.request_id, None)
            self._version_holds.discard(h.request.request_id)
            caps[r.index] -= 1
            if self.isolation == "process":
                assigned.setdefault(r.index, (r, []))[1].append(h)
            else:
                r.queue.requeue(h, count=False)
        for r, batch in assigned.values():
            r.engine.route(batch)       # one ADMIT frame a replica
        return bool(ready or expired)

    def _route_hold(self, h: S.RequestHandle,
                    pin: Optional[str]) -> None:
        """A request the router cannot place this sweep. A pinned replay
        whose generation still exists in the fleet is HELD at its arrival
        position; one whose generation has left is RELEASED (zero loss
        outranks a stale pin). Each is an event, once a request."""
        rid = h.request.request_id
        if pin is not None and not any(
                rr.version == pin and rr.state != RETIRED
                for rr in self.replicas):
            h.replay_version = None
            self._version_holds.discard(rid)
            self._event("serve_replay_version_released", request_id=rid,
                        pinned=pin, fleet_version=self.weights_version)
        elif rid not in self._version_holds:
            self._version_holds.add(rid)
            self._event("serve_replay_version_hold", request_id=rid,
                        pinned=pin)
        self.queue.requeue(h, count=False)

    # -- the threaded loops ---------------------------------------------------

    def _spawn(self, r: _Replica) -> None:
        # the hang deadline runs from the loop's start, not from the
        # engine's construction: ``start`` may build K4 in between
        r.engine.last_heartbeat = r.engine.clock()
        r.thread = threading.Thread(
            target=self._run_replica, args=(r, r.engine, r.stop),
            daemon=True, name=f"serve-replica-{r.index}")
        r.thread.start()

    def _run_replica(self, r: _Replica, engine: Engine, stop) -> None:
        """One replica's serving loop. An exception is a CRASH recorded
        for the supervisor, which replays the requests (contrast
        ``Engine.run``, which fails them in place); a fence ends the
        loop."""
        while not stop.is_set() and not engine.fenced:
            try:
                faults.on_replica_chunk(
                    r.index, engine.decode_steps // engine.chunk_steps)
                busy = engine.step_once()
            except Exception as e:  # noqa: BLE001 — supervised crash
                if engine.fenced or r.engine is not engine:
                    return      # a zombie: already fenced and replaced
                r.last_error = repr(e)
                r.dead = True
                self._event("serve_replica_crash", replica=r.index,
                            error=repr(e))
                return
            if not busy and engine.idle():
                stop.wait(self._idle_sleep_s)

    def _run_control(self, stop: threading.Event) -> None:
        """Routing and supervision (threaded mode); with process replicas
        the only loop of the parent: the children step themselves, this
        thread pumps their transports."""
        while not stop.is_set():
            now = self.clock()
            with self._ctl_lock:
                busy = False
                if self.isolation == "process":
                    busy = self._pump_children(now)
                busy = self._check_replicas(now) or busy
                busy = self._route(now) or busy
                # racelint: disable=RL003 — deliberate: role handoff is
                # a reshape (warm prefill→decode migration) and runs
                # under _ctl_lock like drain/scale-in/upgrade
                busy = self._role_handoff(now) or busy
            stop.wait(0.0005 if busy else self._idle_sleep_s)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ReplicaSet":
        """Threaded mode: one loop thread per live thread replica (K4's
        library loaded first, on this thread) and the control thread."""
        if self.isolation == "thread" and self.device.type == "cuda" \
                and self._engine_kwargs["paged_attn"] == "kernel":
            from dalle_pytorch_tpu_torch.ops import paged_attention as PA
            PA.load_kernel()
        self._started = True
        if self._t_start is None:
            self._t_start = self.clock()
        if self.isolation == "thread":      # children are their own loops
            for r in self.replicas:
                if r.state == RUNNING and r.thread is None:
                    self._spawn(r)
        self._ctl_stop = threading.Event()
        self._ctl_thread = threading.Thread(
            target=self._run_control, args=(self._ctl_stop,),
            daemon=True, name="serve-replica-control")
        self._ctl_thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop supervision, then every replica loop, each joined with its
        share of the deadline. A replica outliving its join is fenced; its
        private queue and in-slot handles are fulfilled ``cancelled``.
        No caller is left waiting."""
        t0 = time.perf_counter()
        self._ctl_stop.set()
        if self._ctl_thread is not None:
            self._ctl_thread.join(timeout)
        if self.isolation == "process":
            with self._ctl_lock:
                for r in self.replicas:
                    c = r.engine
                    if c is None:
                        continue
                    left = max(0.5, timeout - (time.perf_counter() - t0))
                    # SHUTDOWN, join, SIGKILL a straggler; close()
                    # salvages and fences, so nothing is fulfilled late
                    c.close(left / max(self.n_replicas, 1))
                    for h in c.reclaim():
                        h.fulfill(S.Result(
                            status=S.CANCELLED,
                            request_id=h.request.request_id,
                            reason="server shutdown"))
                if self.listener is not None:
                    self.listener.close()
            return
        with self._ctl_lock:
            for r in self.replicas:
                if r.stop is not None:
                    r.stop.set()
            for r in self.replicas:
                if r.thread is not None:
                    left = max(0.1, timeout - (time.perf_counter() - t0))
                    r.thread.join(left / max(len(self.replicas), 1))
            for r in self.replicas:
                eng, q = r.engine, r.queue
                if r.thread is not None and r.thread.is_alive() \
                        and eng is not None:
                    eng.fence()
                handles = []
                if q is not None:
                    handles.extend(q.drain())
                if eng is not None:
                    handles.extend(eng.inflight_handles())
                for h in handles:
                    if not h.done():
                        h.fulfill(S.Result(
                            status=S.CANCELLED,
                            request_id=h.request.request_id,
                            reason="server shutdown"))

    # -- the sync driver (tests) ----------------------------------------------

    def step_once(self) -> bool:
        """One set iteration: supervise, route, then step every live
        replica once. A crash fails over inline."""
        now = self.clock()
        if self._t_start is None:
            self._t_start = now
        with self._ctl_lock:
            did = False
            if self.isolation == "process":
                did = self._pump_children(now)
            did = self._check_replicas(now) or did
            did = self._route(now) or did
            # racelint: disable=RL003 — deliberate: same reshape-under-
            # _ctl_lock discipline as the driver loop above
            did = self._role_handoff(now) or did
        if self.isolation == "process":
            # the children step themselves: nap when nothing moved, so
            # run_until_idle does not spin while they decode
            if not did:
                time.sleep(0.001)
            return did
        for r in list(self.replicas):
            if r.state != RUNNING or r.engine is None:
                continue
            eng = r.engine
            try:
                faults.on_replica_chunk(
                    r.index, eng.decode_steps // eng.chunk_steps)
                did = eng.step_once() or did
            except Exception as e:  # noqa: BLE001 — supervised crash
                r.last_error = repr(e)
                self._event("serve_replica_crash", replica=r.index,
                            error=repr(e))
                with self._ctl_lock:
                    self._failover(r, self.clock(),
                                   reason=f"crash: {e!r}")
                did = True
        return did

    def idle(self) -> bool:
        if self.queue.depth() > 0:
            return False
        if self.isolation == "process":
            # the shadow is the parent's truth: routed and unresolved is
            # in flight somewhere
            return all(not r.engine.shadow for r in self.replicas
                       if r.engine is not None)
        for r in self.replicas:
            if r.queue is not None and r.queue.depth() > 0:
                return False
            if r.engine is not None and (r.engine.active_slots() > 0
                                         or r.engine._pending):
                return False
        return True

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            busy = self.step_once()
            if not busy and self.idle():
                return
        raise RuntimeError(
            f"replica set did not go idle in {max_steps} steps")

    # -- aggregate counters ---------------------------------------------------

    def _agg(self, name: str) -> int:
        return self._retired[name] + sum(
            getattr(r.engine, name, 0) for r in self.replicas
            if r.engine is not None)

    @property
    def tokens_decoded(self) -> int:
        return self._agg("tokens_decoded")

    @property
    def decode_steps(self) -> int:
        return self._agg("decode_steps")

    @property
    def harvests(self) -> int:
        return self._agg("harvests")

    @property
    def occupancy_sum(self) -> int:
        return self._agg("occupancy_sum")

    @property
    def completed(self) -> int:
        return self._agg("completed")

    # -- observability --------------------------------------------------------

    def _replica_alive(self, r: _Replica) -> bool:
        if r.state != RUNNING or r.engine is None:
            return False
        if self.isolation == "process":
            return r.engine.alive_proc()
        return r.thread is None or r.thread.is_alive()

    def alive(self) -> bool:
        """True while at least one replica serves (``/healthz`` answers
        503 only when every replica is down)."""
        return any(self._replica_alive(r) for r in self.replicas)

    def _child_fields(self, r: _Replica, now: float) -> dict:
        """A process replica's fields of /healthz and /stats: pid, RSS,
        restarts, reconnects, the decoded last exit, the transport
        block, the IPC lag, the child's K4 launches and its bring-up
        (seconds from the launch to each stage and to READY)."""
        rec = {"restarts": max(r.bringups - 1, 0),
               "reconnects": max(r.conns - 1, 0)}
        c = r.engine
        if c is not None:
            rec.update({"pid": c.pid, "rss_mb": c.rss_mb,
                        "ready": c.ready,
                        "paged_decode_launches": c.paged_decode_launches})
            if c.boot_s:
                rec["bringup_s"] = c.boot_s
            rec.update(c.transport_info(now))
            if c.ipc_lag_s:
                lags = sorted(c.ipc_lag_s)
                rec["ipc_lag_p50_ms"] = round(
                    1e3 * lags[len(lags) // 2], 4)
        if r.last_exit:
            rec["last_exit"] = r.last_exit
        return rec

    def replica_states(self) -> List[dict]:
        """The per-replica ``/healthz`` body; a process replica adds its
        child's fields (``_child_fields``)."""
        now = self.clock()
        out = []
        for r in self.replicas:
            rec = {"replica": r.index, "state": r.state,
                   "alive": self._replica_alive(r),
                   "bringups": r.bringups,
                   "weights_version": r.version, "role": r.role}
            if r.canary:
                rec["canary"] = True
            if r.engine is not None:
                rec["heartbeat_age_s"] = round(
                    max(now - r.engine.last_heartbeat, 0.0), 4)
            if self.isolation == "process":
                rec.update(self._child_fields(r, now))
            if r.last_error:
                rec["last_error"] = r.last_error
            out.append(rec)
        return out

    def paged_decode_launches(self) -> int:
        """Every child's K4 launches, the fenced ones' included (process
        replicas; a thread replica launches in this process, where
        ``PA.paged_decode_attention.launches`` counts it)."""
        return self._retired_k4 + sum(
            r.engine.paged_decode_launches for r in self.replicas
            if r.engine is not None and self.isolation == "process")

    def _kv_bytes_per_shard(self) -> int:
        """The KV bytes one device of a replica holds: a live thread
        engine's; a child's pool lives in another interpreter, so it is
        modelled from the config (divided over a mesh slice where its
        heads split, ``serve_specs.kv_heads_shard``)."""
        if self.isolation == "thread":
            live = [r for r in self.replicas if r.engine is not None]
            return live[0].engine._mesh_stats()[
                "kv_hbm_bytes_per_shard"] if live else 0
        kw = self._engine_kwargs
        total = KV.modeled_kv_bytes(
            self.cfg.transformer, kv=self.kv, num_slots=kw["num_slots"],
            total_len=self.cfg.seq_len, page_size=kw["page_size"],
            num_pages=kw["num_pages"], quantized=kw["quantize_cache"],
            dtype_bytes=self.params.text_emb.weight.element_size())
        m = self.devices_per_replica
        if m > 1 and SS.kv_heads_shard(self.cfg.transformer.heads, m):
            return total // m
        return total

    def stats(self) -> dict:
        """JAX's keys, less its compile counters (the port traces
        nothing); with process replicas, each child's fields and K4
        launches (``paged_decode_launches``), the transport and the
        listener's."""
        now = self.clock()
        elapsed = None if self._t_start is None \
            else max(now - self._t_start, 1e-9)
        live = [r for r in self.replicas if r.engine is not None]
        proc = self.isolation == "process"
        per = []
        for r in self.replicas:
            rec = {"replica": r.index, "state": r.state,
                   "weights_version": r.version, "role": r.role}
            if r.engine is not None:
                e = r.engine
                rec.update({
                    "active_slots": e.active_slots(),
                    # a child's shadow holds every outstanding request,
                    # the decoding ones included
                    "queued": (max(len(e.shadow) - e.active_slots(), 0)
                               if proc
                               else (r.queue.depth() if r.queue else 0)),
                    "completed": e.completed,
                    "tokens_decoded": e.tokens_decoded,
                })
                if e.kv == "paged" and e.pages_free >= 0:
                    rec["pages_free"] = e.pages_free
            if proc:
                rec.update(self._child_fields(r, now))
            per.append(rec)
        tokens = self.tokens_decoded
        steps = self.decode_steps
        out = {
            "replicas": self.n_replicas,
            "isolation": self.isolation,
            "devices_per_replica": self.devices_per_replica,
            "mesh_shape": ({SS.SERVE_AXIS: self.devices_per_replica}
                           if self.devices_per_replica > 1 else None),
            "kv_hbm_bytes_per_shard": self._kv_bytes_per_shard(),
            "alive_replicas": sum(1 for r in self.replicas
                                  if r.state == RUNNING
                                  and r.engine is not None),
            "kv": self.kv,
            "queue_depth": self.queue.depth() + sum(
                r.queue.depth() for r in live if r.queue is not None),
            "num_slots": sum(r.engine.num_slots for r in live),
            "active_slots": sum(r.engine.active_slots() for r in live),
            "chunk_steps": self._engine_kwargs["chunk_steps"],
            "decode_steps": steps,
            "tokens_decoded": tokens,
            "tokens_per_s": (round(tokens / elapsed, 2)
                             if elapsed else 0.0),
            "mean_occupancy": round(self.occupancy_sum / max(steps, 1),
                                    3),
            "completed": self.completed,
            "expired": self._agg("expired") + self.expired,
            "rejected": self.queue.rejected,
            "requeued": self.queue.requeued,
            "harvests": self.harvests,
            "host_round_trips_per_token": round(
                self.harvests / max(tokens, 1), 6),
            "failovers": self.failovers,
            "reclaimed": self.reclaimed,
            "bringup_failures": self.bringup_failures,
            "evicted": self._agg("evicted"),
            "prefix_hits": self._agg("prefix_hits"),
            "prefix_entries": sum(
                len(r.engine.prefix) for r in live
                if getattr(r.engine, "prefix", None) is not None),
            "weights_version": self.weights_version,
            "max_replicas": self.max_replicas,
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "upgrades": self.upgrades,
            "upgrading": self._upgrading,
            "migrations": self.migrations,
            "migrate_fallbacks": self.migrate_fallbacks,
            "migrated_tokens_saved": self.migrated_tokens_saved,
            "hol_handoffs": self.hol_handoffs,
            "flight_events": len(self.flight),
            "per_replica": per,
        }
        if proc:
            out["transport"] = self.transport
            out["paged_decode_launches"] = self.paged_decode_launches()
            if self.listener is not None:
                # where a remote worker dials, how many the HELLO gate
                # refused, and which indices may attach now
                out["worker_endpoint"] = self.listener.endpoint
                out["attach_rejected"] = self.listener.rejected
                out["attach_expected"] = self.listener.expected_indices()
        return out
