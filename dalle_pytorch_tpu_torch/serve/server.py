"""Serving front end: the threaded Python API and the standard-library
HTTP server.

Port of ``dalle_pytorch_tpu/serve/server.py`` (``InferenceServer``
``:34-896``, ``make_http_server`` and ``serve_http`` ``:898-1152``).
``InferenceServer`` wires ``scheduler.RequestQueue`` (admission) ->
``engine.Engine`` (slot-batched decode, its own thread) or, with
``replicas > 1`` (or an autoscaler, or ``max_replicas`` room to grow),
``replica.ReplicaSet`` (supervised engines: a thread each, or with
``isolation='process'`` a child process each, over a pipe or a
dial-back socket) -> ``postprocess.PostProcessor`` (VAE and CLIP, its
own thread)
and owns their lifecycle; ``start()`` claims the device under the
deadline, backoff and jitter of ``resilience.retry``, so a claim that
hangs or fails surfaces as a ``BringupError``.

The device work stays on the default stream of the engine threads and
the postprocess worker's (K4's split merge shares one counter buffer
per device and relies on launch order, see
``ops/paged_attention.py::_counters``); an HTTP thread only reads host
state and host copies.

Two call surfaces:

* Python: ``submit(codes, ...) -> RequestHandle`` (a ``GroupFuture`` for
  ``n_samples > 1``), ``generate``, ``stats()``, ``health()``,
  ``scale(op, ...)`` (add / remove / drain / undrain / upgrade / status on
  a replica set);
* HTTP (``make_http_server`` / ``serve_http``): ``POST /generate``
  ``{"codes": [...] | "caption": "...", knobs...}`` answers the result's
  JSON body, or an SSE stream with ``"stream": true``; ``GET /healthz``,
  ``/stats``, ``/metrics`` (Prometheus text) and ``/debug/events`` (the
  flight recorder); ``POST /admin/scale`` and ``/admin/profile`` behind
  the admin token. Status codes and bodies are the JAX server's.

A single engine answers ``scale()`` with the typed
``not_a_replica_set`` refusal. Process replicas refuse streams and
in-server profiles typed (a child's engine runs in another interpreter,
out of this process's sinks and profiler), and ``/healthz`` and
``/stats`` carry each child's pid, RSS, restarts, last exit, transport
block and K4 launches. A cell of the gateway (``serve/gateway.py``) is
an ``InferenceServer``: the gateway submits with its own replayable
``sinks``. ``mesh_devices`` m above 1 serves from a
``serve/mesh_engine.py::MeshEngine`` over the first m visible devices
(``serve_specs.visible_devices``), or makes each replica of a set a
mesh slice; ``/healthz`` and ``/stats`` carry ``devices_per_replica``
and ``mesh_shape``.
"""

from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import torch

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.obs import registry as obs_registry
from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
from dalle_pytorch_tpu_torch.serve import auth
from dalle_pytorch_tpu_torch.serve import engine as engine_mod
from dalle_pytorch_tpu_torch.serve import fanout
from dalle_pytorch_tpu_torch.serve import postprocess as post_mod
from dalle_pytorch_tpu_torch.serve import replica as replica_mod
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import stream as stream_mod
from dalle_pytorch_tpu_torch.serve.engine import ProfileError
from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
from dalle_pytorch_tpu_torch.serve.replica import ScaleError, UpgradeAborted


class InferenceServer:
    """Continuous-batching text -> image service on one engine (its own
    thread) or a replica set, and a postprocess worker.

    ``model`` and ``vae`` are the port's ``DALLE`` and ``VAEDecoder`` on
    the server's device (the card unless ``device`` says otherwise; with
    ``mesh_devices`` above 1 the DALLE may lie on the CPU, from where
    each mesh places its shards);
    ``clip`` scores every image. ``replicas``, ``replica_roles``,
    ``max_replicas``, ``autoscale`` (a ``serve.autoscale
    .AutoscalePolicy``), ``heartbeat_s`` and ``load_weights`` (a
    checkpoint path -> ``DALLE`` on the device, for ``POST /admin/scale``
    upgrades) shape the replica set, and ``isolation``,
    ``child_rss_limit_mb``, ``transport``, ``worker_endpoint``,
    ``worker_cmd``, ``attach_token``, ``worker_ckpt``,
    ``worker_use_ema`` and ``worker_quantize`` its process replicas;
    ``mesh_devices`` the devices each engine spans; the other keywords
    are the JAX server's."""

    def __init__(self, model, vae, *, clip=None,
                 num_slots: int = 4, queue_depth: int = 64,
                 chunk_steps: int = 8,
                 prefill_buckets=None,
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
                 stream_max_events: int = 256,
                 default_cfg_scale: float = 0.0,
                 replicas: int = 1,
                 mesh_devices: int = 1,
                 replica_roles=None,
                 weights_version: str = "0",
                 max_replicas: int = 0,
                 autoscale=None,
                 admin_token: Optional[str] = None,
                 load_weights: Optional[Callable] = None,
                 heartbeat_s: float = 5.0,
                 isolation: str = "thread",
                 child_rss_limit_mb: int = 0,
                 transport: str = "pipe",
                 worker_endpoint: str = "127.0.0.1:0",
                 worker_cmd: Optional[str] = None,
                 attach_token: Optional[str] = None,
                 worker_ckpt: Optional[str] = None,
                 worker_use_ema: bool = False,
                 worker_quantize: str = "none",
                 decode_images: bool = True,
                 metrics=None, log_every: int = 50,
                 profile_dir: Optional[str] = None,
                 encode: Optional[Callable[[str], List[int]]] = None,
                 init_deadline_s: float = 0.0, init_retries: int = 3,
                 device=None):
        self.device = resolve_device(device)
        cfg = self.cfg = model.cfg
        self.metrics = metrics
        self.encode = encode
        # the default directory of POST /admin/profile captures
        self.profile_dir = profile_dir or None
        # guidance for a request that does not carry its own cfg_scale
        self.default_cfg_scale = float(default_cfg_scale)
        if self.default_cfg_scale < 0:
            raise ValueError(f"default_cfg_scale must be >= 0, got "
                             f"{default_cfg_scale}")
        self.init_deadline_s = init_deadline_s
        self.init_retries = init_retries
        # /admin/* authenticate against this (generated when not given)
        self.admin_token = admin_token or secrets.token_hex(16)
        self.weights_version = str(weights_version)
        self.replicas = int(replicas)
        self.mesh_devices = int(mesh_devices)
        if self.mesh_devices < 1:
            raise ValueError(f"mesh_devices must be >= 1, got "
                             f"{mesh_devices}")
        self.autoscale_policy = autoscale
        self.autoscaler = None
        self.load_weights = load_weights
        self.max_replicas = int(max_replicas)
        # a single-replica server with an autoscaler or a max_replicas
        # headroom still fronts a set: elasticity needs slots to grow into
        self._is_set = (self.replicas > 1 or autoscale is not None
                        or self.max_replicas > 1)
        self.replica_roles = tuple(replica_roles) if replica_roles \
            else None
        if self.replica_roles and not self._is_set:
            raise ValueError("replica_roles requires a replica set "
                             "(replicas >= 2)")
        if autoscale is not None:
            # the policy's cap and the set's must agree, or the scaler
            # would ask for replicas the set refuses
            self.max_replicas = max(self.max_replicas,
                                    autoscale.max_replicas)
        # JAX's checks: each would otherwise drop a flag on the floor
        if worker_ckpt is not None and transport != "socket":
            raise ValueError(
                "worker_ckpt requires transport='socket' — its point "
                "is that a worker loads the checkpoint from its OWN "
                "host's store instead of receiving params over a pipe")
        if isolation == "process" and self.replicas < 2:
            raise ValueError("isolation='process' requires replicas >= 2")
        if transport != "pipe" and isolation != "process":
            raise ValueError(
                f"transport={transport!r} requires isolation='process'")
        if worker_cmd is not None and self.replicas < 2:
            raise ValueError("worker_cmd requires replicas >= 2 with "
                             "isolation='process' and "
                             "transport='socket'")
        self.isolation = str(isolation)

        self.queue = S.RequestQueue(
            max_depth=queue_depth,
            # a prompt the slots cannot hold is refused here (HTTP 400)
            max_prompt_len=cfg.text_seq_len,
            on_event=self._queue_event)
        engine_kw = dict(
            num_slots=num_slots, chunk_steps=chunk_steps,
            prefill_buckets=prefill_buckets, complete=self._on_decoded,
            metrics=metrics, log_every=log_every,
            quantize_cache=quantize_cache, kv=kv, page_size=page_size,
            num_pages=num_pages, paged_attn=paged_attn,
            sparse_reads=sparse_reads, speculative=speculative,
            draft_layers=draft_layers, prefix_cache=prefix_cache,
            preview_every=preview_every, device=self.device)
        if self._is_set:
            self.engine = replica_mod.ReplicaSet(
                model, self.queue, replicas=self.replicas,
                heartbeat_s=heartbeat_s, isolation=isolation,
                child_rss_limit_mb=child_rss_limit_mb,
                transport=transport, worker_endpoint=worker_endpoint,
                worker_cmd=worker_cmd, attach_token=attach_token,
                worker_ckpt=worker_ckpt, worker_use_ema=worker_use_ema,
                worker_quantize=worker_quantize,
                weights_version=self.weights_version,
                max_replicas=self.max_replicas, roles=self.replica_roles,
                devices_per_replica=self.mesh_devices, **engine_kw)
            if self.autoscale_policy is not None:
                from dalle_pytorch_tpu_torch.serve.autoscale import \
                    Autoscaler
                # decisions land in the set's flight ring
                self.autoscaler = Autoscaler(
                    self.engine, self.autoscale_policy,
                    metrics=self.engine.metrics)
        elif self.mesh_devices > 1:
            # one engine over a device mesh: the single-engine thread
            # loop drives it unchanged
            engine_kw.pop("device")
            self.engine = MeshEngine(
                model, self.queue,
                devices=SS.slice_devices(SS.visible_devices(), 0,
                                         self.mesh_devices),
                weights_version=self.weights_version,
                model_version=self.weights_version, **engine_kw)
        else:
            self.engine = engine_mod.Engine(
                model, self.queue, weights_version=self.weights_version,
                model_version=self.weights_version, **engine_kw)

        # after the engine, so its events tee into the engine's ring
        self.post = None
        if decode_images:
            self.post = post_mod.PostProcessor(
                vae, model, clip=clip, metrics=self.engine.metrics,
                on_fulfill=self._record_latency)

        # streams and groups
        self.stream_max_events = int(stream_max_events)
        self.preview_every = int(preview_every)
        if self.post is not None and preview_every:
            self.engine.on_preview = self.post.submit_preview
        # live registries, swept at stats() time: sinks whose channel has
        # not ended (streams_active) and groups not yet assembled
        # (groups_in_flight); a completed group under paged + prefix
        # banks the pages its siblings' prompts shared
        self._streams: list = []
        self._groups: list = []
        self._stream_lock = threading.Lock()
        self.fanout_pages_saved = 0
        self.groups_completed = 0
        self._page_size = (int(page_size) or min(16, cfg.seq_len)) \
            if kv == "paged" else 0
        self._cow_sharing = (kv == "paged" and prefix_cache)

        # /metrics: the sliding-window latency histograms, labelled by
        # weights_version; counters and gauges are read from stats() at
        # each scrape
        self.registry = obs_registry.Registry()
        self.hist_e2e = self.registry.histogram(
            "dalle_serve_e2e_latency_seconds",
            "End-to-end latency of successful requests "
            "(submit -> caller-visible fulfilment)")
        self.hist_queue_wait = self.registry.histogram(
            "dalle_serve_queue_wait_seconds",
            "Queue wait of successful requests (submit -> admission)")
        self.hist_prefill = self.registry.histogram(
            "dalle_serve_prefill_seconds",
            "Prefill/admission span per successful request "
            "(pop -> slotted; trace span prefill_admit)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0))
        self.hist_ms_per_token = self.registry.histogram(
            "dalle_serve_decode_ms_per_token",
            "Decode milliseconds per generated token, per successful "
            "request",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                     50.0, 100.0, 250.0, 1000.0))
        self.hist_migration = self.registry.histogram(
            "dalle_serve_migration_seconds",
            "Wall seconds per successful live slot migration "
            "(export -> installed on the target)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
        self._profile_arm_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- stage glue ---------------------------------------------------------

    def _queue_event(self, rec: dict) -> None:
        # submit-time rejects: the flight ring, and the JSONL sink if any
        self.engine.flight.record(rec)
        if self.metrics is not None:
            self.metrics.event(**rec)

    def _record_latency(self, result: S.Result) -> None:
        """The histogram feed, once per DELIVERED request (it runs at the
        one fulfilment funnel): successes only, so a failing dependency
        cannot deflate the percentiles."""
        if not result.ok:
            return
        v = result.weights_version or ""
        self.hist_e2e.observe(result.total_s, weights_version=v)
        self.hist_queue_wait.observe(result.queued_s, weights_version=v)
        if result.tokens is not None and result.decode_s > 0:
            self.hist_ms_per_token.observe(
                1e3 * result.decode_s / max(len(result.tokens), 1),
                weights_version=v)
        tr = result.trace
        if tr is not None:
            prefill = sum(s["total_s"] for s in tr.get("spans", ())
                          if s.get("name") == "prefill_admit")
            if prefill > 0:
                self.hist_prefill.observe(prefill, weights_version=v)

    def _on_decoded(self, handle: S.RequestHandle,
                    result: S.Result) -> None:
        if self.post is not None:
            # latency is recorded by the worker's on_fulfill, after the
            # VAE and CLIP time is in total_s
            self.post.submit(handle, result)
            return
        tr = handle.trace
        if tr is not None and result.trace is None:
            result.trace = tr.summary()
        self._record_latency(result)
        handle.fulfill(result)

    # -- lifecycle ----------------------------------------------------------

    def _claim(self, attempt: int) -> str:
        """One claim of the server's device: ``torch.cuda.init()`` and
        one allocation there. Raises where there is no card."""
        from dalle_pytorch_tpu_torch.resilience import faults
        faults.maybe_activate_from_env()
        faults.on_backend_init(attempt)
        if self.device.type == "cuda":
            torch.cuda.init()
        torch.empty((1,), device=self.device).zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return str(self.device)

    def start(self) -> "InferenceServer":
        """Claim the device (deadline-bounded, retried with backoff) and
        start the postprocess and engine threads."""
        from dalle_pytorch_tpu_torch.resilience import retry as rretry
        policy = rretry.RetryPolicy(
            max_attempts=max(self.init_retries, 1),
            deadline_s=self.init_deadline_s or None)
        rretry.retry_with_backoff(
            self._claim, policy, label="serve_backend_init",
            on_event=(lambda rec: self.metrics.resilience(
                rec.get("kind", "bringup_retry"),
                **{k: v for k, v in rec.items()
                   if k not in ("time", "event", "kind")})
            ) if self.metrics is not None else None)
        if self.post is not None:
            self.post.start()
        if self._is_set:
            self.engine.start()     # per-replica threads + supervisor
            if self.autoscaler is not None:
                self.autoscaler.start()
        else:
            self._thread = threading.Thread(
                target=self.engine.run, args=(self._stop,), daemon=True,
                name="serve-engine")
            self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Close the queue (a racing submit gets ``QueueClosed``), stop
        and join the engine thread, cancel everything queued and every
        in-slot request (typed results), then drain the postprocess
        stage. The drain comes after the engine stops, so a late requeue
        is cancelled on the spot. A replica set joins every replica thread
        with its share of the deadline and fences one that outlives it."""
        self.queue.close()
        self._stop.set()
        if self.autoscaler is not None:
            self.autoscaler.close()     # no reshapes during teardown
        if self._is_set:
            self.engine.close(timeout)
        elif self._thread is not None:
            self._thread.join(timeout)
        for handle in self.queue.drain():
            handle.fulfill(S.Result(
                status=S.CANCELLED, request_id=handle.request.request_id,
                reason="server shutdown"))
        if not self._is_set:
            self.engine.cancel_active("server shutdown")
        if self.post is not None:
            self.post.close(timeout)

    # -- the Python API -----------------------------------------------------

    def submit(self, codes, *, seed: int = 0, temperature: float = 1.0,
               filter_thres: float = 0.5, top_p: float = 0.0,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               cfg_scale: Optional[float] = None,
               tenant: str = "",
               stream: bool = False,
               n_samples: int = 1,
               image_seq_len_override: int = 0,
               sinks: Optional[list] = None):
        """Enqueue one request. Raises a ``scheduler.ServeRejected``:
        ``QueueFull``, ``InvalidRequest`` (empty or over-long prompt),
        ``QueueClosed`` after ``close()``. ``stream=True`` attaches a
        ``TokenSink`` (the handle's ``.sink``); ``n_samples > 1`` admits a
        best-of-N group and returns its ``GroupFuture``;
        ``image_seq_len_override`` caps the image span. ``sinks`` are an
        upstream tier's (the gateway's) pre-built sinks, one a sample,
        used instead of fresh ones: a replayed dispatch feeds the same
        client-facing sinks, whose high-water marks drop what was
        already sent."""
        if cfg_scale is None:
            cfg_scale = self.default_cfg_scale
        if stream and self.isolation == "process":
            # a child's stand-in handle has no sink: a "stream" would be
            # a lie, so a typed refusal rather than a silent one-shot
            record = S.structured_event(
                "serve_reject", reason="stream_process_isolation",
                detail="token streaming requires isolation='thread' — "
                       "a child-process engine's harvest loop cannot "
                       "reach this process's sinks")
            self._queue_event(record)
            raise S.InvalidRequest(record)
        request = S.Request(
            codes=tuple(int(c) for c in codes), seed=seed,
            sampling=S.SamplingParams(temperature=temperature,
                                      filter_thres=filter_thres,
                                      top_p=top_p),
            priority=priority, deadline_s=deadline_s,
            cfg_scale=float(cfg_scale), tenant=str(tenant),
            stream=bool(stream), n_samples=int(n_samples),
            image_seq_len_override=int(image_seq_len_override))
        if request.n_samples > 1:
            group = fanout.submit_group(
                self.queue, request, metrics=self.metrics,
                max_events=self.stream_max_events, sinks=sinks)
            with self._stream_lock:
                self._groups.append(group)
                if group.sink is not None:
                    self._streams.append(group.sink)
            return group
        sink = sinks[0] if sinks else None
        if request.stream and sink is None:
            sink = stream_mod.TokenSink(max_events=self.stream_max_events,
                                        metrics=self.metrics)
        handle = self.queue.submit(request, sink=sink)
        if sink is not None:
            sink.request_id = handle.request.request_id
            with self._stream_lock:
                self._streams.append(sink)
        return handle

    def _sweep_streams(self) -> None:
        """Retire finished streams and groups and bank each completed
        group's shared prompt pages (called by ``stats()``)."""
        with self._stream_lock:
            self._streams = [s for s in self._streams if not s.done]
            still = []
            for g in self._groups:
                if not g.done():
                    still.append(g)
                    continue
                self.groups_completed += 1
                if self._cow_sharing:
                    self.fanout_pages_saved += fanout.group_pages_saved(
                        g.request.n_samples, len(g.request.codes),
                        self._page_size)
            self._groups = still

    def generate(self, codes, timeout: Optional[float] = None,
                 **kwargs) -> S.Result:
        """Submit and wait."""
        return self.submit(codes, **kwargs).result(timeout)

    def engine_alive(self) -> bool:
        """True while the serving loop runs (or before start); for a set,
        while at least one replica serves."""
        if self._is_set:
            return self.engine.alive()
        return self._thread is None or self._thread.is_alive()

    def health(self) -> dict:
        """The /healthz body; ``ok`` False (HTTP 503) once the engine
        thread has died, or every replica of a set is down. A set adds
        each replica's state and heartbeat age."""
        out = {"ok": self.engine_alive(),
               "devices_per_replica": self.mesh_devices,
               "mesh_shape": ({SS.SERVE_AXIS: self.mesh_devices}
                              if self.mesh_devices > 1 else None)}
        if self._is_set:
            out["replicas"] = self.engine.replica_states()
            out["weights_version"] = self.engine.weights_version
            out["upgrading"] = self.engine._upgrading
        return out

    def scale(self, op: str, **kwargs) -> dict:
        """One operator reshape (``POST /admin/scale``): ``add``,
        ``remove``, ``drain``, ``undrain``, ``upgrade`` (a checkpoint
        path through ``load_weights``, or the path itself to
        ``worker_ckpt`` workers) or ``status``, on the replica set.
        Raises its typed errors (``ScaleError``, ``UpgradeAborted``); a
        single engine is no replica set."""
        if not self._is_set:
            raise ScaleError(S.structured_event(
                "serve_scale_reject", op=op, reason="not_a_replica_set"))
        rs = self.engine
        if op == "add":
            index = rs.add_replica(role=str(kwargs.get("role", "both")))
            return {"op": op, "replica": index, "replicas": rs.n_replicas}
        if op == "remove":
            index = int(kwargs["replica"])
            n = rs.remove_replica(index,
                                  drain=bool(kwargs.get("drain", True)))
            return {"op": op, "replica": index, "reclaimed": n,
                    "replicas": rs.n_replicas}
        if op == "drain":
            index = int(kwargs["replica"])
            return {"op": op, "replica": index,
                    "reclaimed": rs.drain_replica(index)}
        if op == "undrain":
            index = int(kwargs["replica"])
            return {"op": op, "replica": index,
                    "ok": rs.undrain_replica(index)}
        if op == "upgrade":
            ckpt = kwargs.get("ckpt")
            version = kwargs.get("version") or str(ckpt)
            if ckpt is None:
                raise ScaleError(S.structured_event(
                    "serve_scale_reject", op=op,
                    reason="upgrade_needs_ckpt"))
            up = dict(version=str(version),
                      canaries=int(kwargs.get("canaries", 2)))
            if rs.worker_ckpt is not None:
                # checkpoint-path workers: the path is the upgrade, each
                # worker loads and validates it itself
                up["ckpt"] = str(ckpt)
            else:
                if self.load_weights is None:
                    raise ScaleError(S.structured_event(
                        "serve_scale_reject", op=op,
                        reason="no_weight_loader",
                        detail="server built without load_weights; "
                               "pass params via the Python API"))
                try:
                    up["params"] = self.load_weights(str(ckpt))
                except Exception as e:  # noqa: BLE001 — a bad path is
                    # the likeliest operator mistake: a typed refusal,
                    # the fleet untouched
                    raise ScaleError(S.structured_event(
                        "serve_scale_reject", op=op,
                        reason="weight_load_failed", ckpt=str(ckpt),
                        error=repr(e))) from e
            record = rs.rolling_upgrade(**up)
            self.weights_version = rs.weights_version
            return {"op": op, **record}
        if op == "status":
            return {"op": op, "replicas": rs.replica_states(),
                    "weights_version": rs.weights_version,
                    "upgrading": rs._upgrading,
                    "max_replicas": rs.max_replicas,
                    "scale_outs": rs.scale_outs,
                    "scale_ins": rs.scale_ins,
                    "upgrades": rs.upgrades}
        raise ScaleError(S.structured_event(
            "serve_scale_reject", op=op, reason="unknown_op"))

    def stats(self) -> dict:
        out = self.engine.stats()
        if self._is_set:
            # the set records migration wall times, the server exposes
            samples = self.engine.migration_seconds
            while samples:
                self.hist_migration.observe(samples.pop(0))
        e2e_ps = self.hist_e2e.percentiles((0.50, 0.95, 0.99))
        out.update({
            "requests_submitted": self.queue.submitted,
            # the histogram windows are the one latency source (the same
            # samples /metrics exposes)
            "p50_latency_s": round(e2e_ps[0.50], 4),
            "p95_latency_s": round(e2e_ps[0.95], 4),
            "latency_ms": {
                "e2e": {f"p{int(q * 100)}": round(1e3 * e2e_ps[q], 3)
                        for q in (0.50, 0.95, 0.99)},
                "queue_wait": self.hist_queue_wait.percentiles_ms(),
            },
            "postprocess_pending": (self.post.pending()
                                    if self.post is not None else 0),
        })
        self._sweep_streams()
        with self._stream_lock:
            out.update({
                "streams_active": len(self._streams),
                "groups_in_flight": len(self._groups),
                "groups_completed": self.groups_completed,
                "fanout_pages_saved": self.fanout_pages_saved,
            })
        out["preview_frames"] = (self.post.preview_frames
                                 if self.post is not None else 0)
        out["preview_drops"] = (self.post.preview_drops
                                if self.post is not None else 0)
        return out

    # -- /metrics (Prometheus text exposition) ------------------------------

    # (stats key, metric name, help): counters are lifetime totals, gauges
    # point-in-time; a key absent from stats() renders nothing
    _COUNTER_METRICS = (
        ("requests_submitted", "dalle_serve_requests_submitted_total",
         "Requests accepted by the admission queue"),
        ("completed", "dalle_serve_requests_completed_total",
         "Requests decoded to completion"),
        ("expired", "dalle_serve_requests_expired_total",
         "Requests that exceeded their deadline (queued or decoding)"),
        ("rejected", "dalle_serve_requests_rejected_total",
         "Typed submit-time rejections (queue full / invalid / closed)"),
        ("tokens_decoded", "dalle_serve_tokens_decoded_total",
         "Distinct delivered image tokens (replay-safe accounting)"),
        ("decode_steps", "dalle_serve_decode_steps_total",
         "Fused decode steps dispatched (chunks x K)"),
        ("harvests", "dalle_serve_harvests_total",
         "Emit-ring host reads (the only steady-state host waits)"),
        ("evicted", "dalle_serve_evicted_total",
         "Paged-pool evictions (victims replay token-exact)"),
        ("requeued", "dalle_serve_requeued_total",
         "Requeues from eviction/page-defer/failover"),
        ("prefix_hits", "dalle_serve_prefix_hits_total",
         "Warm prefix-cache admissions (zero prefill FLOPs)"),
        ("failovers", "dalle_serve_failovers_total",
         "Replica fence+reclaim+replay cycles"),
        ("reclaimed", "dalle_serve_reclaimed_total",
         "Requests reclaimed from fenced replicas for replay"),
        ("bringup_failures", "dalle_serve_bringup_failures_total",
         "Replica bring-up attempts that failed (circuit breaker)"),
        ("scale_outs", "dalle_serve_scale_outs_total",
         "Elastic scale-out actions"),
        ("scale_ins", "dalle_serve_scale_ins_total",
         "Elastic scale-in actions"),
        ("upgrades", "dalle_serve_upgrades_total",
         "Completed rolling weight upgrades"),
        ("migrations", "dalle_serve_migrations_total",
         "Live slot migrations completed (drain/scale-in/upgrade/roles)"),
        ("migrate_fallbacks", "dalle_serve_migrate_fallbacks_total",
         "Migrations that fell back to deterministic replay"),
        ("migrated_tokens_saved",
         "dalle_serve_migrated_tokens_saved_total",
         "Tokens live migration avoided re-decoding"),
        ("profiles_taken", "dalle_serve_profiles_taken_total",
         "Completed POST /admin/profile captures"),
        ("reaped", "dalle_serve_reaped_total",
         "Slots freed because the handle terminated externally "
         "(stream disconnect, group cancel, hedge loser)"),
        ("preview_frames", "dalle_serve_preview_frames_total",
         "Progressive preview frames decoded and delivered"),
        ("groups_completed", "dalle_serve_groups_completed_total",
         "Best-of-N sample groups assembled to a ranked result"),
        ("fanout_pages_saved", "dalle_serve_fanout_pages_saved_total",
         "KV pages COW prompt sharing saved across completed groups"),
    )
    _GAUGE_METRICS = (
        ("queue_depth", "dalle_serve_queue_depth",
         "Requests waiting in the admission queue(s)"),
        ("active_slots", "dalle_serve_active_slots",
         "Slots currently decoding"),
        ("num_slots", "dalle_serve_num_slots",
         "Total decode slots across live replicas"),
        ("alive_replicas", "dalle_serve_alive_replicas",
         "Replicas currently serving"),
        ("replicas", "dalle_serve_replicas",
         "Replicas in the set (retired excluded)"),
        ("pages_in_use", "dalle_serve_pages_in_use",
         "Physical KV pages mapped (shared pages counted once)"),
        ("pages_free", "dalle_serve_pages_free",
         "KV pages on the free list"),
        ("kv_hbm_bytes", "dalle_serve_kv_hbm_bytes",
         "Resident HBM bytes of the KV store"),
        ("postprocess_pending", "dalle_serve_postprocess_pending",
         "Completions queued for VAE/CLIP postprocess"),
        ("flight_events", "dalle_serve_flight_events",
         "Records currently retained in the flight ring(s)"),
        ("mean_occupancy", "dalle_serve_mean_occupancy",
         "Mean busy slots per dispatched decode step"),
        ("upgrading", "dalle_serve_upgrading",
         "1 while a rolling upgrade owns the fleet"),
        ("profile_active", "dalle_serve_profile_active",
         "1 while a torch.profiler capture is in flight"),
        ("streams_active", "dalle_serve_streams_active",
         "SSE/token streams currently open (a group counts once)"),
        ("groups_in_flight", "dalle_serve_groups_in_flight",
         "Best-of-N sample groups still decoding"),
    )

    def metrics_text(self) -> str:
        """The ``GET /metrics`` page: counters and gauges from
        ``stats()``, the serving identity, the latency histograms."""
        stats = self.stats()
        counters = [(name, help_text, [(None, stats[key])])
                    for key, name, help_text in self._COUNTER_METRICS
                    if stats.get(key) is not None]
        gauges = [(name, help_text, [(None, stats[key])])
                  for key, name, help_text in self._GAUGE_METRICS
                  if stats.get(key) is not None]
        version = stats.get("weights_version", self.weights_version)
        gauges.append(("dalle_serve_info",
                       "Serving identity (labels carry the facts)",
                       [({"weights_version": version,
                          "kv": str(stats.get("kv", "")),
                          "isolation": str(stats.get("isolation",
                                                     "thread"))}, 1)]))
        per = stats.get("per_replica") or ()
        if per:
            def rep_samples(key):
                return [({"replica": rec["replica"],
                          "weights_version": rec.get("weights_version",
                                                     ""),
                          "state": rec.get("state", "")}, rec.get(key))
                        for rec in per]
            counters.append((
                "dalle_serve_replica_tokens_decoded_total",
                "Per-replica tokens decoded (live engines only)",
                rep_samples("tokens_decoded")))
            counters.append((
                "dalle_serve_replica_completed_total",
                "Per-replica completed requests",
                rep_samples("completed")))
            gauges.append((
                "dalle_serve_replica_active_slots",
                "Per-replica busy slots", rep_samples("active_slots")))
            gauges.append((
                "dalle_serve_replica_queued",
                "Per-replica routed-but-not-decoding requests",
                rep_samples("queued")))
            gauges.append((
                "dalle_serve_replica_up",
                "1 while the replica is in the running state",
                [({"replica": rec["replica"],
                   "weights_version": rec.get("weights_version", "")},
                  1 if rec.get("state") == "running" else 0)
                 for rec in per]))
        return self.registry.render(counters=counters, gauges=gauges)

    # -- /debug/events and /admin/profile -----------------------------------

    def debug_events(self) -> dict:
        """What the flight recorders hold: the engine's, or the set's with
        every replica's and the fenced replicas' last dumps."""
        if self._is_set:
            return self.engine.debug_events()
        return {"server": self.engine.flight.dump(), "replicas": {},
                "fenced": {}}

    def profile(self, log_dir: Optional[str] = None, chunks: int = 8,
                replica: int = 0) -> dict:
        """Arm a torch.profiler capture over the engine's next ``chunks``
        decode chunks (``Engine.request_profile``), written under
        ``log_dir`` or the server's ``profile_dir``; neither is a typed
        refusal, and so is a capture already armed or running."""
        log_dir = log_dir or self.profile_dir
        if not log_dir:
            raise ProfileError(S.structured_event(
                "serve_profile_reject", reason="no_profile_dir",
                detail="pass 'dir' in the request body or start the "
                       "server with --profile_dir"))
        eng = self.engine
        if self._is_set and self.isolation == "process":
            raise ProfileError(S.structured_event(
                "serve_profile_reject", reason="process_isolation",
                detail="a child-process engine runs in another "
                       "interpreter; profile it from the worker "
                       "(isolation=thread supports in-server capture)"))
        if self._is_set:
            replica = int(replica)
            if not 0 <= replica < len(self.engine.replicas) \
                    or self.engine.replicas[replica].engine is None:
                raise ProfileError(S.structured_event(
                    "serve_profile_reject", reason="no_such_replica",
                    replica=replica))
            eng = self.engine.replicas[replica].engine
        with self._profile_arm_lock:
            if self._is_set:
                # torch.profiler is one capture a process: a sibling's
                # capture refuses this one
                for i, r in enumerate(self.engine.replicas):
                    e = r.engine
                    if e is not None and e is not eng \
                            and e.profile_active():
                        raise ProfileError(S.structured_event(
                            "serve_profile_reject",
                            reason="capture_active", replica=i))
            rec = dict(eng.request_profile(str(log_dir), chunks=chunks))
        rec["replica"] = int(replica) if self._is_set else 0
        return rec


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

_HTTP_STATUS = {S.OK: 200, S.REJECTED: 429, S.DEADLINE_EXCEEDED: 504,
                S.CANCELLED: 503, S.ERROR: 500}


def _result_body(result: S.Result) -> dict:
    body = {"status": result.status, "request_id": result.request_id,
            "reason": result.reason, "queued_s": result.queued_s,
            "decode_s": result.decode_s, "total_s": result.total_s}
    if result.weights_version:
        body["weights_version"] = result.weights_version
    if result.trace is not None:
        body["trace"] = result.trace
    if result.tokens is not None:
        body["tokens"] = [int(t) for t in result.tokens]
    if result.image is not None:
        # pixels are bulky as JSON: the shape here, the bytes on a
        # stream's final preview frame
        body["image_shape"] = list(result.image.shape)
    if result.clip_score is not None:
        body["clip_score"] = result.clip_score
    if result.samples is not None:
        # best-of-N: the ranked members, best first (the fields above
        # describe the best)
        body["samples"] = [_result_body(r) for r in result.samples]
    return body


def make_http_server(server: InferenceServer, host: str = "127.0.0.1",
                     port: int = 8000,
                     request_timeout_s: float = 600.0) -> ThreadingHTTPServer:
    """An HTTP facade over ``server``: one thread a connection; POST
    /generate holds its connection until the request completes (the
    engine's slots set the concurrency, not the HTTP layer)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):    # quiet: metrics are the record
            pass

        def _send(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_text(self, code: int, text: str, ctype: str) -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError(f"body must be a JSON object, "
                                 f"got {type(req).__name__}")
            return req

        def do_GET(self):
            if self.path == "/healthz":
                body = server.health()
                self._send(200 if body["ok"] else 503, body)
            elif self.path == "/stats":
                self._send(200, server.stats())
            elif self.path == "/metrics":
                self._send_text(
                    200, server.metrics_text(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/debug/events":
                self._send(200, server.debug_events())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _admin_scale(self):
            """401 without the admin token (Bearer or X-Admin-Token),
            400 without an 'op', 409 with the typed refusal."""
            if not auth.check_http(self.headers, server.admin_token):
                self._send(401, {"error": "bad admin token"})
                return
            try:
                req = self._json_body()
                op = str(req.pop("op"))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"need a JSON body with "
                                          f"'op': {e}"})
                return
            try:
                self._send(200, server.scale(op, **req))
            except (ScaleError, UpgradeAborted) as e:
                self._send(409, e.record)
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})

        def _admin_profile(self):
            """{"dir": ..., "chunks": K, "replica": i}, all optional; 401
            without the admin token, 409 while a capture is active."""
            if not auth.check_http(self.headers, server.admin_token):
                self._send(401, {"error": "bad admin token"})
                return
            try:
                req = self._json_body()
                rec = server.profile(
                    log_dir=req.get("dir"),
                    chunks=int(req.get("chunks", 8)),
                    replica=int(req.get("replica", 0)))
            except ProfileError as e:
                self._send(409, e.record)
                return
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            self._send(200, rec)

        def do_POST(self):
            if self.path == "/admin/scale":
                self._admin_scale()
                return
            if self.path == "/admin/profile":
                self._admin_profile()
                return
            if self.path != "/generate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                codes = req.get("codes")
                if codes is None and "caption" in req:
                    if server.encode is None:
                        raise ValueError("server has no vocab; send "
                                         "'codes', not 'caption'")
                    codes = server.encode(req["caption"])
                if not codes:
                    raise ValueError("need non-empty 'codes' or 'caption'")
                kwargs = {k: req[k] for k in
                          ("seed", "temperature", "filter_thres", "top_p",
                           "priority", "deadline_s", "cfg_scale",
                           "stream", "n_samples",
                           "image_seq_len_override")
                          if k in req}
                handle = server.submit(codes, **kwargs)
            except S.InvalidRequest as e:
                self._send(400, e.record)       # caller error, not load
                return
            except S.QueueClosed as e:
                self._send(503, e.record)       # shutting down
                return
            except S.ServeRejected as e:
                self._send(429, e.record)       # backpressure
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
            self._send(_HTTP_STATUS.get(result.status, 500),
                       _result_body(result))

        def _stream_sse(self, handle, sink) -> None:
            """Server-sent events with no Content-Length (the closed
            connection ends the stream); a heartbeat every 5 s of quiet;
            the terminal ``result`` frame carries the result body. A torn
            connection cancels the request (or the group): the engine
            then reaps its slots and pages, and the stream's undelivered
            events are dropped (the JAX server keeps them, and with them
            the stream in ``streams_active``)."""
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
                    {"event": "result", **_result_body(result)}))
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                handle.fulfill(S.Result(
                    status=S.CANCELLED,
                    request_id=handle.request.request_id,
                    reason="client disconnected mid-stream"))
                # nobody reads this stream any more: drop what it holds,
                # so the sweep retires it (streams_active)
                while sink.get(timeout=0) is not None:
                    pass
            except TimeoutError:
                pass    # the stream already delivered what it had

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd


def serve_http(server: InferenceServer, host: str = "127.0.0.1",
               port: int = 8000) -> None:
    """Blocking HTTP loop (``cli/serve.py``'s main); Ctrl-C shuts the
    pipeline down cleanly."""
    httpd = make_http_server(server, host, port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()
