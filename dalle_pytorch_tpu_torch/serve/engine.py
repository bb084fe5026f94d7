"""Slot-pool continuous-batching decode engine.

Port of ``dalle_pytorch_tpu/serve/engine.py``'s single engine: a fixed
batch of ``num_slots`` decode slots that requests join and leave by
masking, every per-slot decode state on the card, and a host loop that
enqueues ``chunk_steps`` (K) steps at a time and reads their emit ring
one chunk later.

* ``_dispatch_chunk`` enqueues K decode steps for every slot (the
  ``ops.decode`` loops) writing each step's token into a device-side
  ``(slots, K)`` emit ring, and starts an asynchronous copy of the ring
  to pinned host memory. ``_harvest_chunk`` waits for that copy one
  chunk LATER, so the host enqueues chunk N+1 while the card computes
  chunk N: one host wait per K tokens, overlapped.
* Admission pads prompts to a small fixed set of BUCKET lengths and
  prefills each bucket's group in one batched pass of ``num_slots`` rows
  (the JAX ``_prefill_fn``: one shape a bucket, so a row's numbers never
  depend on its neighbours), and samples the first token at position t0
  with key ``fold_in(PRNGKey(seed), t0)``.

KV layouts (``kv=``): ``'dense'`` holds ``num_slots x seq_len`` rows and
reads them through the gather (``decode_loop``); ``'paged'`` holds a
shared page pool with per-slot block tables (``serve/kv_pool.py``),
read in place by kernel K4 (``paged_attn='kernel'``) or through the
``paged_view`` gather (``'gather'``, the oracle). Under ``'paged'``:

* pages are mapped at admission for the prompt span and ahead of each
  chunk (``_map_ahead``) for every row it could write; when the pool
  runs dry the lowest-priority request is EVICTED back to the queue at
  its arrival position, and deterministic sampling replays its tokens
  on re-admission (``_evict_lowest_priority``);
* ``prefix_cache=True`` shares prompt pages across requests
  (``serve/prefix_cache.py``): a warm hit maps the entry's full prompt
  pages (refcount + 1), forks the boundary page copy-on-write and
  samples the first token from the cached last hidden row, with no
  prefill. Shared pages lie wholly below t0, where decode never writes.
  The index's LRU end is dropped before any live request is evicted;
* ``sparse_reads=True`` makes each sparse layer read only its visible
  pages through K4's visible walk.

For the HTTP tier (``serve/server.py``):

* short grids: ``Request.image_seq_len_override`` caps a slot's emit
  budget on the HOST (``_slot_need``); the card decodes the full grid
  and harvest stops delivering at the cap, at most one chunk of device
  steps late;
* streams: a handle's ``sink`` gets every harvested chunk's tokens at
  their absolute positions, and every ``preview_every`` chunks the
  image-token prefix goes to ``on_preview`` (the postprocess worker's
  ``submit_preview``);
* reaping: a slot whose handle was fulfilled from outside (a torn
  stream, a cancelled group) is freed at the next step, its pages
  returned (``reaped``);
* ``run(stop)`` is the serving thread's loop: a step that raises fails
  the in-slot requests with typed ``error`` results and serving goes on
  (``fail_active``; ``cancel_active`` at shutdown);
* observability: every span and structured event lands in ``flight``,
  the always-on ring behind ``/debug/events`` (``metrics`` is wrapped
  through ``obs.flight.wrap_metrics``), and ``request_profile`` arms a
  torch.profiler capture over the next K chunks, one at a time.

Per-request guidance (``Request.cfg_scale > 0``) admits a cond/uncond
slot PAIR, the uncond member a shadow slot on the all-PAD null caption;
``sample_per_slot``'s ``partner``/``cfg_scale``/``uncond`` mix the
logits and copy the drawn token (``_cfg_closures``). ``speculative=k``
runs draft-and-verify rounds (``decode_loop_spec*``): ``draft_layers``
layers draft k-1 tokens, the full stack verifies all k in one k-wide
pass, and the accepted tokens are the eager ones.

Equivalence contract (tests/test_torch_engine.py,
tests/test_torch_engine_features.py, tests/test_torch_speculative.py):
for the same weights, prompt, seed and knobs, a slot's tokens equal the
JAX engine's and ``generate_images``' at batch 1, for every K, layout,
guidance pair and speculation depth.

For the replica set (``serve/replica.py``, JAX ``:637-654``,
``:999-1118``, ``:2095-2357``):

* ``last_heartbeat`` is stamped at every step and every harvest (the
  harvest's wait is where a wedged card stalls the thread), and
  ``compiling`` marks the first calls (a bucket's first prefill, the
  first warm admission, the first dispatch), which may load the kernels
  and warm the libraries up, each followed by a heartbeat
  (``compile_pending`` asks ahead of the first step, for a process
  worker);
* ``fence()`` is the one-way switch the supervisor flips before it
  reclaims this engine's requests: a fenced engine fulfils, completes
  and requeues nothing, and every admission bail-out hands the handles
  it popped to ``on_fenced_orphan`` (they are in neither its queue nor
  its slots, so the reclaim sweep cannot see them; ``_admitting``
  publishes them while admission runs). It never stops the thread: a
  step already inside a CUDA call runs on, and its results are void;
* ``export_slot`` / ``import_slot`` move a decoding request between
  engines MID-STREAM: its pages (to the host in the payload, JAX's
  JSON-safe keys, and back onto the target's card), its device rows
  (position, current token, key, sampling knobs) and its emitted
  tokens; a guided pair moves whole. Sampling is deterministic in (key,
  position), so the continuation is the undisturbed run's. Every
  refusal is a typed ``MigrationError``, the source or target left as
  it was.

A serving mesh (``serve/mesh_engine.py``) is this engine with its
weights and KV store split over a list of devices. Its seams here:
``_place_model`` (the model as the engine computes with it),
``_place_kv`` (the KV store, made by a factory per device), ``_logits``
(the head's product, which a mesh runs shard by shard on the head's
split columns), the shard loops of the prompt scatter and the page
copies, and ``_mesh_stats`` (the /stats mesh block). The single
engine's versions hold everything on ``device`` and report
``devices_per_replica: 1``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.obs import flight as oflight
from dalle_pytorch_tpu_torch.ops import decode as decode_ops
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import prefix_cache as PC
from dalle_pytorch_tpu_torch.serve import scheduler as S

# the engine's lifetime counters (JAX ``COUNTERS``, less its compile
# counters: the port traces nothing)
COUNTERS = ("tokens_decoded", "decode_steps", "harvests", "occupancy_sum",
            "completed", "expired", "evicted", "prefix_hits", "cfg_pairs",
            "reaped")


class ProfileError(RuntimeError):
    """Typed refusal of a profiler capture (``request_profile``, ``POST
    /admin/profile``): one is already armed or running (torch.profiler
    traces one capture a process at a time). ``record`` is the
    structured event, the HTTP 409 body."""

    def __init__(self, record: dict):
        super().__init__(f"{record.get('reason', 'profile rejected')}")
        self.record = record


class MigrationError(RuntimeError):
    """Typed failure of a live slot migration (export or import): the
    replica set falls back to replay, never drops the request.
    ``reason`` is a short slug (``kv_dense``, ``not_found``, ``fenced``,
    ``weights_version``, ``page_size``, ``layout``, ``target_slots``,
    ``target_pages``, ``source_dead``, ``transfer``), carried by the
    ``serve_migrate_fallback`` event."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"migration failed ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


def _pack_array(t: torch.Tensor) -> dict:
    """One tensor as a JSON-safe dict (dtype name, shape, base64 of its
    bytes): the page snapshot's wire form, JAX's ``_pack_array``."""
    import base64
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:     # numpy has no bfloat16: its name
        name, raw = "bfloat16", t.view(torch.int16).numpy()
    else:
        raw = t.numpy()
        name = raw.dtype.str
    return {"dtype": name, "shape": list(t.shape),
            "data": base64.b64encode(raw.tobytes()).decode("ascii")}


def _unpack_array(d: dict) -> torch.Tensor:
    import base64
    raw = base64.b64decode(d["data"])
    shape = [int(x) for x in d["shape"]]
    if d["dtype"] == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, np.int16).reshape(
            shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(d["dtype"]))
                            .reshape(shape).copy())


class PoolTooSmall(ValueError):
    """The page pool cannot hold even one full sequence plus the trash
    page: eviction needs one request to be able to run alone, or it
    could evict forever."""


class _Slot:
    """Host bookkeeping of one slot. A guided pair is two slots: the cond
    slot carries ``pair`` (its shadow's index), the uncond SHADOW
    ``shadow_of`` (the cond index); the shadow holds the same handle but
    is never credited, completed or evicted on its own. ``need`` is the
    emit budget of a short-grid request (text fill + capped image span,
    None for the full grid); ``since_preview`` counts harvested chunks
    since the last preview."""

    __slots__ = ("handle", "t0", "emitted", "t_admit", "pair", "shadow_of",
                 "need", "since_preview")

    def __init__(self, handle: S.RequestHandle, t0: int, t_admit: float,
                 pair: Optional[int] = None,
                 shadow_of: Optional[int] = None,
                 need: Optional[int] = None):
        self.handle = handle
        self.t0 = t0
        self.emitted: List[int] = []
        self.t_admit = t_admit
        self.pair = pair
        self.shadow_of = shadow_of
        self.need = need
        self.since_preview = 0


class _Chunk:
    """One dispatched chunk: host copies of its emit ring and post-chunk
    active mask (valid once ``ready`` has completed), and which request
    owned each slot at dispatch time."""

    __slots__ = ("ring", "active", "ready", "owners")

    def __init__(self, ring, active, ready, owners):
        self.ring = ring
        self.active = active
        self.ready = ready
        self.owners = owners


class _Row:
    """One SLOT's admission plan: a plain request is one row, a guided
    one two (cond + uncond shadow, linked by ``pair_row``). ``mode`` is
    the prefix-cache disposition: ``cold`` prefills; ``warm`` maps an
    indexed entry's pages; ``warm_pending`` waits for an earlier cold
    row of the SAME admission that prefills the same prompt."""

    __slots__ = ("handle", "codes", "uncond", "pair_row", "t0", "bucket",
                 "total_pages", "mode", "shared_n", "key", "entry",
                 "grants", "slot", "group_idx")

    def __init__(self, handle: S.RequestHandle, codes, uncond: bool):
        self.handle = handle
        self.codes = codes
        self.uncond = uncond
        self.pair_row: Optional["_Row"] = None
        self.t0 = len(codes)
        self.bucket = 0
        self.total_pages = 0
        self.mode = "cold"
        self.shared_n = 0
        self.key: Optional[str] = None
        self.entry = None
        self.grants: List[int] = []
        self.slot = -1
        self.group_idx = -1


def _p50_ms(samples: List[float]) -> float:
    """Nearest-rank p50 of wall seconds, in ms (0.0 when empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return round(1e3 * s[min(len(s) // 2, len(s) - 1)], 4)


class Engine:
    """The continuous-batching loop: pulls from a ``RequestQueue`` and
    fulfils handles directly, or through ``complete(handle, result)``
    (the postprocess hand-off) for finished requests."""

    def __init__(self, model: D.DALLE, queue: S.RequestQueue, *,
                 num_slots: int = 8,
                 chunk_steps: int = 8,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 complete: Optional[Callable] = None,
                 metrics=None,
                 log_every: int = 50,
                 quantize_cache: bool = False,
                 kv: str = "dense",
                 page_size: int = 0,
                 num_pages: int = 0,
                 paged_attn: str = "gather",
                 sparse_reads: bool = False,
                 speculative: int = 0,
                 draft_layers: int = 0,
                 prefix_cache: bool = False,
                 prefix_entries: int = 256,
                 preview_every: int = 0,
                 model_version: str = "0",
                 weights_version: str = "0",
                 time_admissions: bool = False,
                 flight_events: int = 256,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        self.device = resolve_device(device)
        dtype = model.text_emb.weight.dtype
        self.model = model = self._place_model(model)
        self.cfg = cfg = model.cfg
        tcfg = cfg.transformer
        self.queue = queue
        self.num_slots = S_ = int(num_slots)
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.complete = complete
        # the flight recorder: every span and structured event this
        # engine emits lands in the ring, and in ``metrics`` when given
        self.flight = oflight.FlightRecorder(capacity=int(flight_events))
        self.metrics = oflight.wrap_metrics(self.flight, metrics)
        self.log_every = int(log_every)
        self._last_log = 0
        self.clock = clock
        self.quantize_cache = bool(quantize_cache)
        self.kv = str(kv)
        if self.kv not in ("dense", "paged"):
            raise ValueError(f"kv must be 'dense' or 'paged', got {kv!r}")
        self.paged_attn = str(paged_attn)
        if self.paged_attn not in ("gather", "kernel"):
            raise ValueError(f"paged_attn must be 'gather' or 'kernel', "
                             f"got {paged_attn!r}")
        if self.paged_attn == "kernel" and self.kv != "paged":
            raise ValueError("paged_attn='kernel' requires kv='paged' "
                             "(the kernel reads the page pool through "
                             "block tables; the dense slot cache has "
                             "neither)")
        self.sparse_reads = bool(sparse_reads)
        if self.sparse_reads:
            if self.kv != "paged":
                raise ValueError("sparse_reads requires kv='paged' — "
                                 "page visibility lives in the paged "
                                 "KV layout (block tables)")
            decode_ops.check_sparse_reads(tcfg)
        # speculative decode: each round drafts k-1 tokens with the first
        # draft_layers layers and verifies all k in one k-wide pass
        self.speculative = int(speculative)
        if self.speculative < 0:
            raise ValueError(
                f"speculative must be >= 0, got {speculative}")
        self.draft_layers = int(draft_layers) or max(tcfg.depth // 2, 1)
        self._draft_cfg = self._draft_model = None
        if self.speculative:
            if self.sparse_reads:
                raise ValueError(
                    "speculative does not compose with sparse_reads — "
                    "the k-wide verify reads the full cached prefix "
                    "per query (masked, not trimmed); run one or the "
                    "other")
            if not 1 <= self.draft_layers <= tcfg.depth:
                raise ValueError(
                    f"draft_layers must be in [1, depth={tcfg.depth}], "
                    f"got {self.draft_layers}")
            self._draft_cfg = D.draft_transformer_config(tcfg,
                                                         self.draft_layers)
            self._draft_model = D.draft_transformer_params(
                model.transformer, self.draft_layers)
        # the per-dispatch pos advance: chunk_steps rounds of up to k
        self._chunk_span = self.chunk_steps * max(self.speculative, 1)

        if prefill_buckets is None:
            buckets = S.prefill_buckets(cfg.text_seq_len)
        else:
            buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
            if not buckets or buckets[0] < 1 \
                    or buckets[-1] != cfg.text_seq_len:
                raise ValueError(
                    f"prefill_buckets must be >= 1 and end at "
                    f"text_seq_len ({cfg.text_seq_len}), got {buckets}")
        self.buckets = buckets
        self.total_len = cfg.seq_len
        self.prefix = None
        if self.kv == "paged":
            self.page_size = int(page_size) or min(16, self.total_len)
            if not 1 <= self.page_size <= self.total_len:
                raise ValueError(
                    f"page_size must be in [1, seq_len={self.total_len}], "
                    f"got {self.page_size}")
            if self.paged_attn == "kernel":
                KV.validate_page_size(self.page_size)
            # the block table width, and the pool's floor: ONE request
            # must always be able to run alone, or eviction could livelock
            self.slot_max_pages = KV.pages_for(self.total_len,
                                               self.page_size)
            full = S_ * self.slot_max_pages + 1           # + the trash page
            self.num_pages = int(num_pages) or full
            if self.num_pages - 1 < self.slot_max_pages:
                raise PoolTooSmall(
                    f"num_pages={self.num_pages} cannot hold even one full "
                    f"sequence ({self.slot_max_pages} pages of "
                    f"{self.page_size} rows + the reserved trash page): "
                    f"eviction needs one request to run alone")
            self.pool = self._place_kv(
                lambda c, dev: KV.init_page_pool(
                    c, self.num_pages, self.page_size, dtype=dtype,
                    quantized=self.quantize_cache, device=dev))
            self.alloc = KV.PageAllocator(self.num_pages)
            self._bt_host = np.zeros((S_, self.slot_max_pages), np.int32)
            self.block_tables = self._put(self._bt_host)
            self._bt_dirty = False
            self._slot_pages: List[List[int]] = [[] for _ in range(S_)]
            # safe host upper bound of each slot's device pos: mapping
            # ahead off it never lags the device
            self._pos_est = [0] * S_
            # head-of-line page reservation: while set, admission pops
            # nothing until that many pages are free, so freed pages
            # accumulate for the oldest deferred request
            self._hol_rid: Optional[int] = None
            self._hol_need = 0
            self._min_admit_pages = KV.pages_for(min(self.buckets),
                                                 self.page_size)
            if prefix_cache:
                self.prefix = PC.PrefixIndex(self.alloc,
                                             max_entries=prefix_entries)
                self._layer_sig = PC.layer_signature(tcfg)
            self.kv_read_bytes = {sr: PA.modeled_kv_read_bytes_per_token(
                depth=tcfg.depth, heads=tcfg.heads, dim_head=tcfg.dim_head,
                total_len=self.total_len, page_size=self.page_size,
                prompt_len=min(self.buckets),
                itemsize=(torch.int8 if self.quantize_cache
                          else dtype).itemsize,
                impl=self.paged_attn, quantized=self.quantize_cache,
                sparse_reads=sr,
                sparse_pattern=tcfg.sparse_pattern if sr else None,
                sparse_block=tcfg.sparse_block, causal=tcfg.causal)
                for sr in {False, self.sparse_reads}}
        else:
            if prefix_cache:
                raise ValueError(
                    "prefix_cache requires kv='paged' — physical prompt "
                    "sharing lives in the page pool's block-table "
                    "indirection; the dense slot cache has neither "
                    "pages nor refcounts")
            self.pool = self._place_kv(
                lambda c, dev: decode_ops.init_cache(
                    c, S_, self.total_len, dtype=dtype,
                    quantized=self.quantize_cache, device=dev))
        self.evicted = 0
        self.model_version = str(model_version)
        self.weights_version = str(weights_version)
        self.time_admissions = bool(time_admissions)
        self.prefill_times: List[float] = []
        self.warm_admit_times: List[float] = []
        self._prefilled: set = set()       # buckets prefilled at least once
        # progressive previews: every preview_every harvested chunks of a
        # streaming slot, its image-token prefix goes to on_preview (set
        # by the server after construction, like ``complete``)
        self.preview_every = int(preview_every)
        if self.preview_every < 0:
            raise ValueError(f"preview_every must be >= 0, got "
                             f"{preview_every}")
        self.on_preview: Optional[Callable] = None
        self.previews_requested = 0
        # a profiler capture: armed by request_profile (any thread) as a
        # request the engine thread takes at its next dispatch, stopped
        # after a countdown of harvests, so it covers the chunks' device
        # work and not only their launches
        self._profile_req = None
        self._profiler = None
        self._profile_left = 0
        self._profile_lock = threading.Lock()
        self.profiles_taken = 0

        dev = self.device
        self.key_mask = torch.ones((S_, self.total_len), dtype=torch.bool,
                                   device=dev)
        self.cur_tok = torch.zeros((S_,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((S_,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((S_,), dtype=torch.bool, device=dev)
        self.rng = torch.zeros((S_, 2), dtype=torch.int64, device=dev)
        self.temp = torch.ones((S_,), dtype=torch.float32, device=dev)
        self.topk_k = torch.ones((S_,), dtype=torch.int32, device=dev)
        self.top_p = torch.zeros((S_,), dtype=torch.float32, device=dev)
        # guidance-pair state, host-authoritative like the block tables:
        # partner (self when unpaired), scale (0 = off) and the shadow
        # flag, pushed before the next chunk when they change
        self._cfg_partner_host = np.arange(S_, dtype=np.int32)
        self._cfg_scale_host = np.zeros((S_,), np.float32)
        self._cfg_uncond_host = np.zeros((S_,), bool)
        # pushed here, not through _sync_cfg, which runs under _lock
        self.cfg_partner = self._put(self._cfg_partner_host).long()
        self.cfg_scale = self._put(self._cfg_scale_host)
        self.cfg_uncond = self._put(self._cfg_uncond_host)
        self._cfg_dirty = False
        self.slots: List[Optional[_Slot]] = [None] * S_
        self._pending: deque = deque()
        self._lock = threading.Lock()          # step_once is not reentrant

        self.decode_steps = 0        # fused steps dispatched (chunks * K)
        self.harvests = 0            # emit-ring host reads, one per chunk
        self.prefill_runs = 0        # bucket-group prefills dispatched
        self.warm_admits = 0         # requests admitted with no prefill
        self.prefix_hits = 0
        self.cfg_pairs = 0           # guided pairs admitted
        self.tokens_decoded = 0
        self.occupancy_sum = 0
        self.completed = 0
        self.expired = 0
        self.reaped = 0              # slots freed after an outside cancel
        self._t_start: Optional[float] = None
        # speculative accounting over DELIVERED tokens: rounds that
        # emitted, the tokens they emitted, and the positions they could
        # have emitted (k, clamped at the sequence end)
        self.spec_rounds = 0
        self.spec_delivered = 0
        self.spec_proposed = 0

        # the replica supervisor's surface (module docstring)
        self.fenced = False
        self.last_heartbeat = self.clock()
        self.compiling = False
        self.on_fenced_orphan: Optional[Callable] = None
        self._admitting: List[S.RequestHandle] = []

    # -- placement (the serving mesh overrides these) -------------------------

    def _place_model(self, model: D.DALLE) -> D.DALLE:
        """The model the engine computes with: ``model`` itself, which
        must lie on the engine's device."""
        param = model.text_emb.weight
        if param.device.type != self.device.type or (
                self.device.index is not None
                and param.device.index != self.device.index):
            raise ValueError(f"model lies on {param.device}, engine on "
                             f"{self.device}")
        return model

    def _place_kv(self, make: Callable) -> decode_ops.Pool:
        """The KV store: ``make(transformer config, device)`` on the
        engine's device."""
        return make(self.cfg.transformer, self.device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head's logits (rows, total_tokens) of hidden rows h, on
        the engine's device: every sampler's input."""
        return D.to_logits(self.model, h)

    def _mesh_stats(self) -> dict:
        """The /stats mesh block: one device holds the whole store."""
        return {"devices_per_replica": 1,
                "mesh_shape": None,
                "kv_hbm_bytes_per_shard": self.kv_hbm_bytes()}

    # -- host <-> card -------------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """One small host array onto the card, without waiting for the
        work already queued there (pinned staging, asynchronous copy)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone().to(self.device)

    def _fetch(self, *tensors: torch.Tensor):
        """Start copying device tensors to the host; returns the host
        tensors and an event that completes with the copies (None on
        the CPU, where the copies are already done)."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        ready = torch.cuda.Event()
        ready.record()
        return out, ready

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the device programs --------------------------------------------------

    def _cfg_closures(self):
        """The embed/sample closures every decode loop shares, with the
        guided pairs folded in: a cond slot samples image positions from
        the mixed logits, its shadow copies the drawn token, and the
        shadow's TEXT positions embed PAD (``generate_images``' guided
        loop). With every scale at 0 each of these ops is an identity."""
        model, cfg = self.model, self.cfg
        partner, scale, uncond = (self.cfg_partner, self.cfg_scale,
                                  self.cfg_uncond)

        def embed_fn(tok, p):
            tok = torch.where(uncond & (p < cfg.text_seq_len), 0, tok)
            return D.decode_token_embed(model, tok, p)

        def sample_fn(h, pred_pos):
            return D.sample_per_slot(self._logits(h), pred_pos,
                                     self.rng, self.temp, self.topk_k,
                                     self.top_p, cfg, partner=partner,
                                     cfg_scale=scale, uncond=uncond)

        return embed_fn, sample_fn

    @torch.no_grad()
    def _decode_chunk(self):
        embed_fn, sample_fn = self._cfg_closures()
        kw = dict(cfg=self.cfg.transformer, key_mask=self.key_mask,
                  steps=self.chunk_steps, embed_fn=embed_fn,
                  sample_fn=sample_fn)
        model = self.model.transformer
        state = (self.cur_tok, self.pos, self.active, self.pool)
        if self.kv == "paged":
            if self.speculative:
                return decode_ops.decode_loop_spec_paged(
                    model, self._draft_model, *state, self.block_tables,
                    draft_cfg=self._draft_cfg, k=self.speculative,
                    attn_impl=self.paged_attn, **kw)
            return decode_ops.decode_loop_paged(
                model, *state, self.block_tables, attn_impl=self.paged_attn,
                sparse_reads=self.sparse_reads, **kw)
        if self.speculative:
            return decode_ops.decode_loop_spec(
                model, self._draft_model, *state, draft_cfg=self._draft_cfg,
                k=self.speculative, **kw)
        return decode_ops.decode_loop(model, *state, **kw)

    def _admit_arrays(self, rows: List[_Row]) -> dict:
        """The per-row knobs of one admission group, padded to
        ``num_slots`` rows (the pad rows' results are never used); an
        uncond shadow carries its cond request's knobs (its own draw is
        overwritten by the partner copy)."""
        G = self.num_slots
        a = dict(lens=np.ones((G,), np.int32),
                 seeds=np.zeros((G,), np.int64),
                 temps=np.ones((G,), np.float32),
                 topk=np.ones((G,), np.int32),
                 top_p=np.zeros((G,), np.float32),
                 partner=np.arange(G, dtype=np.int32),
                 cfgs=np.zeros((G,), np.float32),
                 uncond=np.zeros((G,), bool))
        for j, p in enumerate(rows):
            req = p.handle.request
            a["lens"][j] = p.t0
            a["seeds"][j] = req.seed
            a["temps"][j] = req.sampling.temperature
            a["topk"][j] = max(int((1 - req.sampling.filter_thres)
                                   * self.cfg.total_tokens), 1)
            a["top_p"][j] = req.sampling.top_p
            a["cfgs"][j] = req.cfg_scale
            a["uncond"][j] = p.uncond
        for j, p in enumerate(rows):
            # a pair's rows always share the group
            if p.pair_row is not None and p.pair_row in rows:
                a["partner"][j] = rows.index(p.pair_row)
        return a

    def _first_tokens(self, h_last: torch.Tensor, rows: List[_Row],
                      a: dict) -> None:
        """Each row's first token, sampled at its TRUE prompt length
        from its last hidden row (``num_slots`` rows, the pads included),
        and the merge of the new slots' decode state."""
        put = self._put
        n = len(rows)
        lens = put(a["lens"])
        keys = prng.prng_key(put(a["seeds"]))
        temps, topk, top_p = put(a["temps"]), put(a["topk"]), put(a["top_p"])
        first = D.sample_per_slot(self._logits(h_last), lens,
                                  keys, temps, topk, top_p, self.cfg,
                                  partner=put(a["partner"]),
                                  cfg_scale=put(a["cfgs"]),
                                  uncond=put(a["uncond"]))
        slots = put(np.asarray([p.slot for p in rows], np.int64))
        self.cur_tok[slots] = first[:n].to(torch.int32)
        self.pos[slots] = lens[:n]
        self.active[slots] = True
        self.rng[slots] = keys[:n]
        self.temp[slots] = temps[:n]
        self.topk_k[slots] = topk[:n]
        self.top_p[slots] = top_p[:n]

    @torch.no_grad()
    def _prefill_group(self, bucket: int, rows: List[_Row]) -> torch.Tensor:
        """Batched prefill of one bucket's group (padded to ``num_slots``
        rows), the scatter of its prompt rows [0, bucket) into the slots'
        pages or dense rows, the first tokens and the state merge.
        Returns h_last (num_slots, dim). Rows past a prompt's true length
        t0 are garbage that the decode step for that position overwrites
        before any later step reads it."""
        G, n = self.num_slots, len(rows)
        text = np.zeros((G, bucket), np.int64)
        for j, p in enumerate(rows):
            text[j, :p.t0] = p.codes
        a = self._admit_arrays(rows)
        model, tcfg = self.model, self.cfg.transformer
        h, kv = decode_ops.prefill(
            model.transformer, D.embed_prompt(model, self._put(text)),
            cfg=tcfg, quantize_cache=self.quantize_cache)
        if self.kv == "paged":
            page_rows = np.stack([self._bt_host[p.slot,
                                                np.arange(bucket)
                                                // self.page_size]
                                  for p in rows])
            page_rows = self._put(page_rows).long()
            off = (torch.arange(bucket, device=self.device)
                   % self.page_size)[None, :]
            for part, hs, dev in decode_ops.pool_shards(self.pool):
                pr, of = page_rows.to(dev), off.to(dev)
                for name, buf in part.items():
                    # advanced indices at dims 1 and 3 are apart, so the
                    # value is (n, bucket, depth, heads[, dh])
                    buf[:, pr, :, of] = kv[name][:, :n, hs].movedim(1, 0) \
                        .movedim(3, 1).to(dev, buf.dtype)
        else:
            slots = self._put(np.asarray([p.slot for p in rows], np.int64))
            for part, hs, dev in decode_ops.pool_shards(self.pool):
                sl = slots.to(dev)
                for name, buf in part.items():
                    buf[:, sl, :, :bucket] = kv[name][:, :n, hs].to(
                        dev, buf.dtype)
        g = torch.arange(G, device=self.device)
        h_last = h[g, self._put(a["lens"]).long() - 1]
        self._first_tokens(h_last, rows, a)
        self.prefill_runs += 1
        return h_last

    # -- request lifecycle ---------------------------------------------------

    def _span(self, handle: S.RequestHandle, name: str, now: float,
              **meta) -> None:
        """Stamp one trace span and land its record in the flight ring."""
        tr = handle.trace
        if tr is not None:
            self.flight.record(tr.span(name, now, **meta))

    def _finish(self, handle: S.RequestHandle, result: S.Result) -> None:
        if self.fenced:
            return          # the request belongs to whoever fenced us
        result.weights_version = self.weights_version
        if result.status == S.OK and self.complete is not None:
            self.complete(handle, result)
        else:
            handle.fulfill(result)

    def _terminal(self, handle: S.RequestHandle, now: float, status: str,
                  reason: str) -> None:
        req = handle.request
        self._finish(handle, S.Result(
            status=status, request_id=req.request_id, reason=reason,
            queued_s=round(now - req.submit_t, 6),
            total_s=round(now - req.submit_t, 6)))

    def _expire(self, handle: S.RequestHandle, now: float,
                where: str) -> None:
        req = handle.request
        self.expired += 1
        self.metrics.event(**S.structured_event(
            "serve_deadline", request_id=req.request_id, where=where,
            deadline_s=req.deadline_s,
            waited_s=round(now - req.submit_t, 4)))
        self._terminal(handle, now, S.DEADLINE_EXCEEDED,
                       f"deadline_s={req.deadline_s:g} exceeded ({where})")

    def _error(self, handle: S.RequestHandle, now: float,
               reason: str) -> None:
        self.metrics.event(**S.structured_event(
            "serve_error", request_id=handle.request.request_id,
            error=reason))
        self._terminal(handle, now, S.ERROR, reason)

    def _cfg_wire(self, i: int, j: int, scale: float) -> None:
        """Pair cond slot i with uncond shadow j (host side)."""
        self._cfg_partner_host[[i, j]] = (j, i)
        self._cfg_scale_host[[i, j]] = np.float32(scale)
        self._cfg_uncond_host[[i, j]] = (False, True)
        self._cfg_dirty = True

    def _cfg_reset(self, i: int) -> None:
        """Back to unpaired: partner = self, scale 0."""
        self._cfg_partner_host[i] = i
        self._cfg_scale_host[i] = 0.0
        self._cfg_uncond_host[i] = False
        self._cfg_dirty = True

    def _sync_cfg(self) -> None:
        if self._cfg_dirty:
            self.cfg_partner = self._put(self._cfg_partner_host).long()
            self.cfg_scale = self._put(self._cfg_scale_host)
            self.cfg_uncond = self._put(self._cfg_uncond_host)
            self._cfg_dirty = False

    def _plan_rows(self, take: List[S.RequestHandle]
                   ) -> Dict[int, List[_Row]]:
        """One row for a plain request, a cond/uncond pair for a guided
        one (the uncond row runs the all-PAD caption of the SAME length,
        so the pair lands in one bucket)."""
        per_handle: Dict[int, List[_Row]] = {}
        for h in take:
            r = h.request
            rc = _Row(h, tuple(int(c) for c in r.codes), uncond=False)
            hrows = [rc]
            if r.cfg_scale > 0:
                ru = _Row(h, (0,) * len(r.codes), uncond=True)
                rc.pair_row, ru.pair_row = ru, rc
                hrows.append(ru)
            for p in hrows:
                p.bucket = S.bucket_for(p.t0, self.buckets)
            per_handle[r.request_id] = hrows
        return per_handle

    def _classify_row(self, p: _Row, pending: set) -> None:
        """Prefix-cache disposition of one row (paged). The lookup checks
        the stored tokens, so a hash collision reads as a miss."""
        p.total_pages = KV.pages_for(p.bucket, self.page_size)
        if self.prefix is None:
            return
        p.key = PC.prefix_key(p.codes, model_version=self.model_version,
                              layer_sig=self._layer_sig,
                              quantized=self.quantize_cache)
        p.entry = self.prefix.lookup(p.key, p.codes)
        if p.entry is not None:
            p.mode = "warm"
            p.shared_n = len(p.entry.full_pages)
        elif p.key in pending:
            # an earlier cold row of THIS admission prefills the same
            # prompt: admit warm after its insert lands
            p.mode = "warm_pending"
            p.shared_n = p.t0 // self.page_size

    # -- fencing --------------------------------------------------------------

    def fence(self) -> None:
        """One-way: from now on this engine fulfils, completes and
        requeues nothing, and ``step_once`` returns on entry. The
        supervisor sets it BEFORE it reclaims the requests."""
        self.fenced = True

    def inflight_handles(self) -> List[S.RequestHandle]:
        """Every request this engine holds: the in-slot handles and the
        ones mid-admission (``_admitting``). Host bookkeeping only, so it
        can be read while the engine thread is stuck in a step."""
        out: List[S.RequestHandle] = []
        seen: set = set()
        for h in [s.handle for s in list(self.slots) if s is not None] \
                + list(self._admitting):
            rid = h.request.request_id
            if rid not in seen:
                seen.add(rid)
                out.append(h)
        return out

    def progress_snapshot(self) -> Dict[int, int]:
        """``{request_id: tokens emitted}`` of every in-slot request."""
        return {s.handle.request.request_id: len(s.emitted)
                for s in list(self.slots)
                if s is not None and s.shadow_of is None}

    def _orphan_handles(self, handles) -> None:
        """Hand handles popped by a step the fence landed in back to the
        supervisor (``on_fenced_orphan``)."""
        for h in handles:
            if not h.done() and self.on_fenced_orphan is not None:
                self.on_fenced_orphan(h)

    def _requeue_or_orphan(self, handle: S.RequestHandle) -> None:
        """Back in line: this engine's queue, or once fenced the
        supervisor's hook (by then the private queue is drained, and its
        requeue would cancel the handle under the replay)."""
        if self.fenced:
            self._orphan_handles([handle])
            return
        self.queue.requeue(handle)

    @staticmethod
    def _unique_handles(group: List[_Row]) -> List[S.RequestHandle]:
        out, seen = [], set()
        for p in group:
            rid = p.handle.request.request_id
            if rid not in seen:
                seen.add(rid)
                out.append(p.handle)
        return out

    def _admit(self, handles: List[S.RequestHandle], now: float) -> None:
        if self.fenced:
            # fenced after the pop: nobody else can see these handles
            self._orphan_handles(handles)
            return
        free = [i for i, s in enumerate(self.slots) if s is None]
        valid = []
        for h in handles:
            if h.done():
                continue
            n = len(h.request.codes)
            if not 1 <= n <= self.cfg.text_seq_len:
                self._error(h, now, f"invalid prompt length {n} "
                            f"(need 1..{self.cfg.text_seq_len})")
                continue
            if h.request.cfg_scale > 0 and self.num_slots < 2:
                self._error(h, now, "cfg_scale needs a cond/uncond slot "
                            "pair: num_slots must be >= 2")
                continue
            L = int(h.request.image_seq_len_override)
            if L and not 1 <= L <= self.cfg.image_seq_len:
                self._error(h, now, f"image_seq_len_override {L} out of "
                            f"range (need 1..{self.cfg.image_seq_len})")
                continue
            valid.append(h)
        # slot budget in arrival order: a guided request takes TWO slots,
        # and the overflow goes back in line at its position
        budget = len(free)
        take: List[S.RequestHandle] = []
        for k, h in enumerate(valid):
            width = 2 if h.request.cfg_scale > 0 else 1
            if width > budget:
                for hh in valid[k:]:
                    self._requeue_or_orphan(hh)
                break
            budget -= width
            take.append(h)
        per_handle = self._plan_rows(take)

        rows: List[_Row] = []
        if self.kv == "paged" and take:
            # gated on FREE PAGES for the prompt spans, in arrival order:
            # the first request that does not fit goes back in line with
            # everything behind it, and its need is reserved (_hol_need)
            # so later, smaller requests cannot starve it
            pending: set = set()
            for k, h in enumerate(take):
                rid = h.request.request_id
                hrows = per_handle[rid]
                for p in hrows:
                    self._classify_row(p, pending)
                if len(hrows) == 2:
                    # a MIXED pair admits whole-cold: the pair's first
                    # token mixes both streams in one program
                    modes = {p.mode for p in hrows}
                    if "cold" in modes and modes != {"cold"}:
                        for p in hrows:
                            p.mode, p.shared_n, p.entry = "cold", 0, None
                for p in hrows:
                    if p.mode == "cold" and p.key is not None:
                        pending.add(p.key)
                need = sum(p.total_pages - p.shared_n for p in hrows)
                if self.alloc.free < need and self.prefix is not None:
                    # cached prefixes are a perf lever, live requests are
                    # work: drop LRU entries before deferring
                    self.prefix.shrink(need)
                if self.alloc.free < need:
                    for hh in take[k:]:
                        self._requeue_or_orphan(hh)
                    self._hol_rid = rid
                    self._hol_need = need
                    break
                for p in hrows:
                    p.grants = self.alloc.alloc(p.total_pages - p.shared_n)
                rows.extend(hrows)
                if rid == self._hol_rid:
                    self._hol_rid = None
                    self._hol_need = 0
        else:
            for h in take:
                rows.extend(per_handle[h.request.request_id])

        free = self._admit_cold(rows, free, now)
        self._admit_warm(rows, free, now)

    def _slot_need(self, req: S.Request, t0: int) -> Optional[int]:
        """A short-grid request's emit budget (text fill + the capped
        image span), None for the full grid. Harvest stops delivering at
        it and completes the slot, so one program serves every cap, at
        the cost of at most one chunk of device steps past it."""
        L = int(req.image_seq_len_override)
        if not L:
            return None
        return (self.cfg.text_seq_len - t0) + L

    def _admit_cold(self, rows: List[_Row], free: List[int],
                    now: float) -> List[int]:
        """Bucket-grouped prefill admission of the plan's cold rows.
        Returns the free slots left for the warm rows."""
        groups: Dict[int, List[_Row]] = {}
        for p in rows:
            if p.mode == "cold":
                groups.setdefault(p.bucket, []).append(p)
        for bucket, group in groups.items():
            if self.fenced:
                # fenced between groups: the rest is step locals
                self._orphan_handles(self._unique_handles(group))
                continue
            idx, free = free[:len(group)], free[len(group):]
            for j, p in enumerate(group):
                p.slot, p.group_idx = idx[j], j
                if self.kv == "paged":
                    self._bt_host[p.slot, :] = 0
                    self._bt_host[p.slot, :len(p.grants)] = p.grants
            timed = self.time_admissions and bucket in self._prefilled
            t_pre = self.clock()
            with self._first_call(bucket not in self._prefilled):
                h_last = self._prefill_group(bucket, group)
            self._prefilled.add(bucket)
            if timed:
                self._sync()
                self.prefill_times.append(self.clock() - t_pre)
            if self.fenced:
                # fenced during the prefill: not slotted, so orphaned
                self._orphan_handles(self._unique_handles(group))
                continue
            t_slotted = self.clock()
            for p in group:
                self.slots[p.slot] = _Slot(
                    p.handle, p.t0, now,
                    need=self._slot_need(p.handle.request, p.t0))
                if self.kv == "paged":
                    self._slot_pages[p.slot] = list(p.grants)
                    self._pos_est[p.slot] = p.t0
                    self._bt_dirty = True
                if not p.uncond:    # one span a request, not a slot
                    self._span(p.handle, "prefill_admit", t_slotted,
                               bucket=bucket, mode="cold", slot=p.slot)
            self._wire_pairs(group)
            if self.prefix is not None:
                for p in group:
                    self._prefix_insert(p, h_last)
        return free

    def _wire_pairs(self, group: List[_Row]) -> None:
        """Link freshly slotted cond/uncond pairs."""
        for p in group:
            if p.pair_row is None or p.uncond:
                continue
            i, j = p.slot, p.pair_row.slot
            self.slots[i].pair = j
            self.slots[j].shadow_of = i
            self._cfg_wire(i, j, p.handle.request.cfg_scale)
            self.cfg_pairs += 1

    def _prefix_insert(self, p: _Row, h_last: torch.Tensor) -> None:
        """Index a cold row's freshly prefilled prompt: its full pages
        (retained by the index), a copy of the partial boundary page and
        the last hidden row — taken NOW, before any decode chunk writes
        rows >= t0 into the boundary page."""
        if p.key is None or p.key in self.prefix:
            return
        i = p.slot
        s_full = p.t0 // self.page_size
        snap = None
        if p.t0 % self.page_size:
            snap = KV.snapshot_page(self.pool, self._slot_pages[i][s_full])
        self.prefix.insert(PC.PrefixEntry(
            p.key, p.codes, p.t0, self._slot_pages[i][:s_full], snap,
            h_last[p.group_idx].clone()))

    @torch.no_grad()
    def _admit_warm(self, rows: List[_Row], free: List[int],
                    now: float) -> None:
        """Admission of the plan's warm rows with no prefill: map the
        shared pages (refcount + 1), fork the boundary page copy-on-write,
        and sample the first tokens from the cached last hidden rows."""
        warm: List[_Row] = []
        for p in rows:
            if p.mode not in ("warm", "warm_pending"):
                continue
            if p.pair_row is not None and p.uncond:
                continue            # handled with its cond row below
            hrows = [p] + ([p.pair_row] if p.pair_row is not None else [])
            resolved = True
            for q in hrows:
                if q.entry is None:
                    q.entry = self.prefix.lookup(q.key, q.codes)
                if q.entry is None \
                        or len(q.entry.full_pages) != q.shared_n:
                    resolved = False
            if not resolved or self.fenced:
                # the cold sibling's insert never landed (or we are
                # fenced): give the pages back and retry next pop
                for q in hrows:
                    if q.grants:
                        self.alloc.release(q.grants)
                        q.grants = []
                self._requeue_or_orphan(p.handle)
                continue
            warm.extend(hrows)
        if not warm:
            return
        h_rows = []
        for j, p in enumerate(warm):
            i = free[j]
            p.slot, p.group_idx = i, j
            entry = p.entry
            # read-only sharing: shared pages lie wholly below t0, and
            # decode only appends at positions >= t0
            assert p.t0 >= p.shared_n * self.page_size, \
                "shared prefix pages must end at/below the prompt length"
            self.alloc.retain(entry.full_pages)
            pages = list(entry.full_pages) + list(p.grants)
            self._bt_host[i, :] = 0
            self._bt_host[i, :len(pages)] = pages
            if entry.boundary_snap is not None:
                # COW fork: the private boundary page starts as a copy of
                # the cached one, then diverges under its own writes
                KV.restore_page(self.pool, p.grants[0],
                                entry.boundary_snap)
            h_rows.append(entry.h_last)
        h_rows += [h_rows[0]] * (self.num_slots - len(h_rows))
        timed = self.time_admissions and self.warm_admits > 0
        t_warm = self.clock()
        with self._first_call(self.warm_admits == 0):
            self._first_tokens(torch.stack(h_rows), warm,
                               self._admit_arrays(warm))
        if timed:
            self._sync()
            self.warm_admit_times.append(self.clock() - t_warm)
        if self.fenced:
            self._orphan_handles(self._unique_handles(warm))
            return
        t_slotted = self.clock()
        for p in warm:
            i = p.slot
            self.slots[i] = _Slot(p.handle, p.t0, now,
                                  need=self._slot_need(p.handle.request,
                                                       p.t0))
            self._slot_pages[i] = list(p.entry.full_pages) + list(p.grants)
            self._pos_est[i] = p.t0
            self._bt_dirty = True
            self.prefix_hits += 1
            self.warm_admits += 1
            if not p.uncond:
                self._span(p.handle, "prefill_admit", t_slotted,
                           mode="warm", slot=i, pages_shared=p.shared_n)
            self.metrics.event(**S.structured_event(
                "serve_prefix_hit", request_id=p.handle.request.request_id,
                uncond=p.uncond, pages_shared=p.shared_n,
                pages_private=len(p.grants)))
        self._wire_pairs(warm)

    # -- page-pool lifecycle (kv='paged') ------------------------------------

    def _release_slot_pages(self, i: int) -> None:
        """Drop slot i's page REFERENCES and zero its table row: a page
        a sibling slot or the prefix index still maps stays resident. The
        stale device row needs no urgent push: a dead slot writes the
        trash page, and reads of re-assigned pages are masked."""
        if self._slot_pages[i]:
            self.alloc.release(self._slot_pages[i])
            self._slot_pages[i] = []
        self._bt_host[i, :] = 0
        self._pos_est[i] = 0
        self._bt_dirty = True

    def _free_slot(self, i: int) -> List[int]:
        """The one slot teardown (completion, expiry, eviction):
        vacate the slot, return its page references, and free a guided
        pair's shadow with it. Returns the freed slot indices."""
        slot = self.slots[i]
        freed = [i]
        self.slots[i] = None
        if self.kv == "paged":
            self._release_slot_pages(i)
        self._cfg_reset(i)
        j = slot.pair if slot is not None else None
        if j is not None and self.slots[j] is not None \
                and self.slots[j].shadow_of == i:
            self.slots[j] = None
            if self.kv == "paged":
                self._release_slot_pages(j)
            self._cfg_reset(j)
            freed.append(j)
        return freed

    def _kill(self, slots: List[int]) -> None:
        keep = np.ones((self.num_slots,), bool)
        keep[slots] = False
        self.active = self.active & self._put(keep)

    def _evict_lowest_priority(self, now: float) -> bool:
        """Evict the LOWEST-priority request (highest priority value;
        ties to the latest admission) back to the queue at its arrival
        position: its page references dropped, its slots killed, its
        harvested tokens un-credited (re-admission replays them, to the
        same tokens). A guided pair goes whole. False when no slot is
        live."""
        if self.fenced:
            return False    # the reclaim sweep owns every in-slot handle
        cand = [(s.handle.request.priority, s.t_admit, i)
                for i, s in enumerate(self.slots)
                if s is not None and s.shadow_of is None]
        if not cand:
            return False
        _, _, i = max(cand)
        slot = self.slots[i]
        free_before = self.alloc.free
        self._kill(self._free_slot(i))
        freed = self.alloc.free - free_before
        self.evicted += 1
        self.tokens_decoded -= len(slot.emitted)
        self.occupancy_sum -= len(slot.emitted)
        # a visible timeline marker: the re-queue wait and the replay
        # follow it. Stamped at the clock, not at the step's start: a
        # request evicted in the step that admitted it would otherwise
        # step the trace back over its prefill_admit span
        self._span(slot.handle, "evict", self.clock(), pages_freed=freed)
        self._requeue_or_orphan(slot.handle)
        req = slot.handle.request
        self.metrics.event(**S.structured_event(
            "serve_evict", request_id=req.request_id,
            priority=req.priority, pages_freed=freed,
            pages_free=self.alloc.free,
            waited_s=round(now - req.submit_t, 4)))
        return True

    def _map_ahead(self, now: float) -> None:
        """Before every chunk: map every page the chunk could write
        ([pos, pos + chunk_steps * k)) off the host's safe pos bound.
        When the free list runs dry, the prefix index's LRU end goes
        first, then the lowest-priority request is evicted until the rest
        fits (one full sequence always fits alone, so this ends — in the
        limit the growing slot evicts itself)."""
        for i in range(self.num_slots):
            while self.slots[i] is not None:
                target = min(self._pos_est[i] + self._chunk_span,
                             self.total_len)
                short = KV.pages_for(target, self.page_size) \
                    - len(self._slot_pages[i])
                if short <= 0:
                    break
                if self.alloc.free < short and self.prefix is not None:
                    self.prefix.shrink(short)
                if self.alloc.free >= short:
                    for p in self.alloc.alloc(short):
                        self._bt_host[i, len(self._slot_pages[i])] = p
                        self._slot_pages[i].append(p)
                    self._bt_dirty = True
                    break
                if not self._evict_lowest_priority(now):
                    break

    # -- the chunk pipeline ---------------------------------------------------

    def _dispatch_chunk(self, now: float) -> None:
        """Enqueue one chunk and the copy of its emit ring; no host wait
        here. An armed profile request starts here, on the engine thread,
        never at the first dispatch (whose kernels may still be
        building)."""
        if self._profile_req is not None and self._profiler is None \
                and self.decode_steps > 0:
            with self._profile_lock:
                req, self._profile_req = self._profile_req, None
            if req is not None:
                from dalle_pytorch_tpu_torch.utils.profiling import \
                    StepProfiler
                log_dir, chunks = req
                start = self.decode_steps // self.chunk_steps
                prof = StepProfiler(log_dir, start=start, steps=chunks)
                # stop once the chunks in flight (they harvest first)
                # and ours have all been harvested
                self._profile_left = len(self._pending) + chunks
                self._profiler = prof
                try:
                    prof.maybe_start(start)
                except BaseException:
                    self._profiler = None
                    raise
        if self.kv == "paged":
            self._map_ahead(now)
            if self._bt_dirty:
                self.block_tables = self._put(self._bt_host)
                self._bt_dirty = False
        self._sync_cfg()
        self.cur_tok, self.pos, self.active, ring = self._decode_chunk()
        owners = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if self.kv == "paged":
            for i, _ in owners:
                self._pos_est[i] = min(self._pos_est[i] + self._chunk_span,
                                       self.total_len)
        (ring_h, active_h), ready = self._fetch(ring, self.active)
        self._pending.append(_Chunk(ring_h, active_h, ready, owners))
        self.decode_steps += self.chunk_steps

    def _harvest_chunk(self) -> None:
        """Wait for the OLDEST chunk's ring — the one host wait per
        chunk — hand each slot's tokens to the request that owned it at
        dispatch, and complete the slots whose request finished."""
        rec = self._pending.popleft()
        if rec.ready is not None:
            rec.ready.synchronize()
        ring, active_after = rec.ring.numpy(), rec.active.numpy()
        self.harvests += 1
        # the wait above is where a wedged card stalls this thread
        self.last_heartbeat = self.clock()
        if self._profiler is not None:
            # chunks harvest in order: the countdown reaches 0 once the
            # last captured chunk has run on the card
            self._profile_left -= 1
            if self._profile_left <= 0:
                self._finish_profile()
        now = self.clock()
        emitted = 0
        kill: List[int] = []
        for i, slot in rec.owners:
            if slot.shadow_of is not None:
                continue            # mirrors its cond slot; never credited
            if slot.handle.done() or self.slots[i] is not slot:
                # expired or EVICTED since dispatch: its ring row is dead
                # (an evicted request replays every token)
                continue
            row = ring[i]
            toks = row[row >= 0]
            capped = False
            if slot.need is not None:
                # a short grid: the card decodes the full grid, the host
                # stops delivering at the budget and completes early
                left = slot.need - len(slot.emitted)
                if len(toks) >= left:
                    toks = toks[:left]
                    capped = True
            slot.emitted.extend(int(t) for t in toks)
            emitted += len(toks)
            sink = slot.handle.sink
            if sink is not None and len(toks):
                # absolute positions: the sink drops what a replay
                # re-delivers; it never blocks (its ring sheds instead)
                sink.push_tokens(slot.t0 + len(slot.emitted) - len(toks),
                                 [int(t) for t in toks])
                if (self.on_preview is not None and self.preview_every
                        and not capped):
                    slot.since_preview += 1
                    img_done = len(slot.emitted) \
                        - (self.cfg.text_seq_len - slot.t0)
                    if slot.since_preview >= self.preview_every \
                            and img_done > 0:
                        slot.since_preview = 0
                        self.previews_requested += 1
                        self.on_preview(slot.handle, np.asarray(
                            slot.emitted[self.cfg.text_seq_len - slot.t0:],
                            np.int32))
            if self.speculative:
                # acceptance over delivered tokens; each round's
                # potential is k clamped at the sequence end
                kk = self.speculative
                cursor = slot.t0 + len(slot.emitted) - len(toks)
                for w in row.reshape(-1, kk):
                    n = int((w >= 0).sum())
                    if n == 0:
                        continue
                    self.spec_rounds += 1
                    self.spec_proposed += min(kk, self.total_len - cursor)
                    cursor += n
                self.spec_delivered += len(toks)
                if self.kv == "paged":
                    # tighten the pos bound with the delivered truth:
                    # dispatch assumed full acceptance
                    later = sum(1 for c in self._pending
                                if any(j == i for j, _ in c.owners))
                    bound = min(slot.t0 + len(slot.emitted)
                                + self._chunk_span * later, self.total_len)
                    self._pos_est[i] = min(self._pos_est[i], bound)
                    if slot.pair is not None:
                        self._pos_est[slot.pair] = \
                            min(self._pos_est[slot.pair], bound)
            if len(toks):
                self._span(slot.handle, "decode_chunk", now,
                           tokens=int(len(toks)))
            if capped:
                # the budget is met mid-sequence: the slot (and its
                # shadow) must also leave the device mask
                kill.extend(self._complete(i, slot, now))
            elif not bool(active_after[i]):
                self._complete(i, slot, now)
        if kill:
            self._kill(kill)
        self.tokens_decoded += emitted
        self.occupancy_sum += emitted

    def _complete(self, i: int, slot: _Slot, now: float) -> List[int]:
        """Free the slot and hand its result on; a short grid delivers
        its capped span. Returns the freed slot indices."""
        req = slot.handle.request
        full = list(req.codes) + slot.emitted
        L = int(req.image_seq_len_override) or self.cfg.image_seq_len
        self.completed += 1
        freed = self._free_slot(i)
        self._finish(slot.handle, S.Result(
            status=S.OK, request_id=req.request_id,
            tokens=np.asarray(full[-L:], np.int32),
            text_tokens=np.asarray(full[:self.cfg.text_seq_len], np.int32),
            queued_s=round(slot.t_admit - req.submit_t, 6),
            decode_s=round(now - slot.t_admit, 6),
            total_s=round(now - req.submit_t, 6)))
        return freed

    # -- live slot migration --------------------------------------------------

    def find_slot(self, request_id: int) -> Optional[int]:
        """The cond slot holding ``request_id``, None when it is not in a
        slot (queued, mid-admission or gone)."""
        for i, s in enumerate(self.slots):
            if s is not None and s.shadow_of is None \
                    and s.handle.request.request_id == int(request_id):
                return i
        return None

    def export_slot(self, i: int):
        """Snapshot slot ``i``'s whole decode state into a JSON-safe
        payload (JAX's keys) and VACATE the slot: pages released, device
        row killed, the handle neither fulfilled nor requeued — the
        caller owns it now. A guided pair's shadow rides in the same
        payload. Returns ``(payload, handle)``; a ``MigrationError``
        leaves the slot as it was."""
        with self._lock:
            if self.fenced:
                raise MigrationError("fenced")
            if self.kv != "paged":
                raise MigrationError(
                    "kv_dense", "migration moves KV pages; the dense "
                    "slot cache has none")
            # the device rows and the host's emitted list must describe
            # the same point of the stream: flush the pipeline first
            while self._pending:
                self._harvest_chunk()
            slot = self.slots[i] if 0 <= i < self.num_slots else None
            if slot is None or slot.shadow_of is not None:
                raise MigrationError("not_found", f"slot {i}")
            if slot.handle.done():
                raise MigrationError("not_found",
                                     "request completed during export")
            now = self.clock()
            host = [t.cpu() for t in (self.pos, self.cur_tok, self.rng,
                                      self.temp, self.topk_k, self.top_p)]
            pos_h, tok_h, rng_h, temp_h, topk_h, topp_h = host

            def rows(j):
                return {"pos": int(pos_h[j]), "cur_tok": int(tok_h[j]),
                        "rng": [int(x) for x in rng_h[j]],
                        "temp": float(temp_h[j]),
                        "topk_k": int(topk_h[j]),
                        "top_p": float(topp_h[j]),
                        "pages": [{k: _pack_array(v) for k, v in
                                   KV.snapshot_page(self.pool, pid).items()}
                                  for pid in self._slot_pages[j]]}

            payload = {
                "format": 1,
                "request_id": int(slot.handle.request.request_id),
                "handle": slot.handle.to_wire(now),
                "emitted": [int(t) for t in slot.emitted],
                "t0": int(slot.t0),
                "weights_version": self.weights_version,
                "page_size": int(self.page_size),
                "quantized": bool(self.quantize_cache),
                "cond": rows(i),
                "uncond": None,
            }
            j = slot.pair
            if j is not None and self.slots[j] is not None \
                    and self.slots[j].shadow_of == i:
                payload["uncond"] = rows(j)
                payload["uncond"]["cfg_scale"] = float(
                    slot.handle.request.cfg_scale)
            handle = slot.handle
            self._span(handle, "migrate_out", now, slot=i,
                       pos=int(pos_h[i]), tokens_done=len(slot.emitted))
            self._kill(self._free_slot(i))
            return payload, handle

    def export_request(self, request_id: int):
        """``export_slot`` addressed by request id."""
        i = self.find_slot(request_id)
        if i is None:
            raise MigrationError("not_found", f"request {request_id} "
                                 "is not in a slot on this engine")
        return self.export_slot(i)

    @torch.no_grad()
    def import_slot(self, payload: dict,
                    handle: Optional[S.RequestHandle] = None) -> int:
        """Install an exported slot here: fresh pages filled from the
        snapshot (host -> card), the exported device rows in free slots,
        harvesting resumed where the source stopped. ``handle`` is the
        live handle (None rebuilds a stand-in from the payload). Returns
        the cond slot; a ``MigrationError`` leaves this engine as it
        was (a torn snapshot is discarded whole)."""
        with self._lock:
            if self.fenced:
                raise MigrationError("fenced")
            if self.kv != "paged":
                raise MigrationError("kv_dense")
            if str(payload.get("weights_version")) != self.weights_version:
                raise MigrationError(
                    "weights_version",
                    f"snapshot from {payload.get('weights_version')!r}, "
                    f"target serves {self.weights_version!r} — tokens "
                    "are byte-identical PER weight generation only")
            if int(payload.get("page_size", 0)) != self.page_size:
                raise MigrationError(
                    "page_size", f"snapshot pages hold "
                    f"{payload.get('page_size')} rows, target pool "
                    f"holds {self.page_size}")
            if bool(payload.get("quantized")) != self.quantize_cache:
                raise MigrationError(
                    "layout", "int8-KV snapshot into a float pool (or "
                    "the reverse)")
            now = self.clock()
            if handle is None:
                handle = S.RequestHandle.from_wire(payload["handle"], now)
            parts = [payload["cond"]]
            if payload.get("uncond") is not None:
                parts.append(payload["uncond"])
            free = [k for k, s in enumerate(self.slots) if s is None]
            if len(free) < len(parts):
                raise MigrationError(
                    "target_slots", f"need {len(parts)} free slots, "
                    f"have {len(free)}")
            need = sum(len(p["pages"]) for p in parts)
            if self.alloc.free < need and self.prefix is not None:
                self.prefix.shrink(need)
            try:
                grants = self.alloc.alloc(need)
            except Exception as e:
                raise MigrationError(
                    "target_pages", f"need {need} pages: {e}") from e
            idx = free[:len(parts)]
            try:
                # decode every page before touching the pool: a torn
                # snapshot fails here with nothing written
                snaps = [[{k: _unpack_array(v).to(self.device)
                           for k, v in packed.items()}
                          for packed in part["pages"]] for part in parts]
                taken = 0
                for k, part, part_snaps in zip(idx, parts, snaps):
                    pages = grants[taken:taken + len(part_snaps)]
                    taken += len(part_snaps)
                    for pid, snap in zip(pages, part_snaps):
                        KV.restore_page(self.pool, pid, snap)
                    self._bt_host[k, :] = 0
                    self._bt_host[k, :len(pages)] = pages
                    self._slot_pages[k] = list(pages)
                    self._pos_est[k] = int(part["pos"])
            except Exception as e:  # noqa: BLE001 — discard, never wedge
                self.alloc.release(grants)
                for k in idx:
                    self._bt_host[k, :] = 0
                    self._slot_pages[k] = []
                    self._pos_est[k] = 0
                self._bt_dirty = True
                raise MigrationError("transfer", repr(e)) from e
            self._bt_dirty = True
            put = self._put
            rows = put(np.asarray(idx, np.int64))
            self.cur_tok[rows] = put(np.asarray(
                [p["cur_tok"] for p in parts], np.int32))
            self.pos[rows] = put(np.asarray([p["pos"] for p in parts],
                                            np.int32))
            self.active[rows] = True
            self.rng[rows] = put(np.asarray([p["rng"] for p in parts],
                                            np.int64))
            self.temp[rows] = put(np.asarray([p["temp"] for p in parts],
                                             np.float32))
            self.topk_k[rows] = put(np.asarray(
                [p["topk_k"] for p in parts], np.int32))
            self.top_p[rows] = put(np.asarray([p["top_p"] for p in parts],
                                              np.float32))
            i = idx[0]
            t0 = int(payload["t0"])
            self.slots[i] = _Slot(handle, t0, now,
                                  need=self._slot_need(handle.request, t0))
            self.slots[i].emitted = [int(t) for t in payload["emitted"]]
            if len(parts) == 2:
                j = idx[1]
                self.slots[j] = _Slot(handle, t0, now, shadow_of=i)
                self.slots[i].pair = j
                self._cfg_wire(i, j, payload["uncond"]["cfg_scale"])
            self._span(handle, "migrate_in", now, slot=i,
                       pos=int(payload["cond"]["pos"]),
                       tokens_done=len(payload["emitted"]))
            return i

    # -- the loop -------------------------------------------------------------

    @property
    def pages_free(self) -> int:
        """The paged pool's free pages (a process replica's client shows
        its child's under the same name)."""
        return self.alloc.free

    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def step_once(self) -> bool:
        """One iteration: expire, admit, dispatch ONE chunk, and harvest
        the previous one. Returns True when any work happened."""
        with self._lock:
            if self.fenced:
                if self._profiler is not None:
                    self._profiler.close()      # a capture the fence cut
                    self._profiler = None
                return False        # reclaimed: this pool is dead weight
            now = self.clock()
            self.last_heartbeat = now
            if self._t_start is None:
                self._t_start = now
            did = False
            kill = []
            for i, slot in enumerate(self.slots):
                if slot is None or slot.shadow_of is not None:
                    continue        # a shadow goes with its cond slot
                if slot.handle.done():
                    # fulfilled from outside mid-decode (a torn stream, a
                    # cancelled group): free the slot and its pages now
                    self.reaped += 1
                    self.metrics.event(**S.structured_event(
                        "serve_slot_reaped",
                        request_id=slot.handle.request.request_id,
                        tokens_done=len(slot.emitted)))
                    kill.extend(self._free_slot(i))
                    continue
                dt = slot.handle.request.deadline_t
                if dt is not None and now > dt:
                    self._expire(slot.handle, now, "decoding")
                    kill.extend(self._free_slot(i))
            if kill:
                self._kill(kill)
                did = True
            free = self.num_slots - self.active_slots()
            if self.kv == "paged":
                # hold admission while the head-of-line request's need
                # (or the smallest prompt span) is not free
                floor = self._hol_need if self._hol_rid is not None \
                    else self._min_admit_pages
                if self.alloc.free < floor and self.prefix is not None \
                        and self.queue.depth() > 0:
                    self.prefix.shrink(floor)
                if self.alloc.free < floor:
                    free = 0
            ready, expired = self.queue.pop_ready(free, now)
            for h in expired:
                self._expire(h, now, "queued")
                if self.kv == "paged":
                    if h.request.request_id == self._hol_rid:
                        self._hol_rid = None
                        self._hol_need = 0
            for h in ready:
                # the queue wait ends at the first pop of an attempt; a
                # page-deferred re-pop folds into its prefill_admit span
                if h.trace is not None \
                        and not h.trace.has_in_attempt("queue_wait"):
                    self._span(h, "queue_wait", now)
            if ready:
                # published for the reclaim sweep while admission runs
                self._admitting = list(ready)
                try:
                    self._admit(ready, now)
                finally:
                    self._admitting = []
            did = did or bool(ready or expired)

            dispatched = self.active_slots() > 0
            if dispatched:
                with self._first_call(self.decode_steps == 0):
                    self._dispatch_chunk(now)
                did = True
            # double buffer: keep one chunk in flight while dispatching,
            # drain the pipeline once nothing new is dispatched
            while len(self._pending) > (1 if dispatched else 0):
                self._harvest_chunk()
                did = True
            if self._profiler is not None and not dispatched \
                    and not self._pending:
                # drained before the capture's chunks ran: close it with
                # what it has
                self._finish_profile(partial=True)
            if self.log_every and \
                    self.decode_steps - self._last_log >= self.log_every:
                self._last_log = self.decode_steps
                self.metrics.event(event="serve", **self.stats())
            return did

    @contextlib.contextmanager
    def _first_call(self, first: bool):
        """Around a first call of the engine's programs (a bucket's first
        prefill, the first warm admission, the first dispatch), which
        may load or build kernels and warm the libraries up, seconds on
        a cold card: ``compiling`` while it runs, so the supervisor does
        not read its silence as a hang, and a heartbeat when it ends (JAX
        ``:1414-1433``, ``:1600-1656``, ``:1889-1911``)."""
        if not first:
            yield
            return
        self.compiling = True
        try:
            yield
        finally:
            self.compiling = False
            self.last_heartbeat = self.clock()

    def idle(self) -> bool:
        return self.queue.depth() == 0 and self.active_slots() == 0 \
            and not self._pending

    def compile_pending(self) -> bool:
        """True when the next ``step_once`` may run the engine's first
        admission and dispatch (kernel loads, library warm-up: seconds on
        a cold process). A process worker cannot stamp a heartbeat inside
        a step, so it asks this first and sends a ``compiling`` heartbeat
        (JAX ``Engine.compile_pending``; the port has no per-bucket
        programs to compile)."""
        return self.decode_steps == 0 and (self.active_slots() > 0
                                           or self.queue.depth() > 0)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive until the queue is empty, every slot is free and every
        chunk is harvested. ``max_steps`` is a runaway guard."""
        for _ in range(max_steps):
            busy = self.step_once()
            if not busy and self.idle():
                return
        raise RuntimeError(f"engine did not go idle in {max_steps} steps")

    def run(self, stop: threading.Event, idle_sleep_s: float = 0.002):
        """The serving thread's loop: step while there is work, nap when
        idle. A step that raises does not end the loop: the in-slot
        requests get typed ``error`` results, the pool is reset and
        serving goes on."""
        while not stop.is_set():
            try:
                busy = self.step_once()
            except Exception as e:  # noqa: BLE001 — typed results, below
                # recovery first: a raising metrics sink must not stop the
                # in-slot handles from being fulfilled
                n = self.fail_active(f"engine step failed: {e!r}")
                try:
                    self.metrics.event(**S.structured_event(
                        "serve_engine_error", error=repr(e), failed=n))
                except Exception:   # noqa: BLE001
                    pass
                stop.wait(idle_sleep_s)     # never hot-spin on a fault
                continue
            if not busy and self.idle():
                stop.wait(idle_sleep_s)
        if self._profiler is not None:
            # clean shutdown with a capture in flight: stop the
            # process-global trace (partial but valid) on the way out
            self._profiler.close()
            # racelint: disable=RL001 — _profiler is run-loop-thread-
            # private (armed via the _profile_req handoff); this is the
            # loop's own epilogue, no other thread ever writes it
            self._profiler = None

    def _terminate_active(self, status: str, reason: str) -> int:
        """Fulfil every in-slot request with a typed terminal result and
        reset the pool to idle (after a failed step the slot state may be
        half-updated and the chunks in flight unusable). Returns the
        number terminated."""
        n = 0
        with self._lock:
            now = self.clock()
            for i, slot in enumerate(self.slots):
                if slot is None or slot.shadow_of is not None:
                    continue        # a shadow dies with its cond slot
                req = slot.handle.request
                slot.handle.fulfill(S.Result(
                    status=status, request_id=req.request_id,
                    reason=reason, weights_version=self.weights_version,
                    queued_s=round(slot.t_admit - req.submit_t, 6),
                    total_s=round(now - req.submit_t, 6)))
                self._free_slot(i)
                n += 1
            self._pending.clear()
            if self._profiler is not None:
                self._profiler.close()
                self._profiler = None
            self.cur_tok = torch.zeros_like(self.cur_tok)
            self.pos = torch.zeros_like(self.pos)
            self.active = torch.zeros_like(self.active)
            self._sync_cfg()
            if self.kv == "paged" and self._bt_dirty:
                self.block_tables = self._put(self._bt_host)
                self._bt_dirty = False
        return n

    def fail_active(self, reason: str) -> int:
        """Typed ``error`` results for every in-slot request: the run
        loop's recovery after a step failed."""
        return self._terminate_active(S.ERROR, reason)

    def cancel_active(self, reason: str = "server shutdown") -> int:
        """Typed ``cancelled`` results for every in-slot request: the
        shutdown path."""
        return self._terminate_active(S.CANCELLED, reason)

    # -- profile requests -----------------------------------------------------

    def _finish_profile(self, partial: bool = False) -> None:
        """Stop the capture and record ``serve_profile_done`` (engine
        thread only)."""
        prof = self._profiler
        if prof is None:
            return
        # close before clearing: profile_active() stays true while the
        # trace is written
        prof.close()
        self._profiler = None
        self.profiles_taken += 1
        rec = S.structured_event(
            "serve_profile_done", dir=prof.log_dir,
            chunks=prof.stop_at - prof.start, trace=prof.trace_path)
        if partial:
            rec["partial"] = True
        self.metrics.event(**rec)

    def request_profile(self, log_dir: str, chunks: int = 8) -> dict:
        """Arm a torch.profiler capture over the NEXT ``chunks`` decode
        chunks (``POST /admin/profile``, ``utils.profiling.StepProfiler``):
        it starts at the engine thread's next dispatch and stops once
        those chunks are harvested, its Chrome trace written under
        ``log_dir``. ``ProfileError`` (``capture_active``) while one is
        armed or running."""
        chunks = int(chunks)
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        if not log_dir:
            raise ValueError("request_profile needs a log_dir")
        with self._profile_lock:
            prof = self._profiler
            if prof is not None:
                raise ProfileError(S.structured_event(
                    "serve_profile_reject", reason="capture_active",
                    dir=prof.log_dir, start_chunk=prof.start,
                    chunks=prof.stop_at - prof.start))
            if self._profile_req is not None:
                raise ProfileError(S.structured_event(
                    "serve_profile_reject", reason="capture_active",
                    dir=self._profile_req[0],
                    chunks=self._profile_req[1]))
            self._profile_req = (str(log_dir), chunks)
        rec = S.structured_event(
            "serve_profile_armed", dir=str(log_dir), chunks=chunks,
            # advisory: the engine thread takes the real start index
            start_chunk=self.decode_steps // self.chunk_steps)
        self.metrics.event(**rec)
        return rec

    def profile_active(self) -> bool:
        """A capture is armed or running."""
        return self._profiler is not None or self._profile_req is not None

    def capturing(self) -> bool:
        """A capture is running (armed is not enough: a stuck replica
        that never dispatches again must not dodge its hang deadline)."""
        return self._profiler is not None

    # -- observability --------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """The ``COUNTERS`` block as a dict."""
        return {k: int(getattr(self, k)) for k in COUNTERS}

    def kv_hbm_bytes(self) -> int:
        """Resident bytes of the KV store on the card: the page pool, or
        the dense slot cache."""
        return sum(t.numel() * t.element_size()
                   for part, _, _ in decode_ops.pool_shards(self.pool)
                   for t in part.values())

    def stats(self) -> dict:
        elapsed = None if self._t_start is None \
            else max(self.clock() - self._t_start, 1e-9)
        paged = {}
        if self.kv == "paged":
            paged = {
                "paged_attn": self.paged_attn,
                "sparse_reads": self.sparse_reads,
                "kv_read_bytes_per_token":
                    self.kv_read_bytes[self.sparse_reads],
                "kv_read_bytes_per_token_dense_reads":
                    self.kv_read_bytes[False],
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "pages_in_use": self.alloc.in_use,
                "pages_free": self.alloc.free,
                "pages_peak": self.alloc.peak_in_use,
                "pages_shared": self.alloc.pages_shared,
                "pages_shared_saved": self.alloc.refs_saved,
                "evicted": self.evicted,
                "requeued": self.queue.requeued,
            }
            if self.prefix is not None:
                paged.update({
                    "prefix_cache": True,
                    "prefix_hits": self.prefix_hits,
                    "prefix_entries": len(self.prefix),
                    "prefix_pages_held": self.prefix.pages_held,
                    "prefix_evictions": self.prefix.evicted,
                    "warm_admits": self.warm_admits,
                })
                if self.time_admissions:
                    paged["prefill_p50_ms"] = _p50_ms(self.prefill_times)
                    paged["warm_admit_p50_ms"] = _p50_ms(
                        self.warm_admit_times)
        spec = {}
        if self.speculative:
            spec = {
                "speculative": self.speculative,
                "draft_layers": self.draft_layers,
                "spec_rounds": self.spec_rounds,
                # delivered over proposed: 1/k is the total-rejection
                # floor, 1.0 every draft matched
                "spec_acceptance_rate": round(
                    self.spec_delivered / max(self.spec_proposed, 1), 4),
                "spec_tokens_per_round": round(
                    self.spec_delivered / max(self.spec_rounds, 1), 3),
            }
        return {
            "kv": self.kv,
            "kv_hbm_bytes": self.kv_hbm_bytes(),
            **self._mesh_stats(),
            **paged,
            **spec,
            "queue_depth": self.queue.depth(),
            "active_slots": self.active_slots(),
            "num_slots": self.num_slots,
            "chunk_steps": self.chunk_steps,
            "decode_steps": self.decode_steps,
            "prefill_runs": self.prefill_runs,
            "tokens_decoded": self.tokens_decoded,
            "tokens_per_s": (round(self.tokens_decoded / elapsed, 2)
                             if elapsed else 0.0),
            "mean_occupancy": round(self.occupancy_sum
                                    / max(self.decode_steps, 1), 3),
            "completed": self.completed,
            "expired": self.expired,
            "cfg_pairs": self.cfg_pairs,
            "reaped": self.reaped,
            "previews_requested": self.previews_requested,
            "rejected": self.queue.rejected,
            "prefill_buckets": list(self.buckets),
            "harvests": self.harvests,
            "host_round_trips_per_token": round(
                self.harvests / max(self.tokens_decoded, 1), 6),
            "flight_events": len(self.flight),
            "profile_active": self.profile_active(),
            "profiles_taken": self.profiles_taken,
        }
