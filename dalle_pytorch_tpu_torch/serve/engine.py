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

Left for later slices (see ROADMAP.md): streams and previews, short
grids, tenants, live migration, the flight recorder and profile
requests, fencing, meshes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import decode as decode_ops
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import prefix_cache as PC
from dalle_pytorch_tpu_torch.serve import scheduler as S

# the engine's lifetime counters (JAX ``COUNTERS``, less its compile
# counters, the port tracing nothing, and ``reaped``, which the HTTP
# tier's cancellations feed)
COUNTERS = ("tokens_decoded", "decode_steps", "harvests", "occupancy_sum",
            "completed", "expired", "evicted", "prefix_hits", "cfg_pairs")


class PoolTooSmall(ValueError):
    """The page pool cannot hold even one full sequence plus the trash
    page: eviction needs one request to be able to run alone, or it
    could evict forever."""


class _Slot:
    """Host bookkeeping of one slot. A guided pair is two slots: the cond
    slot carries ``pair`` (its shadow's index), the uncond SHADOW
    ``shadow_of`` (the cond index); the shadow holds the same handle but
    is never credited, completed or evicted on its own."""

    __slots__ = ("handle", "t0", "emitted", "t_admit", "pair", "shadow_of")

    def __init__(self, handle: S.RequestHandle, t0: int, t_admit: float,
                 pair: Optional[int] = None,
                 shadow_of: Optional[int] = None):
        self.handle = handle
        self.t0 = t0
        self.emitted: List[int] = []
        self.t_admit = t_admit
        self.pair = pair
        self.shadow_of = shadow_of


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
                 model_version: str = "0",
                 time_admissions: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        self.device = resolve_device(device)
        param = model.text_emb.weight
        if param.device.type != self.device.type or (
                self.device.index is not None
                and param.device.index != self.device.index):
            raise ValueError(f"model lies on {param.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg = model.cfg
        tcfg = cfg.transformer
        self.queue = queue
        self.num_slots = S_ = int(num_slots)
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.complete = complete
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
        dtype = param.dtype
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
            self.pool = KV.init_page_pool(
                tcfg, self.num_pages, self.page_size, dtype=dtype,
                quantized=self.quantize_cache, device=self.device)
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
                itemsize=self.pool["k"].element_size(),
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
            self.pool = decode_ops.init_cache(
                tcfg, S_, self.total_len, dtype=dtype,
                quantized=self.quantize_cache, device=self.device)
        self.evicted = 0
        self.model_version = str(model_version)
        self.time_admissions = bool(time_admissions)
        self.prefill_times: List[float] = []
        self.warm_admit_times: List[float] = []
        self._prefilled: set = set()       # buckets prefilled at least once

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
        self._cfg_dirty = True
        self._sync_cfg()
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
        # speculative accounting over DELIVERED tokens: rounds that
        # emitted, the tokens they emitted, and the positions they could
        # have emitted (k, clamped at the sequence end)
        self.spec_rounds = 0
        self.spec_delivered = 0
        self.spec_proposed = 0

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

    # -- the device programs ---------------------------------------------------

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
            return D.sample_per_slot(D.to_logits(model, h), pred_pos,
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
        first = D.sample_per_slot(D.to_logits(self.model, h_last), lens,
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
            for name, buf in self.pool.items():
                # advanced indices at dims 1 and 3 are apart, so the value
                # is (n, bucket, depth, heads[, dh])
                buf[:, page_rows, :, off] = kv[name][:, :n].movedim(1, 0) \
                    .movedim(3, 1).to(buf.dtype)
        else:
            slots = self._put(np.asarray([p.slot for p in rows], np.int64))
            for name, buf in self.pool.items():
                buf[:, slots, :, :bucket] = kv[name][:, :n].to(buf.dtype)
        g = torch.arange(G, device=self.device)
        h_last = h[g, self._put(a["lens"]).long() - 1]
        self._first_tokens(h_last, rows, a)
        self.prefill_runs += 1
        return h_last

    # -- request lifecycle ---------------------------------------------------

    def _finish(self, handle: S.RequestHandle, result: S.Result) -> None:
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
        self.expired += 1
        self._terminal(handle, now, S.DEADLINE_EXCEEDED,
                       f"deadline_s={handle.request.deadline_s:g} exceeded "
                       f"({where})")

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

    def _admit(self, handles: List[S.RequestHandle], now: float) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        valid = []
        for h in handles:
            if h.done():
                continue
            n = len(h.request.codes)
            if not 1 <= n <= self.cfg.text_seq_len:
                self._terminal(h, now, S.ERROR, f"invalid prompt length "
                               f"{n} (need 1..{self.cfg.text_seq_len})")
                continue
            if h.request.cfg_scale > 0 and self.num_slots < 2:
                self._terminal(h, now, S.ERROR, "cfg_scale needs a "
                               "cond/uncond slot pair: num_slots must be "
                               ">= 2")
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
                    self.queue.requeue(hh)
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
                        self.queue.requeue(hh)
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

    def _admit_cold(self, rows: List[_Row], free: List[int],
                    now: float) -> List[int]:
        """Bucket-grouped prefill admission of the plan's cold rows.
        Returns the free slots left for the warm rows."""
        groups: Dict[int, List[_Row]] = {}
        for p in rows:
            if p.mode == "cold":
                groups.setdefault(p.bucket, []).append(p)
        for bucket, group in groups.items():
            idx, free = free[:len(group)], free[len(group):]
            for j, p in enumerate(group):
                p.slot, p.group_idx = idx[j], j
                if self.kv == "paged":
                    self._bt_host[p.slot, :] = 0
                    self._bt_host[p.slot, :len(p.grants)] = p.grants
            timed = self.time_admissions and bucket in self._prefilled
            t_pre = self.clock()
            h_last = self._prefill_group(bucket, group)
            self._prefilled.add(bucket)
            if timed:
                self._sync()
                self.prefill_times.append(self.clock() - t_pre)
            for p in group:
                self.slots[p.slot] = _Slot(p.handle, p.t0, now)
                if self.kv == "paged":
                    self._slot_pages[p.slot] = list(p.grants)
                    self._pos_est[p.slot] = p.t0
                    self._bt_dirty = True
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
            if not resolved:
                # the cold sibling's insert never landed: give the pages
                # back and retry next pop
                for q in hrows:
                    if q.grants:
                        self.alloc.release(q.grants)
                        q.grants = []
                self.queue.requeue(p.handle)
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
        self._first_tokens(torch.stack(h_rows), warm,
                           self._admit_arrays(warm))
        if timed:
            self._sync()
            self.warm_admit_times.append(self.clock() - t_warm)
        for p in warm:
            i = p.slot
            self.slots[i] = _Slot(p.handle, p.t0, now)
            self._slot_pages[i] = list(p.entry.full_pages) + list(p.grants)
            self._pos_est[i] = p.t0
            self._bt_dirty = True
            self.prefix_hits += 1
            self.warm_admits += 1
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
        cand = [(s.handle.request.priority, s.t_admit, i)
                for i, s in enumerate(self.slots)
                if s is not None and s.shadow_of is None]
        if not cand:
            return False
        _, _, i = max(cand)
        slot = self.slots[i]
        self._kill(self._free_slot(i))
        self.evicted += 1
        self.tokens_decoded -= len(slot.emitted)
        self.occupancy_sum -= len(slot.emitted)
        self.queue.requeue(slot.handle)
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

    # -- the chunk pipeline ----------------------------------------------------

    def _dispatch_chunk(self, now: float) -> None:
        """Enqueue one chunk and the copy of its emit ring; no host wait
        here."""
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
        now = self.clock()
        emitted = 0
        for i, slot in rec.owners:
            if slot.shadow_of is not None:
                continue            # mirrors its cond slot; never credited
            if slot.handle.done() or self.slots[i] is not slot:
                # expired or EVICTED since dispatch: its ring row is dead
                # (an evicted request replays every token)
                continue
            row = ring[i]
            toks = row[row >= 0]
            slot.emitted.extend(int(t) for t in toks)
            emitted += len(toks)
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
            if not bool(active_after[i]):
                self._complete(i, slot, now)
        self.tokens_decoded += emitted
        self.occupancy_sum += emitted

    def _complete(self, i: int, slot: _Slot, now: float) -> None:
        req = slot.handle.request
        full = list(req.codes) + slot.emitted
        self.completed += 1
        self._free_slot(i)
        self._finish(slot.handle, S.Result(
            status=S.OK, request_id=req.request_id,
            tokens=np.asarray(full[-self.cfg.image_seq_len:], np.int32),
            text_tokens=np.asarray(full[:self.cfg.text_seq_len], np.int32),
            queued_s=round(slot.t_admit - req.submit_t, 6),
            decode_s=round(now - slot.t_admit, 6),
            total_s=round(now - req.submit_t, 6)))

    # -- the loop --------------------------------------------------------------

    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def step_once(self) -> bool:
        """One iteration: expire, admit, dispatch ONE chunk, and harvest
        the previous one. Returns True when any work happened."""
        with self._lock:
            now = self.clock()
            did = False
            kill = []
            for i, slot in enumerate(self.slots):
                if slot is None or slot.shadow_of is not None:
                    continue        # a shadow goes with its cond slot
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
            if ready:
                self._admit(ready, now)
            did = did or bool(ready or expired)

            dispatched = self.active_slots() > 0
            if dispatched:
                self._dispatch_chunk(now)
                did = True
            # double buffer: keep one chunk in flight while dispatching,
            # drain the pipeline once nothing new is dispatched
            while len(self._pending) > (1 if dispatched else 0):
                self._harvest_chunk()
                did = True
            return did

    def idle(self) -> bool:
        return self.queue.depth() == 0 and self.active_slots() == 0 \
            and not self._pending

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive until the queue is empty, every slot is free and every
        chunk is harvested. ``max_steps`` is a runaway guard."""
        for _ in range(max_steps):
            busy = self.step_once()
            if not busy and self.idle():
                return
        raise RuntimeError(f"engine did not go idle in {max_steps} steps")

    # -- observability -----------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """The ``COUNTERS`` block as a dict."""
        return {k: int(getattr(self, k)) for k in COUNTERS}

    def stats(self) -> dict:
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
            **paged,
            **spec,
            "queue_depth": self.queue.depth(),
            "active_slots": self.active_slots(),
            "num_slots": self.num_slots,
            "chunk_steps": self.chunk_steps,
            "decode_steps": self.decode_steps,
            "harvests": self.harvests,
            "prefill_runs": self.prefill_runs,
            "tokens_decoded": self.tokens_decoded,
            "mean_occupancy": round(self.occupancy_sum
                                    / max(self.decode_steps, 1), 3),
            "completed": self.completed,
            "expired": self.expired,
            "cfg_pairs": self.cfg_pairs,
        }
