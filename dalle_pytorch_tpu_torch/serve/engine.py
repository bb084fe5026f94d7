"""Slot-pool continuous-batching decode engine over a paged KV cache.

Port of ``dalle_pytorch_tpu/serve/engine.py`` for ``kv='paged',
paged_attn='kernel'``: a fixed batch of ``num_slots`` decode slots that
requests join and leave by masking, whose per-token KV read is the
paged-attention kernel K4 (``ops/paged_attention.py``) walking each
slot's block table in place.

* All per-slot decode state lives on the card: current token, position,
  an active mask, the per-slot PRNG key, temperature, top-k and top-p,
  and the page pool. The host keeps request bookkeeping, the page
  allocator and the authoritative block tables, pushed to the card only
  when they change.
* ``_dispatch_chunk`` enqueues ``chunk_steps`` (K) decode steps for every
  slot (``ops.decode.decode_loop_paged``) writing each step's token into
  a device-side ``(slots, K)`` emit ring, and starts an asynchronous copy
  of the ring to pinned host memory. ``_harvest_chunk`` waits for that
  copy one chunk LATER, so the host enqueues chunk N+1 while the card
  computes chunk N: one host wait per K tokens, overlapped.
* Admission pads prompts to a small fixed set of BUCKET lengths and
  prefills each bucket's group in one batched pass
  (``_prefill_group``, the JAX ``_prefill_fn``), scatters the prompt's
  K/V rows into the slot's pages, and samples the first token at
  position t0 with key ``fold_in(PRNGKey(seed), t0)``.
* Admission is gated on free pages for the prompt span, and before each
  chunk ``_map_ahead`` maps every page the K steps could write, so a
  page-boundary crossing never needs a host round trip.
* ``sparse_reads=True`` (a model with block-sparse layers, in a periodic
  pattern) makes each sparse layer read only its statically visible
  pages through K4's visible walk; the tokens do not change.

Equivalence contract (tests/test_torch_engine.py): for the same weights,
prompt, seed and sampling knobs, a slot's tokens equal the JAX engine's
and ``generate_images``' at batch 1, because the step reuses the same
embedding, head and per-slot sampler with the same key discipline.

Left for later slices (see ROADMAP.md): eviction (so the pool must hold
``num_slots`` full sequences), prefix cache, classifier-free-guidance
pairs, speculative decode, int8 weights, meshes, live migration,
profiling and fencing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import decode as decode_ops
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import scheduler as S


class PoolTooSmall(ValueError):
    """The page pool cannot hold ``num_slots`` full sequences. The JAX
    engine overcommits and evicts the lowest-priority request when the
    pool runs dry; eviction is a later slice of the port (ROADMAP.md,
    queue 1, "eviction"), so until then the pool must be fully
    provisioned."""


class _Slot:
    __slots__ = ("handle", "t0", "emitted", "t_admit")

    def __init__(self, handle: S.RequestHandle, t0: int, t_admit: float):
        self.handle = handle
        self.t0 = t0
        self.emitted: List[int] = []
        self.t_admit = t_admit


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


class Engine:
    """The continuous-batching loop: pulls from a ``RequestQueue`` and
    fulfils handles directly, or through ``complete(handle, result)``
    (the postprocess hand-off) for finished requests."""

    def __init__(self, model: D.DALLE, queue: S.RequestQueue, *,
                 num_slots: int = 8,
                 chunk_steps: int = 8,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 page_size: int = 16,
                 num_pages: int = 0,
                 quantize_cache: bool = False,
                 sparse_reads: bool = False,
                 complete: Optional[Callable] = None,
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
        self.queue = queue
        self.num_slots = S_ = int(num_slots)
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.complete = complete
        self.clock = clock
        self.quantize_cache = bool(quantize_cache)
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
        self.sparse_reads = bool(sparse_reads)
        if self.sparse_reads:
            decode_ops.check_sparse_reads(cfg.transformer)

        self.total_len = cfg.seq_len
        self.page_size = int(page_size)
        KV.validate_page_size(self.page_size)
        self.slot_max_pages = KV.pages_for(self.total_len, self.page_size)
        full = S_ * self.slot_max_pages + 1           # + the trash page
        self.num_pages = int(num_pages) or full
        if self.num_pages < full:
            raise PoolTooSmall(
                f"num_pages={self.num_pages} < {full}: {S_} slots of "
                f"{self.slot_max_pages} pages + the trash page. The port "
                f"has no eviction yet (a later slice), so the pool must "
                f"hold every slot's full sequence")
        self.pool = KV.init_page_pool(
            cfg.transformer, self.num_pages, self.page_size, dtype=param.dtype,
            quantized=self.quantize_cache, device=self.device)
        # modeled K/V read bytes per decoded token (config-static), with
        # this engine's reads and with dense reads: their ratio is what
        # sparse reads save
        tcfg = cfg.transformer
        self.kv_read_bytes = {sr: PA.modeled_kv_read_bytes_per_token(
            depth=tcfg.depth, heads=tcfg.heads, dim_head=tcfg.dim_head,
            total_len=self.total_len, page_size=self.page_size,
            prompt_len=min(self.buckets),
            itemsize=self.pool["k"].element_size(), impl="kernel",
            quantized=self.quantize_cache, sparse_reads=sr,
            sparse_pattern=tcfg.sparse_pattern if sr else None,
            sparse_block=tcfg.sparse_block, causal=tcfg.causal)
            for sr in {False, self.sparse_reads}}
        self.alloc = KV.PageAllocator(self.num_pages)
        self._bt_host = np.zeros((S_, self.slot_max_pages), np.int32)
        self.block_tables = self._put(self._bt_host)
        self._bt_dirty = False
        self._slot_pages: List[List[int]] = [[] for _ in range(S_)]
        # safe host upper bound of each slot's device pos (t0 + K per
        # dispatched chunk): mapping ahead off it never lags the device
        self._pos_est = [0] * S_

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
        self.slots: List[Optional[_Slot]] = [None] * S_
        self._pending: deque = deque()
        self._lock = threading.Lock()          # step_once is not reentrant

        self.decode_steps = 0        # fused steps dispatched (chunks * K)
        self.harvests = 0            # emit-ring host reads, one per chunk
        self.prefill_runs = 0        # bucket-group prefills dispatched
        self.tokens_decoded = 0
        self.completed = 0
        self.expired = 0

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

    # -- the device programs ---------------------------------------------------

    @torch.no_grad()
    def _prefill_group(self, bucket: int, text, lens, slots, seeds, temps,
                       topk, top_p, page_rows) -> None:
        """Batched prefill of one bucket's group, the scatter of its
        prompt rows [0, bucket) into their pages, the first sampled token
        of each row, and the merge of the new slots' decode state. Rows
        past a prompt's true length t0 are garbage that the decode step
        for that position overwrites before any later step reads it."""
        put = self._put
        text, lens, slots = put(text).long(), put(lens), put(slots).long()
        page_rows = put(page_rows).long()
        model, tcfg = self.model, self.cfg.transformer
        h, rows = decode_ops.prefill(model.transformer,
                                     D.embed_prompt(model, text), cfg=tcfg,
                                     quantize_cache=self.quantize_cache)
        off = (torch.arange(bucket, device=self.device)
               % self.page_size)[None, :]
        for name, buf in self.pool.items():
            # advanced indices at dims 1 and 3 are apart, so the value is
            # (G, bucket, depth, heads[, dh])
            val = rows[name].movedim(1, 0).movedim(3, 1)
            buf[:, page_rows, :, off] = val.to(buf.dtype)
        g = torch.arange(h.shape[0], device=self.device)
        h_last = h[g, lens.long() - 1]
        keys = prng.prng_key(put(seeds))
        temps, topk, top_p = put(temps), put(topk), put(top_p)
        first = D.sample_per_slot(D.to_logits(model, h_last), lens, keys,
                                  temps, topk, top_p, self.cfg)
        self.cur_tok[slots] = first.to(torch.int32)
        self.pos[slots] = lens
        self.active[slots] = True
        self.rng[slots] = keys
        self.temp[slots] = temps
        self.topk_k[slots] = topk
        self.top_p[slots] = top_p
        self.prefill_runs += 1

    @torch.no_grad()
    def _decode_chunk(self):
        model, cfg = self.model, self.cfg

        def embed_fn(tok, p):
            return D.decode_token_embed(model, tok, p)

        def sample_fn(h, pred_pos):
            return D.sample_per_slot(D.to_logits(model, h), pred_pos,
                                     self.rng, self.temp, self.topk_k,
                                     self.top_p, cfg)

        return decode_ops.decode_loop_paged(
            model.transformer, self.cur_tok, self.pos, self.active,
            self.pool, self.block_tables, cfg=cfg.transformer,
            key_mask=self.key_mask, steps=self.chunk_steps,
            embed_fn=embed_fn, sample_fn=sample_fn,
            sparse_reads=self.sparse_reads)

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

    def _admit(self, handles: List[S.RequestHandle], now: float) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        fits: List[S.RequestHandle] = []
        grants = {}
        for k, h in enumerate(handles):
            if h.done():
                continue
            n = len(h.request.codes)
            if not 1 <= n <= self.cfg.text_seq_len:
                self._terminal(h, now, S.ERROR, f"invalid prompt length "
                               f"{n} (need 1..{self.cfg.text_seq_len})")
                continue
            # the prompt span [0, bucket) is written by prefill, so its
            # pages are mapped up front; a request that does not fit
            # waits in line with everything behind it
            need = KV.pages_for(S.bucket_for(n, self.buckets),
                                self.page_size)
            if self.alloc.free < need:
                for hh in handles[k:]:
                    self.queue.requeue(hh)
                break
            grants[h.request.request_id] = self.alloc.alloc(need)
            fits.append(h)

        for bucket, group in S.group_by_bucket(fits, self.buckets).items():
            G = len(group)
            idx, free = free[:G], free[G:]
            text = np.zeros((G, bucket), np.int64)
            lens = np.zeros((G,), np.int32)
            seeds = np.zeros((G,), np.int64)
            temps = np.zeros((G,), np.float32)
            topk = np.zeros((G,), np.int32)
            top_p = np.zeros((G,), np.float32)
            page_rows = np.zeros((G, bucket), np.int32)
            for j, h in enumerate(group):
                req, i = h.request, idx[j]
                t0 = len(req.codes)
                text[j, :t0] = req.codes
                lens[j] = t0
                seeds[j] = req.seed
                temps[j] = req.sampling.temperature
                topk[j] = max(int((1 - req.sampling.filter_thres)
                                  * self.cfg.total_tokens), 1)
                top_p[j] = req.sampling.top_p
                pages = grants[req.request_id]
                self._bt_host[i, :] = 0
                self._bt_host[i, :len(pages)] = pages
                page_rows[j] = self._bt_host[
                    i, np.arange(bucket) // self.page_size]
            self._prefill_group(bucket, text, lens, np.asarray(idx),
                                seeds, temps, topk, top_p, page_rows)
            for j, h in enumerate(group):
                i = idx[j]
                self.slots[i] = _Slot(h, len(h.request.codes), now)
                self._slot_pages[i] = grants[h.request.request_id]
                self._pos_est[i] = len(h.request.codes)
            self._bt_dirty = True

    def _free_slot(self, i: int) -> None:
        """The one slot teardown: vacate it and return its pages."""
        self.slots[i] = None
        if self._slot_pages[i]:
            self.alloc.release(self._slot_pages[i])
            self._slot_pages[i] = []
        self._bt_host[i, :] = 0
        self._pos_est[i] = 0
        self._bt_dirty = True

    def _kill(self, slots: List[int]) -> None:
        keep = np.ones((self.num_slots,), bool)
        keep[slots] = False
        self.active = self.active & self._put(keep)

    def _map_ahead(self) -> None:
        """Before every chunk: map every page the K steps could write
        ([pos, pos+K)) off the host's safe pos bound. The constructor's
        full provisioning means the free list cannot run dry here."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            target = min(self._pos_est[i] + self.chunk_steps, self.total_len)
            short = KV.pages_for(target, self.page_size) \
                - len(self._slot_pages[i])
            if short > 0:
                for p in self.alloc.alloc(short):
                    self._bt_host[i, len(self._slot_pages[i])] = p
                    self._slot_pages[i].append(p)
                self._bt_dirty = True

    def _dispatch_chunk(self) -> None:
        """Enqueue one K-step chunk and the copy of its emit ring; no
        host wait here."""
        self._map_ahead()
        if self._bt_dirty:
            self.block_tables = self._put(self._bt_host)
            self._bt_dirty = False
        self.cur_tok, self.pos, self.active, ring = self._decode_chunk()
        owners = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        for i, _ in owners:
            self._pos_est[i] = min(self._pos_est[i] + self.chunk_steps,
                                   self.total_len)
        (ring_h, active_h), ready = self._fetch(ring, self.active)
        self._pending.append(_Chunk(ring_h, active_h, ready, owners))
        self.decode_steps += self.chunk_steps

    def _harvest_chunk(self) -> None:
        """Wait for the OLDEST chunk's ring — the one host wait per K
        steps — hand each slot's tokens to the request that owned it at
        dispatch, and complete the slots whose request finished."""
        rec = self._pending.popleft()
        if rec.ready is not None:
            rec.ready.synchronize()
        ring, active_after = rec.ring.numpy(), rec.active.numpy()
        self.harvests += 1
        now = self.clock()
        for i, slot in rec.owners:
            if slot.handle.done() or self.slots[i] is not slot:
                # expired or freed since dispatch: its ring row is dead
                continue
            row = ring[i]
            toks = row[row >= 0]
            slot.emitted.extend(int(t) for t in toks)
            self.tokens_decoded += len(toks)
            if not bool(active_after[i]):
                self._complete(i, slot, now)

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
        """One iteration: expire, admit, dispatch ONE K-step chunk, and
        harvest the previous one. Returns True when any work happened."""
        with self._lock:
            now = self.clock()
            did = False
            kill = []
            for i, slot in enumerate(self.slots):
                if slot is None:
                    continue
                dt = slot.handle.request.deadline_t
                if dt is not None and now > dt:
                    self._expire(slot.handle, now, "decoding")
                    self._free_slot(i)
                    kill.append(i)
            if kill:
                self._kill(kill)
                did = True
            free = self.num_slots - self.active_slots()
            ready, expired = self.queue.pop_ready(free, now)
            for h in expired:
                self._expire(h, now, "queued")
            if ready:
                self._admit(ready, now)
            did = did or bool(ready or expired)

            dispatched = self.active_slots() > 0
            if dispatched:
                self._dispatch_chunk()
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

    def stats(self) -> dict:
        return {"decode_steps": self.decode_steps,
                "harvests": self.harvests,
                "prefill_runs": self.prefill_runs,
                "tokens_decoded": self.tokens_decoded,
                "completed": self.completed,
                "expired": self.expired,
                "active_slots": self.active_slots(),
                "pages_in_use": self.alloc.in_use,
                "pages_peak": self.alloc.peak_in_use,
                "sparse_reads": self.sparse_reads,
                "kv_read_bytes_per_token":
                    self.kv_read_bytes[self.sparse_reads],
                "kv_read_bytes_per_token_dense_reads":
                    self.kv_read_bytes[False]}
