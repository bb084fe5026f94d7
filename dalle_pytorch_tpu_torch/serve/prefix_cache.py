"""Cross-request prefix cache: content-addressed, refcounted prompt KV.

Port of ``dalle_pytorch_tpu/serve/prefix_cache.py`` (the whole module:
``layer_signature`` ``:48``, ``prefix_key`` ``:57``, ``content_key``
``:69``, ``PrefixEntry`` ``:85``, ``PrefixIndex`` ``:107``), over the
port's refcounted ``serve/kv_pool.py::PageAllocator``. A prefix ENTRY,
keyed by (model version, prompt tokens, layer-set signature, cache
dtype), holds:

  * a reference on each of the prompt's FULL pages (wholly below the
    prompt length ``t0``): read-only by construction, since decode only
    appends at positions >= t0 — a warm hit maps them into the new
    slot's block table (refcount + 1, no prefill, no new pages);
  * a copy of the partial boundary page (when ``t0 % page_size``), the
    copy-on-write source a warm hit forks into one private page;
  * the prompt's last hidden row ``h_last`` (dim,), which the first
    token samples from.

Entries are LRU; the engine ``shrink``s the index under page pressure
before it evicts a live request. The exact token tuple is kept as the
collision check (the hash addresses, the tokens verify). Entries hold
tensors the engine made; this module touches none of them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple


def layer_signature(cfg) -> Tuple:
    """The layer-set half of the prefix key: everything about the stack
    that decides WHAT a cached prompt row contains. Two engines sharing
    a pool layout but differing in any of these must never share KV."""
    return (int(cfg.depth), int(cfg.heads), int(cfg.dim_head),
            bool(cfg.reversible), tuple(bool(s) for s in
                                        cfg.sparse_pattern))


def prefix_key(codes: Sequence[int], *, model_version: str,
               layer_sig: Tuple, quantized: bool) -> str:
    """Content address of one prompt's KV: sha256 over (model version,
    layer-set signature, cache dtype class, the exact token ids)."""
    h = hashlib.sha256()
    h.update(repr((str(model_version), layer_sig,
                   bool(quantized))).encode())
    h.update(b"|")
    h.update(",".join(str(int(c)) for c in codes).encode())
    return h.hexdigest()


def content_key(codes: Sequence[int], *, cfg, model_version: str,
                quantized: bool = False) -> str:
    """The prompt's content address computed FROM the model config —
    the gateway's routing key. This is the SAME key an engine with this
    (cfg, model_version, dtype) computes at admission, which is the
    whole point of prefix-affinity routing: the rendezvous hash over
    this key sends a repeated prompt to the cell whose PrefixIndex
    already holds the entry it names. Accepts either the transformer
    config or a DALLEConfig wrapping one (the engine signs
    ``cfg.transformer``)."""
    return prefix_key(codes, model_version=model_version,
                      layer_sig=layer_signature(
                          getattr(cfg, "transformer", cfg)),
                      quantized=quantized)


class PrefixEntry:
    """One cached prompt span. ``full_pages`` are the physical ids of
    the pages wholly below ``t0`` (the index holds one reference on
    each); ``boundary_snap`` is the device snapshot of the partial
    boundary page (None when ``t0 % page_size == 0``); ``h_last`` is
    the (dim,) hidden row the first token samples from."""

    __slots__ = ("key", "codes", "t0", "full_pages", "boundary_snap",
                 "h_last", "hits")

    def __init__(self, key: str, codes: Tuple[int, ...], t0: int,
                 full_pages: List[int], boundary_snap: Optional[dict],
                 h_last):
        self.key = key
        self.codes = tuple(int(c) for c in codes)
        self.t0 = int(t0)
        self.full_pages = list(full_pages)
        self.boundary_snap = boundary_snap
        self.h_last = h_last
        self.hits = 0


class PrefixIndex:
    """LRU map ``prefix_key -> PrefixEntry`` over one engine's page
    pool. The index RETAINS every entry's full pages (the allocator's
    refcounts are what make 'freed only at zero' true when a consumer
    and the cache both map a page), and releases them when an entry is
    evicted — by capacity, by an explicit ``shrink`` under page
    pressure, or by ``clear`` (weight hot-swap)."""

    def __init__(self, alloc, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got "
                             f"{max_entries}")
        self.alloc = alloc
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def pages_held(self) -> int:
        """References the index currently holds (full pages across all
        entries) — NOT extra HBM: shared pages are physical once."""
        # a snapshot: stats() reads this from other threads
        return sum(len(e.full_pages) for e in list(self._entries.values()))

    def lookup(self, key: str,
               codes: Sequence[int]) -> Optional[PrefixEntry]:
        """The warm-hit probe. The hash addresses, the stored tokens
        VERIFY — a colliding key must read as a miss, never as another
        prompt's KV."""
        e = self._entries.get(key)
        if e is None or e.codes != tuple(int(c) for c in codes):
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        e.hits += 1
        self.hits += 1
        return e

    def insert(self, entry: PrefixEntry) -> None:
        """Index a freshly prefilled prompt span: retain its full pages
        (the cache's own reference) and make it MRU. Inserting over an
        existing key replaces the old entry (releases its holds)."""
        if entry.key in self._entries:
            self._evict(entry.key)
        self.alloc.retain(entry.full_pages)
        self._entries[entry.key] = entry
        self._entries.move_to_end(entry.key)
        self.inserted += 1
        while len(self._entries) > self.max_entries:
            self._evict(next(iter(self._entries)))

    def _evict(self, key: str) -> None:
        e = self._entries.pop(key)
        self.alloc.release(e.full_pages)
        self.evicted += 1

    def shrink(self, pages_needed: int) -> int:
        """Release LRU entries until the allocator's free list could
        satisfy ``pages_needed`` (or the index is empty) — the engine
        calls this BEFORE evicting a live request. Returns entries
        dropped. Releasing an entry frees only pages no live slot
        still maps (refcounts), so this can under-deliver: the caller
        re-checks ``alloc.free`` and falls back to request eviction."""
        dropped = 0
        while self._entries and self.alloc.free < pages_needed:
            self._evict(next(iter(self._entries)))
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Drop every entry (weight hot-swap / engine teardown)."""
        n = len(self._entries)
        for key in list(self._entries):
            self._evict(key)
        return n

    def stats(self) -> dict:
        return {
            "prefix_entries": len(self._entries),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_inserted": self.inserted,
            "prefix_evicted": self.evicted,
            "prefix_pages_held": self.pages_held,
        }
