"""Paged KV cache: the device page pool and the host page allocator.

Port of ``dalle_pytorch_tpu/serve/kv_pool.py``: ``pages_for``
(``:141``), ``init_page_pool`` (``:146``), the kernel's page-size gate
``validate_page_size`` with ``PageSizeError`` (``:74-106``),
``visible_table_view`` (``:165``), the page copy pair of the prefix
cache's copy-on-write fork ``snapshot_page`` / ``restore_page``
(``:180-198``), ``modeled_kv_bytes`` (``:207``: a process replica's
pool lives in another interpreter) and the refcounted ``PageAllocator``
(``:232``).

The device side is a pool ``(depth, num_pages, heads, page_size,
dim_head)`` per K and V (int8 plus per-row float32 scale pages when
quantized); per-slot block tables map logical page j to a physical page.
Physical page 0 is the TRASH page: dead slots park their writes there
and unmapped table entries point at it, so the allocator never hands it
out and the kernel never reads it (a slot at pos 0 walks no pages).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from dalle_pytorch_tpu_torch.ops.decode import HeadShards

TRASH_PAGE = 0

# the paged-attention kernel walks pages in tiles of 8 or more rows
# (csrc/paged_attention.cu), and the JAX kernel it ports stages a page
# as one f32 sublane tile: pages hold a multiple of 8 rows, at least 8
KERNEL_MIN_PAGE_SIZE = 8
KERNEL_PAGE_MULTIPLE = 8


def structured_event(kind: str, **fields) -> dict:
    """The structured record typed errors carry (the JAX package's
    ``utils.metrics.structured_event`` shape)."""
    return {"time": time.time(), "event": "resilience", "kind": kind,
            **fields}


class PageSizeError(ValueError):
    """Typed page-size rejection at pool init: ``page_size`` cannot feed
    the paged-attention kernel. ``record`` is the structured event."""

    def __init__(self, record: dict):
        super().__init__(
            f"page_size={record.get('page_size')} cannot feed the paged-"
            f"attention kernel: page_size must be >= "
            f"{record.get('min_page_size')} and a multiple of "
            f"{record.get('page_multiple')}")
        self.record = record


def validate_page_size(page_size: int) -> None:
    ps = int(page_size)
    if ps < KERNEL_MIN_PAGE_SIZE or ps % KERNEL_PAGE_MULTIPLE:
        raise PageSizeError(structured_event(
            "serve_page_size_invalid", page_size=ps,
            min_page_size=KERNEL_MIN_PAGE_SIZE,
            page_multiple=KERNEL_PAGE_MULTIPLE))


class PageReleaseUnderflow(ValueError):
    """A release of a page whose refcount is already zero — freeing it
    again would let two live slots share it. ``record`` is the event."""

    def __init__(self, record: dict):
        super().__init__(
            f"double release of page {record.get('page')}: its refcount "
            f"is already 0")
        self.record = record


class PagePoolExhausted(RuntimeError):
    """An allocation the free list cannot serve. ``record`` carries the
    shortfall."""

    def __init__(self, record: dict):
        super().__init__(
            f"page pool exhausted: need {record.get('pages_needed')}, "
            f"free {record.get('pages_free')} of "
            f"{record.get('pages_capacity')}")
        self.record = record


def pages_for(rows: int, page_size: int) -> int:
    """Pages needed to hold ``rows`` KV rows (ceil division)."""
    return -(-rows // page_size)


def init_page_pool(cfg, num_pages: int, page_size: int, *,
                   dtype=torch.float32, quantized: bool = False,
                   device=None) -> Dict[str, torch.Tensor]:
    """Zeroed page pool on ``device``: ``{"k", "v"}`` of ``(depth,
    num_pages, heads, page_size, dim_head)``, plus ``k_scale``/``v_scale``
    of ``(depth, num_pages, heads, page_size)`` float32 when quantized
    (the int8 rows' per-row scales)."""
    shape = (cfg.depth, num_pages, cfg.heads, page_size, cfg.dim_head)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def visible_table_view(block_tables: torch.Tensor,
                       visible: torch.Tensor) -> torch.Tensor:
    """Visibility-trimmed block tables: row i lists the PHYSICAL pages
    behind slot i's visible logical pages ``visible`` (b, W), the
    per-position list ``ops.sparse.visible_pages`` precomputes, taken at
    each slot's position. Entries past the visible count map whatever
    the padding entries map (logical page 0): consumers mask those
    columns — the view narrows the read, the mask decides attendance."""
    return torch.take_along_dim(block_tables, visible.long(), dim=1)


def snapshot_page(pool: Dict[str, torch.Tensor],
                  page: int) -> Dict[str, torch.Tensor]:
    """A copy of ONE physical page across every layer (and the int8
    pool's scale pages): ``{k: (depth, heads, page_size[, dh])}`` — the
    prefix cache's copy-on-write source, taken before the inserting
    request's decode can write past its prompt into the same page. A
    mesh's ``HeadShards`` pool gives the page whole: its shards' heads
    joined on the first device."""
    if isinstance(pool, HeadShards):
        per = [snapshot_page(part, page) for part in pool.parts]
        return {k: pool.join([snap[k] for snap in per]) for k in per[0]}
    return {k: buf[:, page].clone() for k, buf in pool.items()}


def restore_page(pool: Dict[str, torch.Tensor], page: int,
                 snap: Dict[str, torch.Tensor]) -> None:
    """Write a ``snapshot_page`` copy into physical page ``page``, in
    place — the copy-on-write FORK of a warm hit's boundary page (each
    shard of a ``HeadShards`` pool its heads, on its device)."""
    if isinstance(pool, HeadShards):
        for part, hs, dev in pool.slices():
            restore_page(part, page, {k: v[:, hs].to(dev)
                                      for k, v in snap.items()})
        return
    for k, buf in pool.items():
        buf[:, page] = snap[k]


def modeled_kv_bytes(cfg, *, kv: str, num_slots: int, total_len: int,
                     page_size: int = 0, num_pages: int = 0,
                     quantized: bool = False, dtype_bytes: int = 4) -> int:
    """KV-store bytes from the config alone (the engine's defaults:
    ``page_size`` 0 -> min(16, total_len), ``num_pages`` 0 -> fully
    provisioned); int8 rows count one byte an element plus one float32
    scale a row."""
    depth, heads, dh = cfg.depth, cfg.heads, cfg.dim_head
    if kv == "paged":
        ps = int(page_size) or min(16, total_len)
        pages = int(num_pages) or num_slots * pages_for(total_len, ps) + 1
        rows = pages * ps
    else:
        rows = num_slots * total_len
    per_row = (1 + 4 / dh) if quantized else dtype_bytes
    return int(2 * depth * heads * rows * dh * per_row)


class PageAllocator:
    """Host-side free list over physical pages ``[1, num_pages)``,
    refcounted: ``alloc`` hands pages out at refcount 1 (lowest id
    first, so placement is deterministic), ``retain`` adds a reference
    to a live page, and ``release`` returns a page to the free list only
    when its last reference drops. Single-threaded: the engine owns it
    under its step lock."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (one trash page + at least one "
                f"allocatable), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - 1          # trash page excluded

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free

    # the two gauges below are read by stats() on other threads: they
    # sum a snapshot of the refcounts, taken in one step

    @property
    def pages_shared(self) -> int:
        """Live pages with more than one owner."""
        return sum(1 for r in list(self._refs.values()) if r >= 2)

    @property
    def refs_saved(self) -> int:
        """Pages sharing saves now: the sum of (refcount - 1)."""
        return sum(r - 1 for r in list(self._refs.values()))

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def alloc(self, n: int) -> List[int]:
        if n > self.free:
            raise PagePoolExhausted(structured_event(
                "serve_page_exhausted", pages_needed=int(n),
                pages_free=self.free, pages_in_use=self.in_use,
                pages_capacity=self.capacity))
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def _check(self, p: int) -> int:
        p = int(p)
        if not 1 <= p < self.num_pages:
            raise ValueError(f"page id {p} was never allocatable")
        return p

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            p = self._check(p)
            if p not in self._refs:
                raise ValueError(f"retain of free page {p}: only a live "
                                 f"page can gain a reference")
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            p = self._check(p)
            if self._refs.get(p, 0) <= 0:
                raise PageReleaseUnderflow(structured_event(
                    "serve_page_release_underflow", page=p,
                    pages_free=self.free, pages_in_use=self.in_use))
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
