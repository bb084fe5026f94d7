"""Ragged paged-decode attention over the KV page pool (kernel K4).

Port of ``dalle_pytorch_tpu/ops/paged_attention.py::paged_decode_attention``
(Pallas kernel ``_kernel``, ``:88``). ``paged_decode_attention`` launches
the hand-written CUDA kernel ``csrc/paged_attention.cu`` on a CUDA
tensor and runs ``paged_decode_attention_plain``, the same function in
plain PyTorch, only for tensors that lie on the CPU (the tests' path).
There is no fallback: on the card the kernel launches or the call
raises. The kernel splits each slot's walk into runs of
``pages_per_split`` pages (``SPLIT_ROWS`` rows), one block each, and
merges the runs' partials in the same launch; ``combine_partials`` is
that merge in plain PyTorch, for the tests.

The contract both implement, taken from the TPU kernel:

* q ``(b, heads, dh)`` in the param dtype, any dh >= 1 on the card (dh
  up to ``NARROW_MAX_DIM_HEAD`` on the narrow bodies, wider heads on the
  wide body, one slice of ``WIDE_SLICE`` acc columns a block); one
  layer's pools
  ``(P, heads, page_size, dh)`` in float32 or bfloat16 — or int8 with
  ``(P, heads, page_size)`` float32 ``k_scales``/``v_scales``;
  ``block_tables (b, max_pages)`` int32, ``pos (b,)`` int32 and
  ``allowed (b, L)`` bool (the caller's full row mask, True = attend);
* returns float32 ``acc (b, heads, dh)``, ``m (b, heads)``,
  ``l (b, heads)``: the unnormalised exp-weighted V sum, the running max
  and the exp sum over the cached rows;
* slot i walks ``ceil(pos[i] / page_size)`` pages — a slot at pos 0
  walks none, so the trash page is never read, and returns
  ``(0, FILL, 0)``; masked walked rows score exactly ``FILL`` (finite),
  so a masked prefix is wiped once a live row arrives; int8 scales
  apply outside the dot products; scores and sums are float32;
* with ``visible`` (b, W) and ``visible_cnt`` (b,) — the visible walk of
  a sparse layer (``sparse_reads``) — slot i walks only the logical
  pages ``visible[i, :visible_cnt[i]]`` (ascending; the caller passes
  the token-causal count, so no listed page starts at or past pos).
  Every skipped page is fully masked in ``allowed``, so the partials
  equal the prefix walk's up to summation order. The two walks count
  their launches apart: ``paged_decode_attention.launches`` and
  ``paged_decode_attention.visible_launches``.

``kv_row_bytes`` is the one byte model of a walked row: the K and V
bytes of one cached row of one head, with its int8 scales. Both
``modeled_kv_read_bytes_per_token`` (JAX ``:348-405``; K/V reads per
decoded token, dense or sparse reads) and the walks' byte bounds in
``chip_smoke.py`` count rows with it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.ops import build
# dh 16, 32, 64 and 128 run their own bodies, any other dh up to 128 the
# next of those, reading rows at stride dh; a wider dh the wide body
from dalle_pytorch_tpu_torch.ops.flash_attention import NARROW_MAX_DIM_HEAD

FILL = -torch.finfo(torch.float32).max
# dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _validate(q, k_pages, v_pages, block_tables, pos, allowed, k_scales,
              v_scales, visible=None, visible_cnt=None):
    from dalle_pytorch_tpu_torch.serve import kv_pool as KV
    b, heads, dh = q.shape
    P, heads_p, page_size, dh_p = k_pages.shape
    KV.validate_page_size(page_size)
    if (heads_p, dh_p) != (heads, dh) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if (k_scales is not None) != (k_pages.dtype == torch.int8):
        raise ValueError("int8 pages need k_scales/v_scales, and only "
                         "int8 pages take them")
    max_pages = block_tables.shape[1]
    if block_tables.shape[0] != b or pos.shape != (b,) \
            or allowed.shape[0] != b:
        raise ValueError("block_tables, pos and allowed need one row per "
                         "slot of q")
    if max_pages * page_size < allowed.shape[1]:
        raise ValueError(
            f"block tables map {max_pages} pages of {page_size} rows < "
            f"allowed length {allowed.shape[1]}")
    if (visible is None) != (visible_cnt is None):
        raise ValueError("visible and visible_cnt come together: the "
                         "visible-page list is meaningless without its "
                         "per-slot live count (and vice versa)")
    if visible is not None:
        if visible.dim() != 2 or visible.shape[0] != b \
                or visible_cnt.shape != (b,):
            raise ValueError(f"visible must be (b, W) and visible_cnt (b,) "
                             f"for b = {b}, got {tuple(visible.shape)} and "
                             f"{tuple(visible_cnt.shape)}")
        if visible.shape[1] > max_pages:
            raise ValueError(
                f"visible lists {visible.shape[1]} pages per slot > the "
                f"{max_pages}-column block tables they index")


def paged_decode_attention_plain(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, pos: torch.Tensor,
        allowed: torch.Tensor, *, scale: float,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        visible: Optional[torch.Tensor] = None,
        visible_cnt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one-shot instead of
    online: gather the pages a slot may walk (every mapped page, or only
    the listed ones given ``visible``), score, and reduce — with rows
    past the walk left out entirely and masked walked rows at FILL,
    which gives the online recurrence's (acc, m, l) exactly, up to
    summation order."""
    _validate(q, k_pages, v_pages, block_tables, pos, allowed, k_scales,
              v_scales, visible, visible_cnt)
    b, heads, dh = q.shape
    page_size = k_pages.shape[2]
    dev = q.device
    if visible is None:
        tables = block_tables.long()                     # (b, w)
        w = tables.shape[1]
        logical = torch.arange(w, device=dev)[None, :].expand(b, w)
        trips = (pos.long() + page_size - 1) // page_size
    else:
        logical = visible.long()
        w = logical.shape[1]
        tables = torch.take_along_dim(block_tables.long(), logical, dim=1)
        trips = visible_cnt.long()

    def rows(buf):            # (P, heads, ps[, dh]) -> (b, heads, w*ps[, dh])
        g = buf[tables].transpose(1, 2)          # (b, heads, w, ps[, dh])
        return g.reshape(b, heads, w * page_size, *g.shape[4:])

    # logical row of each gathered column, and whether its trip is walked
    col = (logical[:, :, None] * page_size
           + torch.arange(page_size, device=dev)).reshape(b, w * page_size)
    walked = (torch.arange(w, device=dev)[None, :] < trips[:, None]) \
        .repeat_interleave(page_size, dim=1)[:, None]
    L = allowed.shape[1]
    ok = torch.gather(allowed.bool(), 1, col.clamp(max=L - 1)) & (col < L)
    s = torch.einsum("bhd,bhjd->bhj", q.float(), rows(k_pages).float())
    s = s * scale
    if k_scales is not None:
        s = s * rows(k_scales)
    s = torch.where(ok[:, None], s, FILL)
    s = torch.where(walked, s, float("-inf"))
    m = torch.clamp(s.amax(dim=-1), min=FILL)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if v_scales is not None:
        p = p * rows(v_scales)
    v = torch.where(walked[..., None], rows(v_pages).float(), 0.0)
    acc = torch.einsum("bhj,bhjd->bhd", p, v)
    return acc, m, l


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the partials of splits of one walk, stacked on a leading
    split axis (acc ``(S, b, heads, dh)``, m and l ``(S, b, heads)``),
    into the partials of the whole walk: the two-estimate rescale the
    kernel's combine applies. A split that walked nothing holds
    ``(0, FILL, 0)`` and adds nothing; all-masked splits keep weight 1
    per row unless a live row elsewhere raises the max, which wipes
    them, as the unsplit recurrence does."""
    big = torch.clamp(m.amax(dim=0), min=FILL)
    f = torch.exp(m - big)
    return (acc * f[..., None]).sum(dim=0), big, (l * f).sum(dim=0)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# rows of the walk one block of the kernel takes (a split): 16 pages of 16
SPLIT_ROWS = 256
# acc columns one block of the wide body (dh > 128) owns
WIDE_SLICE = 128
_COUNTERS = {}           # device -> the kernel's zeroed split counters


def pages_per_split(page_size: int) -> int:
    """Trips of a walk one block of the kernel takes."""
    return max(1, SPLIT_ROWS // page_size)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, kept for every launch:
    the kernel's last block of a (slot, head) sets its counter back to
    zero, so launches ordered on one stream can share them."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("paged_attention").paged_decode_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        block_tables: torch.Tensor, pos: torch.Tensor,
        allowed: torch.Tensor, *, scale: float,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        visible: Optional[torch.Tensor] = None,
        visible_cnt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax partials over one layer's paged K/V, on the prefix
    walk or, given ``visible``/``visible_cnt``, the visible walk: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Counts its launches in ``paged_decode_attention.launches`` (prefix)
    and ``paged_decode_attention.visible_launches`` (visible)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, pos, allowed, scale=scale,
            k_scales=k_scales, v_scales=v_scales, visible=visible,
            visible_cnt=visible_cnt)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _validate(q, k_pages, v_pages, block_tables, pos, allowed, k_scales,
              v_scales, visible, visible_cnt)
    b, heads, dh = q.shape
    page_size = k_pages.shape[2]
    if dh < 1:
        raise ValueError(f"dim_head {dh}: the kernel takes any dim_head of "
                         f"1 or more")
    q_code = _DTYPE_CODE.get(q.dtype)
    kv_code = _DTYPE_CODE.get(k_pages.dtype)
    if q_code not in (0, 1) or kv_code is None \
            or (kv_code != 2 and kv_code != q_code):
        raise ValueError(f"unsupported dtypes: q {q.dtype}, pages "
                         f"{k_pages.dtype} (pages match q, or are int8)")
    tensors = [q, k_pages, v_pages, block_tables, pos, allowed]
    if k_scales is not None:
        tensors += [k_scales, v_scales]
    if visible is not None:
        tensors += [visible, visible_cnt]
    if any(t.device != q.device for t in tensors):
        raise ValueError("every input must lie on q's device")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bt = block_tables.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    ok = allowed.to(torch.bool).contiguous()
    ksc = vsc = vis = cnt = None
    if k_scales is not None:
        ksc = k_scales.to(torch.float32).contiguous()
        vsc = v_scales.to(torch.float32).contiguous()
    if visible is not None:
        vis = visible.to(torch.int32).contiguous()
        cnt = visible_cnt.to(torch.int32).contiguous()
    # the kernel stages 8-row runs of pages and scales by 16-byte copies
    # (8-byte ones for a run whose length is not a multiple of 16)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scales", ksc), ("v_scales", vsc)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    acc = torch.empty((b, heads, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((b, heads), dtype=torch.float32, device=q.device)
    l = torch.empty((b, heads), dtype=torch.float32, device=q.device)
    # the walk's splits, from the tables' width (never from pos: no sync)
    pps = pages_per_split(page_size)
    walk = bt.shape[1] if vis is None else vis.shape[1]
    splits = -(-walk // pps)
    part = counters = None
    if splits > 1:
        if dh > NARROW_MAX_DIM_HEAD:        # the wide body's slices
            slices = -(-dh // WIDE_SLICE)
            part = torch.empty((b, heads, slices, splits, WIDE_SLICE + 2),
                               dtype=torch.float32, device=q.device)
            counters = _counters(q.device, b * heads * slices)
        else:
            part = torch.empty((b, heads, splits, dh + 2),
                               dtype=torch.float32, device=q.device)
            counters = _counters(q.device, b * heads)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ksc is None else ksc.data_ptr(),
        None if vsc is None else vsc.data_ptr(),
        bt.data_ptr(), pos32.data_ptr(), ok.data_ptr(),
        None if vis is None else vis.data_ptr(),
        None if cnt is None else cnt.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, heads, dh, page_size, bt.shape[1], ok.shape[1],
        0 if vis is None else vis.shape[1], pps, float(scale),
        q_code, kv_code, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"with CUDA error {rc}")
    if vis is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.visible_launches += 1
    return acc, m, l


paged_decode_attention.launches = 0
paged_decode_attention.visible_launches = 0


def kv_row_bytes(dim_head: int, itemsize: int,
                 quantized: bool = False) -> int:
    """Bytes a walk reads for one cached row of one head: its K and V
    vectors, plus one f32 scale each for int8 pages."""
    return 2 * dim_head * itemsize + (2 * 4 if quantized else 0)


def modeled_kv_read_bytes_per_token(*, depth: int, heads: int,
                                    dim_head: int, total_len: int,
                                    page_size: int, prompt_len: int,
                                    itemsize: int, impl: str,
                                    quantized: bool = False,
                                    sparse_reads: bool = False,
                                    sparse_pattern=None,
                                    sparse_block: int = 16,
                                    causal: bool = True) -> float:
    """K/V bytes read per decoded token for one slot, averaged over the
    decode span ``[prompt_len, total_len)``, K and V both counted (plus
    one f32 scale per row each for int8 pages). ``impl='gather'`` reads
    the full ``total_len`` view every step, ``'kernel'`` the
    ``ceil(pos / page_size)`` mapped pages. With ``sparse_reads`` (and
    the per-layer ``sparse_pattern``) sparse layers read only their
    visible pages: the kernel its token-causal visible count per
    position, the gather the fixed visible width ``W``."""
    row = kv_row_bytes(dim_head, itemsize, quantized)
    span = range(int(prompt_len), int(total_len))
    if impl == "gather":
        rows = float(total_len)
    elif impl == "kernel":
        rows = (sum(-(-p // page_size) for p in span)   # ceil(pos/ps)
                * page_size / max(len(span), 1))
    else:
        raise ValueError(f"impl must be 'gather' or 'kernel', got "
                         f"{impl!r}")
    if not sparse_reads:
        return depth * heads * rows * row
    if sparse_pattern is None or len(sparse_pattern) != depth:
        raise ValueError("sparse_reads=True needs the per-layer "
                         "sparse_pattern (length == depth) to split "
                         "dense from sparse layer reads")
    from dalle_pytorch_tpu_torch.ops import sparse as sparse_ops
    vis, _cnt, cnt_causal = sparse_ops.visible_pages_causal(
        total_len, page_size, sparse_block, causal=causal)
    if impl == "gather":
        rows_sparse = float(vis.shape[1] * page_size)
    else:
        rows_sparse = (sum(int(cnt_causal[p]) for p in span)
                       * page_size / max(len(span), 1))
    n_sparse = sum(bool(s) for s in sparse_pattern)
    return heads * row * ((depth - n_sparse) * rows
                          + n_sparse * rows_sparse)
