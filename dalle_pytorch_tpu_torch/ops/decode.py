"""Incremental decoding: prefill, the dense-cache and the paged
single-token decode steps.

Port of ``dalle_pytorch_tpu/ops/decode.py``:

* ``_quantize_rows`` (``:73``) — symmetric per-row int8 for the int8
  caches;
* ``init_cache`` (``:46``), ``_store_rows`` (``:82``, with
  ``_store_rows_per_slot``) and ``_full_key_mask`` (``:143``) — the
  dense (depth, b, heads, total_len, dh) cache of one-shot generation,
  int8 rows with per-row f32 scales under ``quantized``;
* ``prefill`` (``:274``) — the prompt through the sequential stack in one
  batched pass, with ``_attn_with_kv``'s explicit matmul and finite-fill
  softmax (no fused attention call: the reference fill must hold); with
  ``prompt_mask`` pad pairs are left out, and with ``total_len`` it
  returns the dense cache, as JAX does, else the prompt's rows (the
  engine's call);
* ``decode_step`` (``:375``) — one token per row against the dense
  cache: ``_decode_step_math`` through the gather read (the cached rows
  plus self under one softmax, the finite ``-finfo.max`` fill), then
  ``_store_rows``;
* ``_kernel_read`` (``:183``) — kernel K4's partials merged with the
  current token's self-logit;
* ``_decode_step_math`` (``:391-517``) — one step's attention over the
  cached rows plus self, WITHOUT the cache write;
* ``_store_rows_paged`` (``:760``), ``decode_step_paged`` (``:799``) and
  ``decode_loop_paged`` (``:833``) — the write-back into the page pool
  and the K-step loop that fills a device-side ``(slots, K)`` emit ring;
* ``paged_view`` (``:720``) and ``_gather_read`` (``:216``), the dense-view
  oracle the kernel is held against (tests and ``chip_smoke.py``);
* block-sparse layers: ``_sparse_layout`` (``:154``) in ``prefill`` and in
  the step's per-slot ``sparse_allowed`` (``:434-472``), so a sparse
  model computes the model it was trained as; and the sparse reads,
  ``_decode_step_math_sparse_reads`` (``:520-692``): each sparse layer
  reads only its statically visible pages (``_sparse_page_visibility``,
  ``:166``) — through K4's visible walk in ``'kernel'`` mode, or through
  the trimmed ``kv_pool.visible_table_view`` in ``'gather'`` mode, the
  oracle — while dense layers read as before. Skipped pages carry
  exactly zero weight, so the tokens do not change.

Where JAX returns a new cache or pool from each step, the port updates
the dense cache and the page pool IN PLACE (``index_put_``): they are the
largest buffers on the card, and a copy per step would move them once
per token for nothing. Reads of a step never see its own write, because
the write happens after every layer has read, the gather read masks
rows at and past each row's pos, and the kernel reads only rows below
it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.ops import sparse
from dalle_pytorch_tpu_torch.ops import transformer as T

Pool = Dict[str, torch.Tensor]


def _quantize_rows(x: torch.Tensor):
    """(..., dh) -> (int8 rows, (...,) float32 scales), symmetric per row."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _rows(ks: torch.Tensor, vs: torch.Tensor, quantize: bool) -> Pool:
    if not quantize:
        return {"k": ks, "v": vs}
    kq, ksc = _quantize_rows(ks)
    vq, vsc = _quantize_rows(vs)
    return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}


def init_cache(cfg: T.TransformerConfig, batch: int, total_len: int,
               dtype=torch.float32, quantized: bool = False,
               device=None) -> Pool:
    """Zeroed dense K/V buffers (depth, batch, heads, total_len, dh) in
    ``dtype`` — or int8 with (depth, batch, heads, total_len) float32
    scales when ``quantized``."""
    shape = (cfg.depth, batch, cfg.heads, total_len, cfg.dim_head)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _store_rows(cache: Pool, ks: torch.Tensor, vs: torch.Tensor,
                pos) -> None:
    """Write K/V rows (depth, b, heads, rows, dh) into the dense cache
    from position ``pos`` on, in place, quantizing iff the cache is int8
    (the one write for prefill and ``decode_step``). ``pos`` may be a
    (b,) tensor of per-row positions (single rows, ``_store_rows_per_
    slot``): row i writes cache row ``pos[i]`` of its own batch entry."""
    rows = _rows(ks, vs, "k_scale" in cache)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        bidx = torch.arange(pos.shape[0], device=pos.device)
        for name, buf in cache.items():
            # advanced indices at dims 1 and 3 are apart, so the value is
            # (b, depth, heads[, dh])
            buf[:, bidx, :, pos.long()] = rows[name][:, :, :, 0] \
                .transpose(0, 1).to(buf.dtype)
        return
    n = ks.shape[3]
    for name, buf in cache.items():
        buf[:, :, :, pos:pos + n] = rows[name].to(buf.dtype)


def _full_key_mask(prompt_mask: Optional[torch.Tensor], batch: int,
                   prompt_len: int, total_len: int,
                   device=None) -> torch.Tensor:
    """(batch, total_len) bool: the prompt's pad mask over [0, t0), True
    beyond (every generated position is kept)."""
    full = torch.ones((batch, total_len), dtype=torch.bool, device=device)
    if prompt_mask is not None:
        full[:, :prompt_len] = prompt_mask.bool()
    return full


@functools.lru_cache(maxsize=16)
def _sparse_layout(cfg: T.TransformerConfig, total_len: int,
                   device: torch.device) -> torch.Tensor:
    """(total_len, total_len) token-level allowed mask of the sparse
    layers, on ``device``. Cached: the decode loop takes its rows every
    step, and a host-to-card copy there would stall it."""
    padded = -(-total_len // cfg.sparse_block) * cfg.sparse_block
    layout = sparse.token_layout_mask(padded, cfg.sparse_block,
                                      causal=cfg.causal)
    return torch.from_numpy(np.ascontiguousarray(
        layout[:total_len, :total_len])).to(device)


@functools.lru_cache(maxsize=16)
def _sparse_page_visibility(cfg: T.TransformerConfig, total_len: int,
                            page_size: int, device: torch.device):
    """``(vis (L, W), cnt (L,), cnt_causal (L,))`` int32 on ``device``:
    row p's visible page ids ascending with ``cnt[p]`` live entries, and
    the decode trip count ``cnt_causal[p]`` (``sparse.visible_pages_
    causal``, the one source). Cached like ``_sparse_layout``."""
    tables = sparse.visible_pages_causal(total_len, page_size,
                                         cfg.sparse_block, causal=cfg.causal)
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in tables)


def check_sparse_reads(cfg: T.TransformerConfig) -> None:
    """Raises ValueError unless sparse reads fit ``cfg``: it has sparse
    layers (else the flag is a silent no-op) in a periodic pattern (the
    JAX step resolves the read shapes from one period)."""
    pattern = cfg.sparse_pattern
    if not any(pattern):
        raise ValueError(
            "sparse_reads on a config with no sparse layers would be a "
            "silent no-op (every layer reads the full prefix either way) "
            "— drop the flag")
    period = T._pattern_period(pattern)
    if period > T._MAX_UNROLL_PERIOD:
        raise ValueError(
            f"sparse_reads needs a periodic dense/sparse pattern (period "
            f"<= {T._MAX_UNROLL_PERIOD}); pattern {pattern} has period "
            f"{period}")


def _attn_with_kv(layer: T.Layer, h: torch.Tensor, allowed: torch.Tensor,
                  cfg: T.TransformerConfig):
    """PreNorm attention over an explicit allowed-mask; returns out, k, v.
    h: (b, n, dim); allowed broadcastable to (b, 1, n, n)."""
    p = layer.attn
    q, k, v = attn_ops.qkv_project(p, core.layernorm(p.ln, h), cfg.heads)
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * cfg.scale
    dots = dots.masked_fill(~allowed, core.neg_inf(dots.dtype))
    out = torch.einsum("bhij,bhjd->bhid", torch.softmax(dots, dim=-1), v)
    return attn_ops.output_tail(p, out), k, v


def prefill(model: T.Transformer, x: torch.Tensor, *,
            cfg: T.TransformerConfig, quantize_cache: bool = False,
            prompt_mask: Optional[torch.Tensor] = None,
            total_len: Optional[int] = None) -> Tuple[torch.Tensor, Pool]:
    """Run the prompt embeddings x (b, t0, dim) through the stack;
    ``prompt_mask`` (b, t0) leaves pad pairs out (query and key).

    Returns (h_out (b, t0, dim), K/V): with ``total_len``, JAX's dense
    cache (``init_cache``) with rows [0, t0) filled; without it (the
    engine's call, which scatters them into its pages) the prompt's rows
    ``{"k", "v"}`` of (depth, b, heads, t0, dh). Either is int8 plus
    float32 scales under ``quantize_cache``."""
    b, t0 = x.shape[:2]
    dense_allowed = torch.ones((t0, t0), dtype=torch.bool,
                               device=x.device).tril()[None, None]
    if prompt_mask is not None:
        pm = prompt_mask.bool()
        dense_allowed = dense_allowed & (pm[:, None, :, None]
                                         & pm[:, None, None, :])
    sparse_allowed = dense_allowed
    if any(cfg.sparse_pattern):
        # the layout's rows and columns [0, t0) are those of the full
        # sequence's layout: it depends on positions only
        sparse_allowed = dense_allowed & _sparse_layout(cfg, t0, x.device)
    ks, vs = [], []
    h = x
    for layer, is_sparse in zip(model.layers, cfg.sparse_pattern):
        allowed = sparse_allowed if is_sparse else dense_allowed
        a, k, v = _attn_with_kv(layer, h, allowed, cfg)
        h = h + a
        h = h + T.ff_branch(layer, h)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if total_len is None:
        return h, _rows(ks, vs, quantize_cache)
    cache = init_cache(cfg, b, total_len, ks.dtype, quantize_cache,
                       x.device)
    _store_rows(cache, ks, vs, 0)
    return h, cache


def _kernel_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pool_k: torch.Tensor, pool_v: torch.Tensor,
                 block_tables: torch.Tensor, pos: torch.Tensor,
                 allowed: torch.Tensor, *, scale: float,
                 ksc: Optional[torch.Tensor] = None,
                 vsc: Optional[torch.Tensor] = None,
                 visible: Optional[torch.Tensor] = None,
                 visible_cnt: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Kernel K4's partials over the raw pool, completed with the current
    token's self-logit by the two-estimate softmax merge — exactly
    ``softmax(concat([scores, self]))`` up to summation order. q/k/v are
    (b, h, 1, dh); returns the (b, h, 1, dh) output before the out
    projection. ``visible``/``visible_cnt`` select K4's visible walk."""
    acc, m, l = PA.paged_decode_attention(
        q[:, :, 0, :].contiguous(), pool_k, pool_v, block_tables, pos,
        allowed, scale=scale, k_scales=ksc, v_scales=vsc, visible=visible,
        visible_cnt=visible_cnt)
    self_s = torch.einsum("bhqd,bhqd->bhq", q, k)[:, :, 0].float() * scale
    m_t = torch.maximum(m, self_s)          # self is finite: m_t too
    alpha = torch.exp(m - m_t)
    w_self = torch.exp(self_s - m_t)
    denom = l * alpha + w_self              # >= w_self > 0: no 0-div
    out = (acc * alpha[..., None]
           + w_self[..., None] * v[:, :, 0, :].float()) / denom[..., None]
    return out.to(q.dtype)[:, :, None, :]


def _gather_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, allowed: torch.Tensor,
                 *, scale: float, ksc: Optional[torch.Tensor] = None,
                 vsc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense-view oracle: one softmax over a (b, heads, L, dh) view
    of the cached rows plus the self-logit; int8 scales applied outside
    the contractions in the score dtype."""
    quantized = ksc is not None
    ckc = ck.to(q.dtype) if quantized else ck
    scores = torch.einsum("bhqd,bhjd->bhqj", q, ckc) * scale
    if quantized:
        scores = scores * ksc[:, :, None, :].to(scores.dtype)
    scores = scores.masked_fill(~allowed[:, None, None, :],
                                core.neg_inf(scores.dtype))
    self_score = torch.einsum("bhqd,bhqd->bhq", q, k)[..., None] * scale
    w = torch.softmax(torch.cat([scores, self_score], dim=-1), dim=-1)
    wj = w[..., :-1]
    if quantized:
        wj = wj * vsc[:, :, None, :].to(wj.dtype)
        cv = cv.to(q.dtype)
    return torch.einsum("bhqj,bhjd->bhqd", wj, cv) + w[..., -1:] * v


def paged_view(pool: Pool, block_tables: torch.Tensor,
               total_len: int) -> Pool:
    """Dense per-slot view of the pool (depth, P, heads, ps, dh) through
    block_tables (b, max_pages): (depth, b, heads, total_len, dh), row j
    from page ``block_tables[i, j // ps]`` at offset ``j % ps``. The
    table is trimmed to ``ceil(total_len / ps)`` columns first."""
    page_size = pool["k"].shape[3]
    bt = block_tables[:, :-(-total_len // page_size)].long()

    def gather(buf):           # (d, P, heads, ps[, dh])
        g = buf[:, bt].transpose(2, 3)       # (d, b, heads, mp, ps[, dh])
        g = g.reshape(*g.shape[:3], g.shape[3] * g.shape[4], *g.shape[5:])
        return g[:, :, :, :total_len]

    return {name: gather(buf) for name, buf in pool.items()}


def _step_masks(cfg: T.TransformerConfig, pos: torch.Tensor,
                key_mask: torch.Tensor):
    """(dense_allowed, sparse_allowed), each (b, total_len): the cached
    rows strictly before each slot's position (self enters as the extra
    logit) that are not padding, and of those, the ones a sparse layer's
    layout row allows."""
    j = torch.arange(key_mask.shape[1], device=pos.device)
    dense = (j[None, :] < pos[:, None]) & key_mask
    if not any(cfg.sparse_pattern):
        return dense, dense
    layout = _sparse_layout(cfg, key_mask.shape[1], pos.device)
    return dense, dense & layout[pos.long()]


def _run_layers(model: T.Transformer, x_tok: torch.Tensor,
                cfg: T.TransformerConfig, read: Callable):
    """The decode step's layer loop; ``read(i, q, k, v)`` gives layer i's
    (b, h, 1, dh) attention output over the cached rows plus self."""
    h = x_tok[:, None, :]
    ks, vs = [], []
    for i, layer in enumerate(model.layers):
        p = layer.attn
        q, k, v = attn_ops.qkv_project(p, core.layernorm(p.ln, h), cfg.heads)
        h = h + attn_ops.output_tail(p, read(i, q, k, v))
        h = h + T.ff_branch(layer, h)
        ks.append(k)
        vs.append(v)
    return h[:, 0, :], torch.stack(ks), torch.stack(vs)


def _decode_step_math(model: T.Transformer, x_tok: torch.Tensor,
                      pos: torch.Tensor, cache: Pool, *,
                      cfg: T.TransformerConfig, key_mask: torch.Tensor,
                      attn_impl: str = "kernel",
                      block_tables: Optional[torch.Tensor] = None,
                      sparse_reads: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over the cached rows plus self for one token per slot,
    without the cache write. x_tok (b, dim); pos (b,) per-slot
    positions; key_mask (b, total_len). ``attn_impl='kernel'`` reads
    ``cache`` as the raw page pool through ``block_tables`` (kernel K4);
    ``'gather'`` reads it as a dense view (``paged_view``), the oracle.
    Sparse layers attend to their layout row of each slot's position.
    ``sparse_reads=True`` hands over to ``_decode_step_math_sparse_reads``
    (``cache`` is then the raw pool for both impls). Returns (h_out
    (b, dim), new ks, new vs (depth, b, heads, 1, dh))."""
    if attn_impl not in ("gather", "kernel"):
        raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                         f"{attn_impl!r}")
    if (attn_impl == "kernel" or sparse_reads) and block_tables is None:
        raise ValueError(f"attn_impl={attn_impl!r} with sparse_reads="
                         f"{sparse_reads} requires block_tables")
    if sparse_reads:
        return _decode_step_math_sparse_reads(
            model, x_tok, pos, cache, cfg=cfg, key_mask=key_mask,
            attn_impl=attn_impl, block_tables=block_tables)
    dense_allowed, sparse_allowed = _step_masks(cfg, pos, key_mask)
    quantized = "k_scale" in cache

    def read(i, q, k, v):
        ksc = cache["k_scale"][i] if quantized else None
        vsc = cache["v_scale"][i] if quantized else None
        allowed = sparse_allowed if cfg.sparse_pattern[i] else dense_allowed
        if attn_impl == "kernel":
            return _kernel_read(q, k, v, cache["k"][i], cache["v"][i],
                                block_tables, pos, allowed, scale=cfg.scale,
                                ksc=ksc, vsc=vsc)
        return _gather_read(q, k, v, cache["k"][i], cache["v"][i], allowed,
                            scale=cfg.scale, ksc=ksc, vsc=vsc)

    return _run_layers(model, x_tok, cfg, read)


def decode_step(model: T.Transformer, x_tok: torch.Tensor, pos,
                cache: Pool, *, cfg: T.TransformerConfig,
                key_mask: torch.Tensor) -> torch.Tensor:
    """Advance one token against the dense cache (updated in place).
    x_tok (b, dim): the embedding of the token at ``pos`` — an int, or a
    (b,) tensor of per-row positions; key_mask (b, total_len): the cache
    rows' validity (rows at and past pos are left out by the causal test
    either way). Returns h_out (b, dim)."""
    pos_rows = pos
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
        pos_rows = torch.full((x_tok.shape[0],), int(pos), dtype=torch.long,
                              device=x_tok.device)
    h, ks, vs = _decode_step_math(model, x_tok, pos_rows, cache, cfg=cfg,
                                  key_mask=key_mask, attn_impl="gather")
    _store_rows(cache, ks, vs, pos)
    return h


def _decode_step_math_sparse_reads(
        model: T.Transformer, x_tok: torch.Tensor, pos: torch.Tensor,
        pool: Pool, *, cfg: T.TransformerConfig, key_mask: torch.Tensor,
        attn_impl: str, block_tables: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_decode_step_math`` with sparse reads: every sparse layer reads
    only its statically visible pages, dense layers read as before, and
    both impls take the RAW page pool through ``block_tables``:

    * ``'kernel'``: sparse layers run K4's visible walk over the
      per-slot visible-page list with the token-causal count; dense
      layers its prefix walk;
    * ``'gather'``: sparse layers gather only the visible slice of the
      block table (``kv_pool.visible_table_view``) with the row mask
      remapped onto the trimmed columns; dense layers gather the full
      view.

    The entry points (``decode_step_paged``, ``decode_loop_paged``, the
    engine) run ``check_sparse_reads`` once; the per-step math does not."""
    from dalle_pytorch_tpu_torch.serve import kv_pool as KV
    b = x_tok.shape[0]
    total_len = key_mask.shape[1]
    ps = pool["k"].shape[3]
    quantized = "k_scale" in pool
    dev = pos.device
    pos_l = pos.long()
    dense_allowed, sparse_allowed = _step_masks(cfg, pos, key_mask)
    vis, cnt, ccnt = _sparse_page_visibility(cfg, total_len, ps, dev)
    width = vis.shape[1]
    vis_rows = vis[pos_l]                                       # (b, W)
    if attn_impl == "kernel":
        vis_ccnt = ccnt[pos_l]                                  # (b,)
    else:
        bt = block_tables[:, :-(-total_len // ps)].long()  # the view's trim
        vis_bt = KV.visible_table_view(bt, vis_rows)            # (b, W)
        # the row mask on the trimmed columns: column w*ps + o is logical
        # row vis_rows[:, w]*ps + o; columns past the live count are dead
        # (they would count page 0 again), and so are rows past total_len
        cols = (vis_rows.long()[:, :, None] * ps
                + torch.arange(ps, device=dev)).reshape(b, width * ps)
        pad_ok = (torch.arange(width, device=dev)[None, :]
                  < cnt[pos_l][:, None]).repeat_interleave(ps, dim=1)
        vis_allowed = (torch.gather(sparse_allowed, 1,
                                    cols.clamp(max=total_len - 1))
                       & pad_ok & (cols < total_len))

    def layer_view(buf, tables, rows_out):
        """One layer's (P, heads, ps[, dh]) pool gathered through tables
        (b, w) into (b, heads, rows_out[, dh])."""
        g = buf[tables].transpose(1, 2)          # (b, heads, w, ps[, dh])
        g = g.reshape(b, g.shape[1], -1, *g.shape[4:])
        return g[:, :, :rows_out]

    def read(i, q, k, v):
        is_sparse = cfg.sparse_pattern[i]
        ksc = pool["k_scale"][i] if quantized else None
        vsc = pool["v_scale"][i] if quantized else None
        if attn_impl == "kernel":
            return _kernel_read(
                q, k, v, pool["k"][i], pool["v"][i], block_tables, pos,
                sparse_allowed if is_sparse else dense_allowed,
                scale=cfg.scale, ksc=ksc, vsc=vsc,
                visible=vis_rows if is_sparse else None,
                visible_cnt=vis_ccnt if is_sparse else None)
        tables, rows_out, allowed = (
            (vis_bt, width * ps, vis_allowed) if is_sparse
            else (bt, total_len, dense_allowed))
        views = [None if buf is None else layer_view(buf, tables, rows_out)
                 for buf in (pool["k"][i], pool["v"][i], ksc, vsc)]
        return _gather_read(q, k, v, views[0], views[1], allowed,
                            scale=cfg.scale, ksc=views[2], vsc=views[3])

    return _run_layers(model, x_tok, cfg, read)


def _store_rows_paged(pool: Pool, ks: torch.Tensor, vs: torch.Tensor,
                      pos: torch.Tensor, block_tables: torch.Tensor,
                      active: torch.Tensor) -> None:
    """Write slot i's new K/V row (depth, b, heads, 1, dh) into physical
    page ``block_tables[i, pos[i] // ps]`` at offset ``pos[i] % ps``, in
    place. INACTIVE slots write the trash page 0: a dead slot parks at
    pos 0, and its table entry 0 may already map a page the allocator
    handed to a newer request."""
    ps = pool["k"].shape[3]
    b = pos.shape[0]
    slot = torch.arange(b, device=pos.device)
    pos = pos.long()
    page = torch.where(active, block_tables.long()[slot, pos // ps], 0)
    off = torch.where(active, pos % ps, 0)
    rows = _rows(ks, vs, "k_scale" in pool)
    for name, buf in pool.items():
        # advanced indices at dims 1 and 3 are apart, so the value is
        # (b, depth, heads[, dh])
        buf[:, page, :, off] = rows[name][:, :, :, 0].transpose(0, 1) \
            .to(buf.dtype)


def decode_step_paged(model: T.Transformer, x_tok: torch.Tensor,
                      pos: torch.Tensor, pool: Pool,
                      block_tables: torch.Tensor, *,
                      cfg: T.TransformerConfig, key_mask: torch.Tensor,
                      active: torch.Tensor,
                      attn_impl: str = "kernel",
                      sparse_reads: bool = False) -> torch.Tensor:
    """One decode step against the pool (updated in place); returns
    h_out (b, dim). ``attn_impl='gather'`` reads through ``paged_view``,
    or, with ``sparse_reads``, through the per-layer trimmed views."""
    if sparse_reads:
        check_sparse_reads(cfg)
    return _decode_step_paged(model, x_tok, pos, pool, block_tables, cfg=cfg,
                              key_mask=key_mask, active=active,
                              attn_impl=attn_impl, sparse_reads=sparse_reads)


def _decode_step_paged(model: T.Transformer, x_tok: torch.Tensor,
                       pos: torch.Tensor, pool: Pool,
                       block_tables: torch.Tensor, *,
                       cfg: T.TransformerConfig, key_mask: torch.Tensor,
                       active: torch.Tensor, attn_impl: str = "kernel",
                       sparse_reads: bool = False) -> torch.Tensor:
    """``decode_step_paged`` without the sparse-reads check."""
    if attn_impl == "kernel" or sparse_reads:
        cache = pool
    else:
        cache = paged_view(pool, block_tables, key_mask.shape[1])
    h, ks, vs = _decode_step_math(model, x_tok, pos, cache, cfg=cfg,
                                  key_mask=key_mask, attn_impl=attn_impl,
                                  block_tables=block_tables,
                                  sparse_reads=sparse_reads)
    _store_rows_paged(pool, ks, vs, pos, block_tables, active)
    return h


def decode_loop_paged(model: T.Transformer, cur_tok: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor, pool: Pool,
                      block_tables: torch.Tensor, *,
                      cfg: T.TransformerConfig, key_mask: torch.Tensor,
                      steps: int,
                      embed_fn: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor],
                      sample_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                      sparse_reads: bool = False):
    """``steps`` decode steps for every slot, with no host sync: each
    step's emitted token goes into a device-side (b, steps) ring that
    the host reads once per chunk. A slot emits while active; one whose
    position reaches the sequence end deactivates itself and parks at
    (tok 0, pos 0), writing the trash page, until the host notices.
    ``embed_fn(cur_tok, pos) -> (b, dim)`` and ``sample_fn(h, pred_pos)
    -> (b,)`` are the model-level halves. ``sparse_reads`` makes the
    sparse layers read only their visible pages (K4's visible walk).

    Returns (cur_tok, pos, active, ring); ring holds -1 where a slot was
    inactive. The pool is updated in place."""
    if sparse_reads:
        check_sparse_reads(cfg)
    total_len = key_mask.shape[1]
    ring = torch.empty((cur_tok.shape[0], steps), dtype=torch.int32,
                       device=cur_tok.device)
    for t in range(steps):
        ring[:, t] = torch.where(active, cur_tok, -1)
        x = embed_fn(cur_tok, pos)
        h = _decode_step_paged(model, x, pos, pool, block_tables, cfg=cfg,
                               key_mask=key_mask, active=active,
                               sparse_reads=sparse_reads)
        nxt = sample_fn(h, pos + 1)
        pos = pos + 1
        active = active & (pos < total_len)
        cur_tok = torch.where(active, nxt, 0).to(cur_tok.dtype)
        pos = torch.where(active, pos, 0)
    return cur_tok, pos, active, ring
