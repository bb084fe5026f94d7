"""Incremental decoding: prefill, the dense-cache and the paged
single-token decode steps.

Port of ``dalle_pytorch_tpu/ops/decode.py``:

* ``_quantize_rows`` (``:73``) — symmetric per-row int8 for the int8
  caches;
* ``init_cache`` (``:46``), ``_store_rows`` (``:82``, with
  ``_store_rows_per_slot``) and ``_full_key_mask`` (``:143``) — the
  dense (depth, b, heads, total_len, dh) cache of one-shot generation,
  int8 rows with per-row f32 scales under ``quantized``;
* ``prefill`` (``:274``) — the prompt through the stack in one
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
* ``decode_loop`` (``:325``) — the K-step loop over the dense slot cache,
  the engine's ``kv='dense'`` read;
* speculative decode (``:876-1342``): the W-wide chunk math
  ``_decode_chunk_math`` with its reads ``_gather_read_wide`` and
  ``_kernel_read_wide`` (one K4 prefix walk per offset, at the chunk-start
  pos with that offset's row mask), the writers ``_store_rows_wide`` and
  ``_store_rows_paged_wide``, ``speculative_draft``,
  ``speculative_verify``, ``_draft_cache_view`` and the loops
  ``decode_loop_spec`` and ``decode_loop_spec_paged``;
* block-sparse layers: ``_sparse_layout`` (``:154``) in ``prefill`` and in
  the step's per-slot ``sparse_allowed`` (``:434-472``), so a sparse
  model computes the model it was trained as; and the sparse reads,
  ``_decode_step_math_sparse_reads`` (``:520-692``): each sparse layer
  reads only its statically visible pages (``_sparse_page_visibility``,
  ``:166``) — through K4's visible walk in ``'kernel'`` mode, or through
  the trimmed ``kv_pool.visible_table_view`` in ``'gather'`` mode, the
  oracle — while dense layers read as before. Skipped pages carry
  exactly zero weight, so the tokens do not change.

Every layer loop (``prefill`` and ``_layer_loop``, which the dense,
paged, sparse-reads and speculative steps share) runs ``_block``: a reversible stack
in its two-stream form (the cached K/V from x2, the output the streams'
mean), and each FF through ``ff_or_moe``, so a reversible or MoE model
decodes the network it was trained as (JAX ``:300-318``, ``:492-510``,
``:660-685``).

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


def _stack_in(x: torch.Tensor, cfg: T.TransformerConfig):
    """The layer loop's carry: x, or the two streams (x, x) of a
    reversible stack."""
    return (x, x) if cfg.reversible else x


def _stack_out(carry, cfg: T.TransformerConfig) -> torch.Tensor:
    """The stack's output: the carry, or the mean of the two streams."""
    return (carry[0] + carry[1]) * 0.5 if cfg.reversible else carry


def _block(layer: T.Layer, carry, cfg: T.TransformerConfig,
           attend: Callable):
    """One layer over the carry -> (carry, k, v). ``attend(h)`` gives
    the attention branch's output and the K/V rows of ``h``. Sequential:
    h + attention, then + FF; reversible (JAX ``:300-318``): y1 = x1 +
    attention(x2), y2 = x2 + FF(y1), so the cached K/V come from x2, the
    stream attention reads. The FF is ``ff_or_moe``'s, in eval mode."""
    if cfg.reversible:
        x1, x2 = carry
        a, k, v = attend(x2)
        y1 = x1 + a
        return (y1, x2 + T.ff_or_moe(layer, y1, cfg)[0]), k, v
    a, k, v = attend(carry)
    h = carry + a
    return h + T.ff_or_moe(layer, h, cfg)[0], k, v


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
    h = _stack_in(x, cfg)
    for layer, is_sparse in zip(model.layers, cfg.sparse_pattern):
        allowed = sparse_allowed if is_sparse else dense_allowed
        h, k, v = _block(layer, h, cfg,
                         lambda hn, layer=layer, allowed=allowed:
                         _attn_with_kv(layer, hn, allowed, cfg))
        ks.append(k)
        vs.append(v)
    h = _stack_out(h, cfg)
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


def _layer_loop(model: T.Transformer, x: torch.Tensor,
                cfg: T.TransformerConfig, read: Callable):
    """The decode layer loop over W fresh rows a slot, x (b, W, dim);
    ``read(i, q, k, v)`` gives layer i's (b, h, W, dh) attention output
    over the cached rows plus the fresh ones. Returns (h_out (b, W,
    dim), ks, vs (depth, b, heads, W, dh))."""
    h = _stack_in(x, cfg)
    ks, vs = [], []
    for i, layer in enumerate(model.layers):

        def attend(hn, i=i, p=layer.attn):
            q, k, v = attn_ops.qkv_project(p, core.layernorm(p.ln, hn),
                                           cfg.heads)
            return attn_ops.output_tail(p, read(i, q, k, v)), k, v

        h, k, v = _block(layer, h, cfg, attend)
        ks.append(k)
        vs.append(v)
    return _stack_out(h, cfg), torch.stack(ks), torch.stack(vs)


def _run_layers(model: T.Transformer, x_tok: torch.Tensor,
                cfg: T.TransformerConfig, read: Callable):
    """The one-token step's layer loop: x_tok (b, dim), h_out (b, dim)."""
    h, ks, vs = _layer_loop(model, x_tok[:, None, :], cfg, read)
    return h[:, 0, :], ks, vs


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
                      attn_impl: str = "kernel",
                      sparse_reads: bool = False):
    """``steps`` decode steps for every slot, with no host sync: each
    step's emitted token goes into a device-side (b, steps) ring that
    the host reads once per chunk. A slot emits while active; one whose
    position reaches the sequence end deactivates itself and parks at
    (tok 0, pos 0), writing the trash page, until the host notices.
    ``embed_fn(cur_tok, pos) -> (b, dim)`` and ``sample_fn(h, pred_pos)
    -> (b,)`` are the model-level halves. ``attn_impl`` is the read:
    K4 in place (``'kernel'``) or the ``paged_view`` gather.
    ``sparse_reads`` makes the sparse layers read only their visible
    pages (K4's visible walk).

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
                               attn_impl=attn_impl,
                               sparse_reads=sparse_reads)
        nxt = sample_fn(h, pos + 1)
        pos = pos + 1
        active = active & (pos < total_len)
        cur_tok = torch.where(active, nxt, 0).to(cur_tok.dtype)
        pos = torch.where(active, pos, 0)
    return cur_tok, pos, active, ring


def decode_loop(model: T.Transformer, cur_tok: torch.Tensor,
                pos: torch.Tensor, active: torch.Tensor, cache: Pool, *,
                cfg: T.TransformerConfig, key_mask: torch.Tensor, steps: int,
                embed_fn: Callable, sample_fn: Callable):
    """``decode_loop_paged`` over the dense slot cache (depth, slots,
    heads, total_len, dh), read by the gather (``_gather_read``): the
    engine's ``kv='dense'`` loop (JAX ``:325``). A dead slot parks at
    (tok 0, pos 0) and rewrites row 0 of its own slot, which admission's
    prefill overwrites before any read. Returns (cur_tok, pos, active,
    ring); the cache is updated in place."""
    total_len = cache["k"].shape[3]
    ring = torch.empty((cur_tok.shape[0], steps), dtype=torch.int32,
                       device=cur_tok.device)
    for t in range(steps):
        ring[:, t] = torch.where(active, cur_tok, -1)
        x = embed_fn(cur_tok, pos)
        h, ks, vs = _decode_step_math(model, x, pos, cache, cfg=cfg,
                                      key_mask=key_mask, attn_impl="gather")
        _store_rows(cache, ks, vs, pos)
        nxt = sample_fn(h, pos + 1)
        pos = pos + 1
        active = active & (pos < total_len)
        cur_tok = torch.where(active, nxt, 0).to(cur_tok.dtype)
        pos = torch.where(active, pos, 0)
    return cur_tok, pos, active, ring


# ---------------------------------------------------------------------------
# speculative decode: draft and verify inside the fused serving loop
# ---------------------------------------------------------------------------
#
# Each round drafts k-1 tokens with the first d layers of the stack and the
# same logit head and sampler (an early exit, JAX ``:876-906``), then runs
# the full stack over all k tokens in one k-wide pass. Sampling is a
# function of (logits, fold_in(key, position)) only, so the verify's
# sample at offset i IS the token the eager loop emits there: the longest
# matching prefix is accepted, and the sample at the first mismatch is the
# (always right) continuation. Rows written past the accepted prefix are
# stale and never read (reads stop at the chunk-start pos, and the next
# round rewrites them first), so a rejection neither rewinds pos nor
# unmaps a page. The wide chunk math is the one-token math with W query
# rows a slot: query i attends the cached rows below the chunk start and
# the chunk's own fresh rows 0..i.


def _chunk_masks(cfg: T.TransformerConfig, pos: torch.Tensor,
                 key_mask: torch.Tensor, W: int):
    """(dense_cached, dense_intra, sparse_cached, sparse_intra): (b, W, L)
    cached-row masks (rows strictly below the chunk start, not padding)
    and (b, W, W) intra-chunk masks (key kk visible to query i iff
    kk <= i); a sparse layer's also take the layout row of each query's
    own position, intra keys included, self always attended (JAX
    ``:1013-1036``)."""
    b, L = key_mask.shape
    dev = pos.device
    offs = torch.arange(W, device=dev)
    causal = torch.arange(L, device=dev)[None, :] < pos[:, None]
    dense_cached = (causal & key_mask)[:, None, :].expand(b, W, L)
    dense_intra = (offs[:, None] >= offs[None, :])[None].expand(b, W, W)
    if not any(cfg.sparse_pattern):
        return dense_cached, dense_intra, dense_cached, dense_intra
    layout = _sparse_layout(cfg, L, dev)
    qrows = (pos.long()[:, None] + offs[None, :]).clamp(max=L - 1)  # (b, W)
    lrows = layout[qrows]                                           # (b, W, L)
    intra_lay = torch.gather(lrows, 2, qrows[:, None, :].expand(b, W, W))
    eye = torch.eye(W, dtype=torch.bool, device=dev)[None]
    return (dense_cached, dense_intra, dense_cached & lrows,
            dense_intra & (intra_lay | eye))


def _gather_read_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor,
                      allowed_cached: torch.Tensor,
                      allowed_intra: torch.Tensor, *, scale: float,
                      ksc: Optional[torch.Tensor] = None,
                      vsc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W-wide ``_gather_read`` (JAX ``:908``): q/k/v (b, h, W, dh) fresh
    rows, ck/cv (b, h, L, dh) cached rows, allowed_cached (b, W, L) and
    allowed_intra (b, W, W). One softmax over [cached, intra] logits a
    query; int8 scales applied outside the contractions in the score
    dtype. Returns (b, h, W, dh)."""
    quantized = ksc is not None
    ckc = ck.to(q.dtype) if quantized else ck
    scores = torch.einsum("bhqd,bhjd->bhqj", q, ckc) * scale
    if quantized:
        scores = scores * ksc[:, :, None, :].to(scores.dtype)
    scores = scores.masked_fill(~allowed_cached[:, None],
                                core.neg_inf(scores.dtype))
    intra = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    intra = intra.masked_fill(~allowed_intra[:, None],
                              core.neg_inf(intra.dtype))
    w = torch.softmax(torch.cat([scores, intra], dim=-1), dim=-1)
    L = ck.shape[2]
    wj, wi = w[..., :L], w[..., L:]
    if quantized:
        wj = wj * vsc[:, :, None, :].to(wj.dtype)
        cv = cv.to(q.dtype)
    return (torch.einsum("bhqj,bhjd->bhqd", wj, cv)
            + torch.einsum("bhqk,bhkd->bhqd", wi, v))


def _kernel_read_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      allowed_cached: torch.Tensor,
                      allowed_intra: torch.Tensor, *, scale: float,
                      ksc: Optional[torch.Tensor] = None,
                      vsc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W-wide ``_kernel_read`` (JAX ``:942``): one K4 prefix walk per
    offset i, each up to the CHUNK-START ``pos`` with that offset's row
    mask ``allowed_cached[:, i]``, then the two-estimate merge folds in
    the offset's intra-chunk logits (keys 0..i, self included) in plain
    float32. W = 1 is exactly the one-token merge."""
    W = q.shape[2]
    outs = []
    for i in range(W):
        acc, m, l = PA.paged_decode_attention(
            q[:, :, i, :].contiguous(), pool_k, pool_v, block_tables, pos,
            allowed_cached[:, i, :], scale=scale, k_scales=ksc,
            v_scales=vsc)
        s = torch.einsum("bhd,bhkd->bhk", q[:, :, i, :],
                         k[:, :, :i + 1, :]).float() * scale
        s = s.masked_fill(~allowed_intra[:, None, i, :i + 1], PA.FILL)
        m2 = s.amax(dim=-1)                   # self is finite: m2 too
        m_t = torch.maximum(m, m2)
        alpha = torch.exp(m - m_t)
        wk = torch.exp(s - m_t[..., None])
        denom = l * alpha + wk.sum(dim=-1)
        out = (acc * alpha[..., None]
               + torch.einsum("bhk,bhkd->bhd", wk,
                              v[:, :, :i + 1, :].float())) / denom[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=2)


def _decode_chunk_math(model: T.Transformer, x_toks: torch.Tensor,
                       pos: torch.Tensor, cache: Pool, *,
                       cfg: T.TransformerConfig, key_mask: torch.Tensor,
                       attn_impl: str = "gather",
                       block_tables: Optional[torch.Tensor] = None):
    """W-wide ``_decode_step_math`` (JAX ``:979``), the core of the
    speculative draft and verify: x_toks (b, W, dim) embeds the tokens
    at pos..pos+W-1 (pos (b,) the chunk start); the cache holds valid
    rows strictly below pos only. Runs ``_block`` over every layer, so a
    reversible or MoE model speculates as it decodes. ``'kernel'`` reads
    ``cache`` as the raw page pool through ``block_tables`` (one K4 walk
    per offset); ``'gather'`` as a dense view. Returns (h_out (b, W,
    dim), ks, vs (depth, b, heads, W, dh)); the caller writes them."""
    if attn_impl not in ("gather", "kernel"):
        raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                         f"{attn_impl!r}")
    if attn_impl == "kernel" and block_tables is None:
        raise ValueError("attn_impl='kernel' requires block_tables")
    if pos.dim() != 1:
        raise ValueError("the wide chunk math requires per-slot (b,) "
                         "positions (the serving decode shape)")
    dense_c, dense_i, sparse_c, sparse_i = _chunk_masks(
        cfg, pos, key_mask, x_toks.shape[1])
    quantized = "k_scale" in cache

    def read(i, q, k, v):
        a_c, a_i = (sparse_c, sparse_i) if cfg.sparse_pattern[i] \
            else (dense_c, dense_i)
        ksc = cache["k_scale"][i] if quantized else None
        vsc = cache["v_scale"][i] if quantized else None
        if attn_impl == "kernel":
            return _kernel_read_wide(q, k, v, cache["k"][i], cache["v"][i],
                                     block_tables, pos, a_c, a_i,
                                     scale=cfg.scale, ksc=ksc, vsc=vsc)
        return _gather_read_wide(q, k, v, cache["k"][i], cache["v"][i],
                                 a_c, a_i, scale=cfg.scale, ksc=ksc, vsc=vsc)

    return _layer_loop(model, x_toks, cfg, read)


def _slot_rows_first(t: torch.Tensor) -> torch.Tensor:
    """(depth, b, heads, W[, dh]) -> (b, W, depth, heads[, dh]): the value
    layout of a scatter whose advanced indices sit at dims 1 and 3."""
    return t.permute(1, 3, 0, 2, *range(4, t.dim()))


def _store_rows_wide(cache: Pool, ks: torch.Tensor, vs: torch.Tensor,
                     pos: torch.Tensor) -> None:
    """W-wide ``_store_rows`` per slot (JAX ``:1088``): slot b's row i
    lands at cache row pos[b]+i, in place. JAX drops rows past the cache
    end; here they are clamped onto the last row, whose K/V no position
    ever reads (only queries after it would), so that write is dead as
    well, with no host sync for a boolean index."""
    L = cache["k"].shape[3]
    b, W = pos.shape[0], ks.shape[3]
    bidx = torch.arange(b, device=pos.device)[:, None]
    rows = (pos.long()[:, None]
            + torch.arange(W, device=pos.device)[None, :]).clamp(max=L - 1)
    vals = _rows(ks, vs, "k_scale" in cache)
    for name, buf in cache.items():
        # advanced indices at dims 1 and 3 are apart: the value is
        # (b, W, depth, heads[, dh])
        buf[:, bidx, :, rows] = _slot_rows_first(vals[name]).to(buf.dtype)


def _store_rows_paged_wide(pool: Pool, ks: torch.Tensor, vs: torch.Tensor,
                           pos: torch.Tensor, block_tables: torch.Tensor,
                           active: torch.Tensor, total_len: int) -> None:
    """W-wide ``_store_rows_paged`` (JAX ``:1124``): slot b's row i lands
    in physical page ``block_tables[b, (pos[b]+i) // ps]`` at offset
    ``(pos[b]+i) % ps``, in place. Rows past ``total_len`` and every row
    of an inactive slot go to the trash page 0. The engine maps the full
    speculative horizon before dispatch, so every other row finds its
    page mapped."""
    ps = pool["k"].shape[3]
    b, W = pos.shape[0], ks.shape[3]
    dev = pos.device
    bidx = torch.arange(b, device=dev)[:, None]
    rows = pos.long()[:, None] + torch.arange(W, device=dev)[None, :]
    valid = active[:, None] & (rows < total_len)
    safe = rows.clamp(max=total_len - 1)
    page = torch.where(valid, block_tables.long()[bidx, safe // ps], 0)
    off = torch.where(valid, safe % ps, 0)
    vals = _rows(ks, vs, "k_scale" in pool)
    for name, buf in pool.items():
        buf[:, page, :, off] = _slot_rows_first(vals[name]).to(buf.dtype)


def speculative_draft(draft_model: T.Transformer, cur_tok: torch.Tensor,
                      pos: torch.Tensor, read_cache: Pool, *,
                      cfg: T.TransformerConfig, key_mask: torch.Tensor,
                      k: int, embed_fn: Callable, sample_fn: Callable,
                      attn_impl: str = "gather",
                      block_tables: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """k-1 draft tokens from the early exit (JAX ``:1166``):
    ``draft_model`` holds the stack's first d layers
    (``models.dalle.draft_transformer_params``), ``cfg`` its depth-d
    config, through the same logit head and per-slot sampler. No cache
    write: draft step t reruns the t-wide chunk math over the tokens so
    far. Returns (b, k-1) (empty when k == 1)."""
    toks = [cur_tok]
    for t in range(1, k):
        xs = torch.stack([embed_fn(tok, pos + i)
                          for i, tok in enumerate(toks)], dim=1)
        h, _, _ = _decode_chunk_math(draft_model, xs, pos, read_cache,
                                     cfg=cfg, key_mask=key_mask,
                                     attn_impl=attn_impl,
                                     block_tables=block_tables)
        toks.append(sample_fn(h[:, -1, :], pos + t).to(cur_tok.dtype))
    if k == 1:
        return cur_tok.new_zeros((cur_tok.shape[0], 0))
    return torch.stack(toks[1:], dim=1)


def speculative_verify(model: T.Transformer, cur_tok: torch.Tensor,
                       drafts: torch.Tensor, pos: torch.Tensor,
                       act: torch.Tensor, read_cache: Pool, *,
                       cfg: T.TransformerConfig, key_mask: torch.Tensor,
                       total_len: int, embed_fn: Callable,
                       sample_fn: Callable, attn_impl: str = "gather",
                       block_tables: Optional[torch.Tensor] = None):
    """One full-stack pass over [cur_tok, drafts] (k wide) that accepts
    the longest matching prefix (JAX ``:1196``): the sample at offset i,
    ``sample_fn(h_i, pos+i+1)``, is the eager loop's token there, so
    acceptance is equality and the first rejected offset's sample is
    the continuation. The accepted end is clamped so no emitted position
    reaches ``total_len``.

    Returns (emit (b, k), cur_new, pos_new, act_new, ks, vs): emit[i] is
    the token at pos+i or the -1 sentinel; ks/vs are all k fresh rows
    (depth, b, heads, k, dh) for the caller's write."""
    k = drafts.shape[1] + 1
    toks = [cur_tok] + [drafts[:, t] for t in range(k - 1)]
    xv = torch.stack([embed_fn(tok, pos + i)
                      for i, tok in enumerate(toks)], dim=1)
    h, ks, vs = _decode_chunk_math(model, xv, pos, read_cache, cfg=cfg,
                                   key_mask=key_mask, attn_impl=attn_impl,
                                   block_tables=block_tables)
    s = torch.stack([sample_fn(h[:, i, :], pos + i + 1).to(cur_tok.dtype)
                     for i in range(k)], dim=1)                 # (b, k)
    if k > 1:
        match = (s[:, :k - 1] == drafts).to(torch.int32)
        jm = torch.cumprod(match, dim=1).sum(dim=1)             # [0, k-1]
    else:
        jm = torch.zeros_like(pos)
    # accepted END offset: pos..pos+e emit (e+1 tokens), clamped so the
    # last emitted position stays below total_len
    e = torch.minimum(jm.to(pos.dtype), total_len - 1 - pos)
    offs = torch.arange(k, device=pos.device)
    emit_vals = torch.cat([cur_tok[:, None], s[:, :k - 1]], dim=1)
    emit = torch.where(act[:, None] & (offs[None, :] <= e[:, None]),
                       emit_vals, -1).to(torch.int32)
    cur_new = torch.gather(s, 1, e.long()[:, None])[:, 0]
    pos_new = pos + e + 1
    act_new = act & (pos_new < total_len)
    # dead slots park at (tok 0, pos 0), as in the eager loop
    cur_new = torch.where(act_new, cur_new, 0).to(cur_tok.dtype)
    pos_new = torch.where(act_new, pos_new, 0)
    return emit, cur_new, pos_new, act_new, ks, vs


def _draft_cache_view(read_cache: Pool, depth: int) -> Pool:
    """The draft's read view: the first ``depth`` layers of the cache,
    the view or the pool (int8 scales included)."""
    return {key: buf[:depth] for key, buf in read_cache.items()}


def decode_loop_spec(model: T.Transformer, draft_model: T.Transformer,
                     cur_tok: torch.Tensor, pos: torch.Tensor,
                     active: torch.Tensor, cache: Pool, *,
                     cfg: T.TransformerConfig,
                     draft_cfg: T.TransformerConfig,
                     key_mask: torch.Tensor, steps: int, k: int,
                     embed_fn: Callable, sample_fn: Callable):
    """``decode_loop`` with draft-and-verify (JAX ``:1260``): ``steps``
    rounds, each emitting 1 to k tokens, all the eager loop's. The ring
    is (b, steps*k) with the -1 sentinel at rejected offsets and
    finished slots. Returns (cur_tok, pos, active, ring); the dense cache
    is updated in place."""
    total_len = cache["k"].shape[3]
    ring = torch.empty((cur_tok.shape[0], steps * k), dtype=torch.int32,
                       device=cur_tok.device)
    for t in range(steps):
        drafts = speculative_draft(
            draft_model, cur_tok, pos,
            _draft_cache_view(cache, draft_cfg.depth), cfg=draft_cfg,
            key_mask=key_mask, k=k, embed_fn=embed_fn, sample_fn=sample_fn)
        emit, cur_tok, pos_new, active, ks, vs = speculative_verify(
            model, cur_tok, drafts, pos, active, cache, cfg=cfg,
            key_mask=key_mask, total_len=total_len, embed_fn=embed_fn,
            sample_fn=sample_fn)
        _store_rows_wide(cache, ks, vs, pos)
        ring[:, t * k:(t + 1) * k] = emit
        pos = pos_new
    return cur_tok, pos, active, ring


def decode_loop_spec_paged(model: T.Transformer, draft_model: T.Transformer,
                           cur_tok: torch.Tensor, pos: torch.Tensor,
                           active: torch.Tensor, pool: Pool,
                           block_tables: torch.Tensor, *,
                           cfg: T.TransformerConfig,
                           draft_cfg: T.TransformerConfig,
                           key_mask: torch.Tensor, steps: int, k: int,
                           embed_fn: Callable, sample_fn: Callable,
                           attn_impl: str = "kernel"):
    """``decode_loop_paged`` with draft-and-verify (JAX ``:1297``): the
    draft and the k-wide verify read the pool through the block tables —
    one K4 prefix walk per offset a layer under ``'kernel'``, the
    ``paged_view`` gather otherwise — and all k fresh rows scatter back
    through ``_store_rows_paged_wide``. The host maps the whole
    ``steps * k`` horizon before dispatch; a rejection unmaps nothing.
    Returns (cur_tok, pos, active, ring); the pool is updated in
    place."""
    total_len = key_mask.shape[1]
    kernel = attn_impl == "kernel"
    bt = block_tables if kernel else None
    ring = torch.empty((cur_tok.shape[0], steps * k), dtype=torch.int32,
                       device=cur_tok.device)
    for t in range(steps):
        read = pool if kernel else paged_view(pool, block_tables, total_len)
        drafts = speculative_draft(
            draft_model, cur_tok, pos,
            _draft_cache_view(read, draft_cfg.depth), cfg=draft_cfg,
            key_mask=key_mask, k=k, embed_fn=embed_fn, sample_fn=sample_fn,
            attn_impl=attn_impl, block_tables=bt)
        emit, cur_tok, pos_new, active, ks, vs = speculative_verify(
            model, cur_tok, drafts, pos, active, read, cfg=cfg,
            key_mask=key_mask, total_len=total_len, embed_fn=embed_fn,
            sample_fn=sample_fn, attn_impl=attn_impl, block_tables=bt)
        _store_rows_paged_wide(pool, ks, vs, pos, block_tables, active,
                               total_len)
        ring[:, t * k:(t + 1) * k] = emit
        pos = pos_new
    return cur_tok, pos, active, ring
