"""Incremental decoding: prefill, and the paged single-token decode step.

Port of the serving half of ``dalle_pytorch_tpu/ops/decode.py``:

* ``_quantize_rows`` (``:73``) — symmetric per-row int8 for the int8 pool;
* ``prefill`` (``:274``) — the prompt through the sequential stack in one
  batched pass, with ``_attn_with_kv``'s explicit matmul and finite-fill
  softmax (no fused attention call: the reference fill must hold);
* ``_kernel_read`` (``:183``) — kernel K4's partials merged with the
  current token's self-logit;
* ``_decode_step_math`` (``:391-517``) — one step's attention over the
  cached rows plus self, WITHOUT the cache write;
* ``_store_rows_paged`` (``:760``), ``decode_step_paged`` (``:799``) and
  ``decode_loop_paged`` (``:833``) — the write-back into the page pool
  and the K-step loop that fills a device-side ``(slots, K)`` emit ring;
* ``paged_view`` (``:720``) and ``_gather_read`` (``:216``), the dense-view
  oracle the kernel is held against (tests and ``chip_smoke.py``).

Where JAX returns a new pool from each step, the port updates the pool
IN PLACE (``index_put_``): the pool is the largest buffer on the card,
and a copy per step would move it once per token for nothing. Reads of
a step never see its own write, because the write happens after every
layer has read and the kernel only reads rows below each slot's pos.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.ops import attention as attn_ops
from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
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
            cfg: T.TransformerConfig, quantize_cache: bool = False
            ) -> Tuple[torch.Tensor, Pool]:
    """Run the prompt embeddings x (b, t0, dim) through the stack
    (unpadded prompts: ``prompt_mask=None``, as the engine calls it).

    Returns (h_out (b, t0, dim), the prompt's K/V rows ``{"k", "v"}`` of
    (depth, b, heads, t0, dh) — int8 plus (depth, b, heads, t0) scales
    under ``quantize_cache``). JAX returns them inside a full-length
    cache; here the caller scatters them into its pages."""
    t0 = x.shape[1]
    allowed = torch.ones((t0, t0), dtype=torch.bool,
                         device=x.device).tril()[None, None]
    ks, vs = [], []
    h = x
    for layer in model.layers:
        a, k, v = _attn_with_kv(layer, h, allowed, cfg)
        h = h + a
        h = h + T.ff_branch(layer, h)
        ks.append(k)
        vs.append(v)
    return h, _rows(torch.stack(ks), torch.stack(vs), quantize_cache)


def _kernel_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pool_k: torch.Tensor, pool_v: torch.Tensor,
                 block_tables: torch.Tensor, pos: torch.Tensor,
                 allowed: torch.Tensor, *, scale: float,
                 ksc: Optional[torch.Tensor] = None,
                 vsc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K4's partials over the raw pool, completed with the current
    token's self-logit by the two-estimate softmax merge — exactly
    ``softmax(concat([scores, self]))`` up to summation order. q/k/v are
    (b, h, 1, dh); returns the (b, h, 1, dh) output before the out
    projection."""
    acc, m, l = PA.paged_decode_attention(
        q[:, :, 0, :].contiguous(), pool_k, pool_v, block_tables, pos,
        allowed, scale=scale, k_scales=ksc, v_scales=vsc)
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


def _decode_step_math(model: T.Transformer, x_tok: torch.Tensor,
                      pos: torch.Tensor, cache: Pool, *,
                      cfg: T.TransformerConfig, key_mask: torch.Tensor,
                      attn_impl: str = "kernel",
                      block_tables: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention over the cached rows plus self for one token per slot,
    without the cache write. x_tok (b, dim); pos (b,) per-slot
    positions; key_mask (b, total_len). ``attn_impl='kernel'`` reads
    ``cache`` as the raw page pool through ``block_tables`` (kernel K4);
    ``'gather'`` reads it as a dense view (``paged_view``), the oracle.
    Returns (h_out (b, dim), new ks, new vs (depth, b, heads, 1, dh))."""
    if attn_impl not in ("gather", "kernel"):
        raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                         f"{attn_impl!r}")
    if attn_impl == "kernel" and block_tables is None:
        raise ValueError("attn_impl='kernel' requires block_tables")
    j = torch.arange(key_mask.shape[1], device=pos.device)
    # strictly-before rows; self enters as the extra logit
    allowed = (j[None, :] < pos[:, None]) & key_mask
    quantized = "k_scale" in cache
    h = x_tok[:, None, :]
    ks, vs = [], []
    for i, layer in enumerate(model.layers):
        p = layer.attn
        q, k, v = attn_ops.qkv_project(p, core.layernorm(p.ln, h), cfg.heads)
        ksc = cache["k_scale"][i] if quantized else None
        vsc = cache["v_scale"][i] if quantized else None
        if attn_impl == "kernel":
            out = _kernel_read(q, k, v, cache["k"][i], cache["v"][i],
                               block_tables, pos, allowed, scale=cfg.scale,
                               ksc=ksc, vsc=vsc)
        else:
            out = _gather_read(q, k, v, cache["k"][i], cache["v"][i],
                               allowed, scale=cfg.scale, ksc=ksc, vsc=vsc)
        h = h + attn_ops.output_tail(p, out)
        h = h + T.ff_branch(layer, h)
        ks.append(k)
        vs.append(v)
    return h[:, 0, :], torch.stack(ks), torch.stack(vs)


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
                      attn_impl: str = "kernel") -> torch.Tensor:
    """One decode step against the pool (updated in place); returns
    h_out (b, dim). ``attn_impl='gather'`` reads through ``paged_view``."""
    if attn_impl == "kernel":
        cache = pool
    else:
        cache = paged_view(pool, block_tables, key_mask.shape[1])
    h, ks, vs = _decode_step_math(model, x_tok, pos, cache, cfg=cfg,
                                  key_mask=key_mask, attn_impl=attn_impl,
                                  block_tables=block_tables)
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
                                          torch.Tensor]):
    """``steps`` decode steps for every slot, with no host sync: each
    step's emitted token goes into a device-side (b, steps) ring that
    the host reads once per chunk. A slot emits while active; one whose
    position reaches the sequence end deactivates itself and parks at
    (tok 0, pos 0), writing the trash page, until the host notices.
    ``embed_fn(cur_tok, pos) -> (b, dim)`` and ``sample_fn(h, pred_pos)
    -> (b,)`` are the model-level halves.

    Returns (cur_tok, pos, active, ring); ring holds -1 where a slot was
    inactive. The pool is updated in place."""
    total_len = key_mask.shape[1]
    ring = torch.empty((cur_tok.shape[0], steps), dtype=torch.int32,
                       device=cur_tok.device)
    for t in range(steps):
        ring[:, t] = torch.where(active, cur_tok, -1)
        x = embed_fn(cur_tok, pos)
        h = decode_step_paged(model, x, pos, pool, block_tables, cfg=cfg,
                              key_mask=key_mask, active=active)
        nxt = sample_fn(h, pos + 1)
        pos = pos + 1
        active = active & (pos < total_len)
        cur_tok = torch.where(active, nxt, 0).to(cur_tok.dtype)
        pos = torch.where(active, pos, 0)
    return cur_tok, pos, active, ring
