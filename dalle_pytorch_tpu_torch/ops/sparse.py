"""Block-sparse attention layout and its two plain implementations.

Port of ``dalle_pytorch_tpu/ops/sparse.py`` (``:40-263``), the
VariableSparsity layout the reference gets from DeepSpeed's
``SparseSelfAttention`` (block 16, a local window of 4 consecutive
blocks, global block 0, causal for unidirectional attention):

* ``variable_sparsity_layout`` / ``token_layout_mask`` — the block and
  token layouts (numpy, True = attended);
* ``visible_pages`` / ``visible_pages_causal`` — the per-position
  visible KV-page lists the sparse decode reads walk (numpy; the cached
  arrays are frozen, since every consumer shares them);
* ``sparse_attention_ref`` — the numerics oracle, a dense softmax
  restricted to the layout;
* ``sparse_attention_windowed`` — the same function from its algebraic
  structure: a block-diagonal window piece and a narrow global strip
  under one softmax, n * (W + G) work instead of n^2.

Two fills, as in JAX: structural pairs (layout, causal) are -inf, pad
KEYS take the finite ``-finfo.max`` (``core.neg_inf``); pad queries are
not masked (the reference's key-padding contract). The layout code is
numpy and this module keeps its own copy of it: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dalle_pytorch_tpu_torch.ops import core


@functools.lru_cache(maxsize=32)
def variable_sparsity_layout(num_blocks: int, *, num_local_blocks: int = 4,
                             global_blocks: Tuple[int, ...] = (0,),
                             causal: bool = True) -> np.ndarray:
    """(num_blocks, num_blocks) bool, True where block (q, k) is
    attended. Cached, so the array is frozen."""
    ib = np.arange(num_blocks)[:, None]
    jb = np.arange(num_blocks)[None, :]
    layout = (ib // num_local_blocks) == (jb // num_local_blocks)
    for g in global_blocks:
        layout = layout | (jb == g)
    if causal:
        layout = layout & (jb <= ib)
    layout.setflags(write=False)
    return layout


def token_layout_mask(seq_len: int, block: int = 16, *,
                      num_local_blocks: int = 4,
                      global_blocks: Tuple[int, ...] = (0,),
                      causal: bool = True) -> np.ndarray:
    """The block layout expanded to a (seq_len, seq_len) token mask; the
    causal constraint here is block-level only (the token-level triangle
    is applied separately, as DeepSpeed combines them)."""
    if seq_len % block:
        raise ValueError(f"seq_len {seq_len} is not a multiple of the "
                         f"block {block}")
    layout = variable_sparsity_layout(
        seq_len // block, num_local_blocks=num_local_blocks,
        global_blocks=tuple(global_blocks), causal=causal)
    return np.repeat(np.repeat(layout, block, axis=0), block, axis=1)


def visible_pages(seq_len: int, page_size: int, block: int = 16, *,
                  num_local_blocks: int = 4,
                  global_blocks: Tuple[int, ...] = (0,),
                  causal: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position visible KV pages: page g is visible at position p iff
    any token of it is allowed by row p of ``token_layout_mask``.

    Returns ``(vis (seq_len, W) int32, cnt (seq_len,) int32)``: row p
    lists p's visible page ids in ascending order, ``W`` the largest
    count, padded with 0 past ``cnt[p]`` (padding is not a grant:
    consumers mask the columns at or past ``cnt[p]``)."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    padded = -(-seq_len // block) * block
    layout = token_layout_mask(padded, block,
                               num_local_blocks=num_local_blocks,
                               global_blocks=global_blocks,
                               causal=causal)[:seq_len, :seq_len]
    num_pages = -(-seq_len // page_size)
    pad_cols = num_pages * page_size - seq_len
    if pad_cols:
        layout = np.pad(layout, ((0, 0), (0, pad_cols)))
    page_vis = layout.reshape(seq_len, num_pages, page_size).any(-1)
    cnt = page_vis.sum(-1).astype(np.int32)
    width = max(int(cnt.max()), 1)
    # a stable argsort of ~visible brings the visible ids to the front of
    # each row, in ascending order
    vis = np.argsort(~page_vis, axis=1, kind="stable")[:, :width] \
        .astype(np.int32)
    vis[np.arange(width)[None, :] >= cnt[:, None]] = 0
    return vis, cnt


@functools.lru_cache(maxsize=32)
def visible_pages_causal(seq_len: int, page_size: int, block: int = 16, *,
                         num_local_blocks: int = 4,
                         global_blocks: Tuple[int, ...] = (0,),
                         causal: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cached ``visible_pages`` plus the decode trip count
    ``cnt_causal[p]``: the visible pages that start strictly before p (a
    page at or past p holds no readable row yet). The list is ascending,
    so those pages are a prefix of it. The arrays are frozen."""
    vis, cnt = visible_pages(seq_len, page_size, block,
                             num_local_blocks=num_local_blocks,
                             global_blocks=global_blocks, causal=causal)
    width = vis.shape[1]
    live = np.arange(width)[None, :] < cnt[:, None]
    before = vis * page_size < np.arange(seq_len)[:, None]
    cnt_causal = (live & before).sum(1).astype(np.int32)
    for a in (vis, cnt, cnt_causal):
        a.setflags(write=False)
    return vis, cnt, cnt_causal


def structural_mask(n: int, block: int, *, num_local_blocks: int = 4,
                    global_blocks: Tuple[int, ...] = (0,),
                    causal: bool = True, device=None) -> torch.Tensor:
    """(n, n) bool: the token layout and, when causal, the token-level
    triangle — every pair the -inf fill leaves out is False."""
    layout = core.device_put(token_layout_mask(
        n, block, num_local_blocks=num_local_blocks,
        global_blocks=global_blocks, causal=causal), device)
    if causal:
        layout = layout & torch.ones((n, n), dtype=torch.bool,
                                     device=device).tril()
    return layout


def sparse_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool, block: int = 16,
                         mask: Optional[torch.Tensor] = None,
                         num_local_blocks: int = 4,
                         global_blocks: Tuple[int, ...] = (0,)
                         ) -> torch.Tensor:
    """Dense-math oracle. q, k, v: (b, h, n, d) with n a block multiple;
    ``mask`` (b, n) masks pad KEYS (True = keep)."""
    n = q.shape[2]
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    if mask is not None:
        dots = dots.masked_fill(~mask[:, None, None, :],
                                core.neg_inf(dots.dtype))
    struct = structural_mask(n, block, num_local_blocks=num_local_blocks,
                             global_blocks=global_blocks, causal=causal,
                             device=q.device)
    dots = dots.masked_fill(~struct, float("-inf"))
    attn = torch.softmax(dots, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", attn, v)


def sparse_attention_windowed(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              causal: bool, block: int = 16,
                              mask: Optional[torch.Tensor] = None,
                              num_local_blocks: int = 4,
                              global_blocks: Tuple[int, ...] = (0,)
                              ) -> torch.Tensor:
    """The layout's exact attention from its structure: each row's
    allowed columns are its own W-token window plus the G global tokens,
    so a block-diagonal (W, W) window piece and an (n, G) global strip,
    softmaxed once over their W + G columns, give ``sparse_attention_ref``
    with the same two fills. Scores accumulate in f32."""
    b, h, n, d = q.shape
    W = num_local_blocks * block
    gcols = np.concatenate([np.arange(g * block, (g + 1) * block)
                            for g in global_blocks])
    if (gcols >= n).any():
        raise ValueError(f"global blocks {global_blocks} out of range for "
                         f"seq {n} (block {block})")
    G = len(gcols)
    dev = q.device
    pad = (-n) % W
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (q, k, v))
    n_p = n + pad
    nw = n_p // W
    fill = core.neg_inf(torch.float32)

    qw = q.reshape(b, h, nw, W, d)
    kw = k.reshape(b, h, nw, W, d)
    vw = v.reshape(b, h, nw, W, d)

    # window piece: block-diagonal (W, W) scores
    s_w = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw.float()) * scale
    if mask is not None:
        mw = torch.cat([mask, mask.new_zeros((b, pad))], dim=1) \
            .reshape(b, 1, nw, 1, W)
        s_w = torch.where(mw, s_w, fill)
    rows_w = np.arange(W)[:, None]
    cols_w = np.arange(W)[None, :]
    colidx = np.arange(nw)[:, None, None] * W + cols_w[None]
    allow_w = np.broadcast_to(colidx < n, (nw, W, W))
    if causal:
        allow_w = allow_w & (cols_w <= rows_w)[None]
    s_w = torch.where(core.device_put(np.ascontiguousarray(allow_w), dev),
                      s_w, float("-inf"))

    # global strip: every row against the G global columns
    gidx = core.device_put(gcols, dev)
    kg, vg = k[:, :, gidx], v[:, :, gidx]
    s_g = torch.einsum("bhid,bhgd->bhig", q.float(), kg.float()) * scale
    if mask is not None:
        s_g = torch.where(mask[:, gidx][:, None, None, :], s_g, fill)
    rows = np.arange(n_p)[:, None]
    # the columns a row's own window already holds must not count twice
    allow_g = (gcols[None, :] // W) != (rows // W)
    if causal:
        allow_g = allow_g & (gcols[None, :] <= rows)
    s_g = torch.where(core.device_put(allow_g, dev), s_g, float("-inf"))

    # one safe softmax over the union of both pieces' columns
    s_cat = torch.cat([s_w, s_g.reshape(b, h, nw, W, G)], dim=-1)
    m = s_cat.amax(dim=-1, keepdim=True)
    p = torch.exp(s_cat - torch.where(torch.isfinite(m), m, 0.0))
    p = torch.where(torch.isfinite(s_cat), p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    v_cat = torch.cat([vw, vg[:, :, None].expand(b, h, nw, G, d)], dim=3)
    out = torch.einsum("bhwij,bhwjd->bhwid", p.to(v_cat.dtype).float(),
                       v_cat.float())
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, n_p, d)[:, :, :n].to(q.dtype)
