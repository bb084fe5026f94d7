"""Block-sparse attention for the VariableSparsity layout (kernel K3).

Port of ``dalle_pytorch_tpu/ops/block_sparse.py`` (``:44-386``):

* ``block_sparse_attention`` (``:365``) is a ``torch.autograd.Function``
  whose forward is kernel K3 (``_kernel`` ``:80``, launched by
  ``_bs_fwd`` ``:212``): out, and the f32 row statistics m and l;
* the backward is chosen exactly as ``_bs_bwd_rule`` (``:332-359``)
  chooses it: with ``bq, bk = min(block_q, n), min(block_k, n)`` (the
  JAX tile knobs, whatever tile K3 itself uses), when
  ``_static_tile_schedule(bq, bk, ...) == [0]`` and ``n % bk == 0`` and
  ``n > bk`` it is ``_bs_bwd_static`` (``:250``): the diagonal tiles and
  the global strip as batched products; otherwise the port's
  ``flash_attention.blockwise_attention_bwd`` with the layout as the
  structural mask and ``mask_queries=False``. Both are plain PyTorch,
  as the JAX backward is XLA outside any Pallas kernel;
* ``block_sparse_attention_fwd`` launches the hand-written CUDA kernel
  (``csrc/block_sparse.cu``) on CUDA tensors and runs
  ``block_sparse_attention_fwd_plain``, a one-shot masked softmax, only
  for tensors that lie on the CPU (the tests' path). There is no
  fallback: on the card the kernel launches or the call raises.

The layout is procedural: a pair (row, col) is allowed when
``row // W == col // W`` (W = ``num_local_blocks * block`` tokens) or
``col // block`` is a global block, and, when causal, ``col <= row``.
The masking contract differs from the flash kernels' (K1): pad KEYS
score the finite ``FILL = -3.0e38`` and queries are never masked (the
reference's key-padding contract); structural and ragged pairs are
-inf; the running max starts at -inf with a zero shift while it is not
finite; ``l == 0`` becomes 1 and a non-finite ``m`` is written as 0
(``:169-175``). ``ops/sparse.py::sparse_attention_ref`` keeps its own
fill (``core.neg_inf``, -finfo.max); the two constants differ on purpose.

What bounds K3 on the H100: bytes. At the north training shapes (b 8,
h 8, n 1280, d 64, block 16) a query row sees at most 80 keys (its
64-token window and the 16 global tokens), ~61 k pairs per (b, h): some
1.0 GFLOP of products against ~42.6 MB of q, k, v, out, m and l in bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dalle_pytorch_tpu_torch.ops import build
from dalle_pytorch_tpu_torch.ops import flash_attention as flash_ops

FILL = flash_ops.FILL
MAX_GLOBAL_BLOCKS = 8           # the kernel's fixed-size global-block list


def _structural(rows, cols, *, block, window, global_blocks, causal):
    """The layout at absolute positions; ``rows`` and ``cols`` are
    mutually broadcastable integer tensors."""
    allow = (rows // window) == (cols // window)
    for g in global_blocks:
        allow = allow | ((cols // block) == g)
    if causal:
        allow = allow & (cols <= rows)
    return allow


def _static_tile_schedule(block_q, block_k, block, window, global_blocks,
                          causal):
    """The sorted global-tile list when the layout admits a static tile
    schedule (equal q and k tiles, the window dividing the tile, causal,
    no global block straddling a tile), else None."""
    if block_q != block_k or block_k % window != 0 or not causal:
        return None
    tiles = set()
    for g in global_blocks:
        lo, hi = g * block, g * block + block - 1
        if lo // block_k != hi // block_k:
            return None
        tiles.add(lo // block_k)
    return sorted(tiles)


def block_sparse_attention_fwd_plain(q, k, v, *, scale: float,
                                     causal: bool, block: int = 16,
                                     num_local_blocks: int = 4,
                                     global_blocks: Tuple[int, ...] = (0,),
                                     mask: Optional[torch.Tensor] = None):
    """(out in q's dtype, m, l) with f32 ``m``/``l`` of shape (b, h, n):
    the kernel's function as one masked softmax over the whole row."""
    flash_ops._validate(q, k, v, mask)
    n = q.shape[2]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, FILL)
    idx = torch.arange(n, device=q.device)
    struct = _structural(idx[:, None], idx[None, :], block=block,
                         window=num_local_blocks * block,
                         global_blocks=global_blocks, causal=causal)
    s = s.masked_fill(~struct, float("-inf"))
    m = s.amax(dim=-1)
    finite = torch.isfinite(m)
    p = torch.exp(s - torch.where(finite, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0.0, 1.0, l)
    # p in v's dtype for the second product, as the TPU kernel rounds it
    # (p.astype(vb.dtype)); l stays the sum of the unrounded p
    out = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(),
                       v.float()) / l[..., None]
    return out.to(q.dtype), torch.where(finite, m, 0.0), l


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_F, _I, _I, _I,
                                   ctypes.POINTER(ctypes.c_int), _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("block_sparse").block_sparse_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@flash_ops.any_dim_head
def block_sparse_attention_fwd(q, k, v, *, scale: float, causal: bool,
                               block: int = 16, num_local_blocks: int = 4,
                               global_blocks: Tuple[int, ...] = (0,),
                               mask: Optional[torch.Tensor] = None):
    """K3: (out, m, l). The CUDA kernel for CUDA tensors (any d, through
    the flash kernels' ``any_dim_head``: d 64 and 128 on the narrow
    bodies, wider heads on the wide body), the plain version for CPU
    tensors. Counts launches in
    ``block_sparse_attention_fwd.launches``."""
    if q.device.type == "cpu":
        return block_sparse_attention_fwd_plain(
            q, k, v, scale=scale, causal=causal, block=block,
            num_local_blocks=num_local_blocks, global_blocks=global_blocks,
            mask=mask)
    name = "block_sparse_attention_fwd"
    flash_ops._validate(q, k, v, mask)
    # the flash kernels' inputs: cuda, f32 or bf16, a kernel width of d,
    # contiguous
    code, mask_ptr = flash_ops._kernel_args(name, q, k, v, mask)
    if len(global_blocks) > MAX_GLOBAL_BLOCKS or block < 1 \
            or num_local_blocks < 1:
        raise ValueError(f"{name}: the kernel takes block >= 1, "
                         f"num_local_blocks >= 1 and at most "
                         f"{MAX_GLOBAL_BLOCKS} global blocks")
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    gbs = (ctypes.c_int * MAX_GLOBAL_BLOCKS)(*global_blocks)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, h, n, d, float(scale), int(causal),
        int(block), int(num_local_blocks * block), gbs, len(global_blocks),
        code, stream)
    flash_ops._check_rc(name, rc)
    block_sparse_attention_fwd.launches += 1
    return out, m, l


block_sparse_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward (plain PyTorch, as the JAX backward is XLA)
# ---------------------------------------------------------------------------

def _bs_bwd_static(q, k, v, mask, dout, out, stats, *, scale, block,
                   window, global_blocks, tile):
    """The backward under the static schedule (global tile 0 + the
    diagonal): the (tile x tile) diagonal blocks batched over all tiles,
    and the rows of tiles 1.. against key tile 0. Pad keys score FILL
    with ds zeroed there, structural pairs -inf; products take the input
    dtype's values with f32 accumulation."""
    m_stat, l_stat = stats
    b, h, n, d = q.shape
    T = n // tile
    cdt = q.dtype
    inv_l = 1.0 / l_stat
    dstat = (dout.float() * out.float()).sum(dim=-1)
    ar = torch.arange(n, device=q.device)

    def c(x):                       # the input dtype's values, in f32
        return x.to(cdt).float()

    def pieces(qi, ki, vi, doi, mi, li, Di, row_ids, col_ids, key_mask):
        s = torch.einsum("...id,...jd->...ij", c(qi), c(ki)) * scale
        live = None
        if key_mask is not None:
            live = key_mask[..., None, :]
            s = torch.where(live, s, FILL)
        struct = _structural(row_ids[..., :, None], col_ids[..., None, :],
                             block=block, window=window,
                             global_blocks=global_blocks, causal=True)
        s = s.masked_fill(~struct, float("-inf"))
        p = torch.exp(s - mi[..., None]) * li[..., None]
        dv = torch.einsum("...ij,...id->...jd", c(p), c(doi))
        dp = torch.einsum("...id,...jd->...ij", c(doi), c(vi))
        ds = p * (dp - Di[..., None]) * scale
        if live is not None:
            ds = torch.where(live, ds, 0.0)
        ds_c = c(ds)
        dk = torch.einsum("...ij,...id->...jd", ds_c, c(qi))
        dq = torch.einsum("...ij,...jd->...id", ds_c, c(ki))
        return dq, dk, dv

    def tiled(x):
        if x.dim() == 4:
            return x.reshape(b, h, T, tile, x.shape[-1])
        return x.reshape(b, h, T, tile)

    km_d = None if mask is None else mask.reshape(b, 1, T, tile)
    ids = ar.reshape(T, tile)
    dq, dk, dv = pieces(tiled(q), tiled(k), tiled(v), tiled(dout),
                        tiled(m_stat), tiled(inv_l), tiled(dstat), ids, ids,
                        km_d)
    dq, dk, dv = (x.reshape(b, h, n, d) for x in (dq, dk, dv))

    km_g = None if mask is None else mask[:, None, :tile]
    dq_g, dk_g, dv_g = pieces(
        q[:, :, tile:], k[:, :, :tile], v[:, :, :tile], dout[:, :, tile:],
        m_stat[:, :, tile:], inv_l[:, :, tile:], dstat[:, :, tile:],
        ar[tile:], ar[:tile], km_g)
    dq[:, :, tile:] += dq_g
    dk[:, :, :tile] += dk_g
    dv[:, :, :tile] += dv_g
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def block_sparse_attention_bwd(q, k, v, mask, dout, out, stats, *,
                               scale: float, causal: bool, block: int,
                               num_local_blocks: int,
                               global_blocks: Tuple[int, ...], bq: int,
                               bk: int):
    """(dq, dk, dv), chosen as ``_bs_bwd_rule`` chooses."""
    window = num_local_blocks * block
    n = q.shape[2]
    schedule = _static_tile_schedule(bq, bk, block, window, global_blocks,
                                     causal)
    if schedule == [0] and n % bk == 0 and n > bk:
        return _bs_bwd_static(q, k, v, mask, dout, out, stats, scale=scale,
                              block=block, window=window,
                              global_blocks=global_blocks, tile=bk)

    def structural(rows, cols):
        return _structural(rows[:, None], cols[None, :], block=block,
                           window=window, global_blocks=global_blocks,
                           causal=causal)

    return flash_ops.blockwise_attention_bwd(
        q, k, v, mask, dout, out, stats, scale=scale, block_k=min(bk, n),
        structural_mask_fn=structural, mask_queries=False)


class _BlockSparse(torch.autograd.Function):
    """K3 forward; the backward ``block_sparse_attention_bwd`` chooses."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, block, num_local_blocks,
                global_blocks, bq, bk):
        out, m, l = block_sparse_attention_fwd(
            q, k, v, scale=scale, causal=causal, block=block,
            num_local_blocks=num_local_blocks, global_blocks=global_blocks,
            mask=mask)
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        ctx.opts = dict(scale=scale, causal=causal, block=block,
                        num_local_blocks=num_local_blocks,
                        global_blocks=global_blocks, bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(
            q, k, v, mask, dout.contiguous(), out, (m, l), **ctx.opts)
        return (dq, dk, dv) + (None,) * 8


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, scale: Optional[float] = None,
                           causal: bool = True,
                           mask: Optional[torch.Tensor] = None,
                           block: int = 16, num_local_blocks: int = 4,
                           global_blocks: Tuple[int, ...] = (0,),
                           block_q: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """VariableSparsity attention, differentiable. q/k/v: (b, h, n, d)
    with n a multiple of ``block``, contiguous on the card; mask: (b, n)
    bool key-padding mask (True = keep). ``block_q``/``block_k`` are the
    JAX tile knobs, which pick the backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = q.shape[2]
    return _BlockSparse.apply(q, k, v, mask, float(scale), bool(causal),
                              int(block), int(num_local_blocks),
                              tuple(int(g) for g in global_blocks),
                              min(block_q, n), min(block_k, n))
