"""Sequence-parallel attention: the ring (``ppermute``) and Ulysses
(``all_to_all``) bodies.

Port of ``dalle_pytorch_tpu/parallel/ring.py`` (``:42-267``). The
sequence axis is split over a group of ranks, each holding a
(b, h, n/size, d) shard of q, k and v:

* ``ring_attention_local`` — K, V and the pad-mask blocks travel round
  the ring through ``collectives.ppermute`` (whose backward is the
  reverse rotation) while each rank folds one block a step into an
  online-softmax state (``_online_block``), so no (n, n) matrix exists.
  Pad pairs fill with the finite ``-finfo.max`` and causal pairs with
  ``-inf``, as the dense path does (a fully padded row averages its
  causal prefix). The last of JAX's ``size`` rotations brings the blocks
  home unused, and is not made.
* ``ulysses_attention_local`` — one all-to-all trades the sequence
  shard for a head shard, attention over the whole sequence for the
  local heads (dense below ``_ULYSSES_DENSE_MAX`` positions, else folded
  over ``kv_chunks`` key chunks through the same recurrence), and one
  all-to-all back.

The math is JAX's; the scores, the softmax state and the accumulator are
float32 whatever the inputs' dtype (JAX keeps the inputs' dtype), and
the result is cast back. ``ring_attention`` and ``ulysses_attention``
take GLOBAL (b, h, n, d) tensors on every rank, run this rank's shard
and gather the result, as JAX's ``shard_map`` wrappers return the global
array. As in JAX these bodies are plain tensor code, no kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from dalle_pytorch_tpu_torch.parallel import collectives as col


def _online_block(carry, kb, vb, q, scale: float, allow: torch.Tensor,
                  pair_ok: Optional[torch.Tensor] = None):
    """Fold one K/V block into (m, l, acc) (float32; m, l (b, h, nq, 1),
    acc (b, h, nq, d)). ``allow`` (nq, nk) is the causal permission,
    ``pair_ok`` an optional (b, nq, nk) pad mask."""
    m, l, acc = carry
    s = torch.einsum("bhid,bhjd->bhij", q.float(), kb.float()) * scale
    if pair_ok is not None:
        s = s.masked_fill(~pair_ok[:, None], -torch.finfo(s.dtype).max)
    s = s.masked_fill(~allow[None, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # rows with no allowed key yet keep m = -inf: shift them by 0
    shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - shift)
    p = torch.where(allow[None, None], p, torch.zeros_like(p))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - shift),
                        torch.zeros_like(m))
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhij,bhjd->bhid", p, vb.float())
    return m_new, l, acc


def _init_state(q: torch.Tensor):
    qf = q[..., :1].float()
    return (torch.full_like(qf, float("-inf")), torch.zeros_like(qf),
            torch.zeros(q.shape, dtype=torch.float32, device=q.device))


def _finish(state, dtype) -> torch.Tensor:
    _, l, acc = state
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(dtype)


def ring_attention_local(q, k, v, *, group: col.Group, causal: bool = True,
                         scale: Optional[float] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """This rank's (b, h, n/size, d) output; q, k, v and ``mask`` (b,
    n/size) are its shards of the sequence, in group order."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    size, rank = group.size, group.index
    nl = q.shape[2]
    rows = rank * nl + torch.arange(nl, device=q.device)
    state = _init_state(q)
    kb, vb, mb = k, v, mask
    for s in range(size):
        src = (rank - s) % size          # who produced the block we hold
        if causal:
            cols = src * nl + torch.arange(nl, device=q.device)
            allow = cols[None, :] <= rows[:, None]
        else:
            allow = torch.ones((nl, nl), dtype=torch.bool, device=q.device)
        pair_ok = None
        if mb is not None:
            pair_ok = mask[:, :, None] & mb[:, None, :]
        state = _online_block(state, kb, vb, q, scale, allow, pair_ok)
        if s < size - 1:
            kb = col.ppermute(kb, group)
            vb = col.ppermute(vb, group)
            if mb is not None:
                mb = col.ppermute(mb, group)
    return _finish(state, q.dtype)


# full-sequence length at/above which the Ulysses body folds the keys in
# chunks instead of one dense (n, n) score matrix
_ULYSSES_DENSE_MAX = 4096


def ulysses_attention_local(q, k, v, *, group: col.Group,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            mask: Optional[torch.Tensor] = None,
                            kv_chunks: Optional[int] = None
                            ) -> torch.Tensor:
    """This rank's (b, h, n/size, d) output; the heads must divide over
    the group. ``kv_chunks``: None is dense below ``_ULYSSES_DENSE_MAX``
    positions and one chunk a rank at or above; 1 is always dense; more
    must divide the sequence."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    size = group.size

    def seq_to_heads(x):
        return col.all_to_all(x, group, split_dim=1, concat_dim=2)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    n = qh.shape[2]
    full = col.all_gather(mask, group, dim=1) if mask is not None else None
    if kv_chunks is None:
        kv_chunks = 1 if n < _ULYSSES_DENSE_MAX else size
    if kv_chunks > 1 and n % kv_chunks:
        raise ValueError(f"kv_chunks {kv_chunks} must divide the full "
                         f"sequence {n}")
    if kv_chunks == 1:
        s = torch.einsum("bhid,bhjd->bhij", qh.float(), kh.float()) * scale
        if full is not None:
            pair = full[:, :, None] & full[:, None, :]
            s = s.masked_fill(~pair[:, None], -torch.finfo(s.dtype).max)
        if causal:
            tri = torch.ones((n, n), dtype=torch.bool,
                             device=q.device).tril()
            s = s.masked_fill(~tri[None, None], float("-inf"))
        out = torch.einsum("bhij,bhjd->bhid", torch.softmax(s, dim=-1),
                           vh.float()).to(q.dtype)
    else:
        ck = n // kv_chunks
        rows = torch.arange(n, device=q.device)
        state = _init_state(qh)
        for j in range(kv_chunks):
            cols = j * ck + torch.arange(ck, device=q.device)
            allow = (cols[None, :] <= rows[:, None]) if causal else \
                torch.ones((n, ck), dtype=torch.bool, device=q.device)
            pair_ok = None
            if full is not None:
                pair_ok = full[:, :, None] & full[:, None, j * ck:(j + 1) * ck]
            state = _online_block(state, kh[:, :, j * ck:(j + 1) * ck],
                                  vh[:, :, j * ck:(j + 1) * ck], qh, scale,
                                  allow, pair_ok)
        out = _finish(state, q.dtype)
    return col.all_to_all(out, group, split_dim=2, concat_dim=1)


def _shard(x: torch.Tensor, mesh, axis: str, batch_axis: Optional[str],
           seq_dim: int) -> torch.Tensor:
    """This rank's rows (``batch_axis``) and sequence shard (``axis``)."""
    nb, ib = mesh.size(batch_axis), mesh.index(batch_axis)
    ns, is_ = mesh.size(axis), mesh.index(axis)
    b, n = x.shape[0], x.shape[seq_dim]
    x = x[ib * (b // nb):(ib + 1) * (b // nb)]
    return x.narrow(seq_dim, is_ * (n // ns), n // ns)


def _gather(y: torch.Tensor, mesh, axis: str, batch_axis: Optional[str],
            seq_dim: int) -> torch.Tensor:
    y = col.all_gather(y, mesh.group(axis), dim=seq_dim)
    return col.all_gather(y, mesh.group(batch_axis), dim=0)


def _sharded_attn(local, mesh, axis, batch_axis, q, k, v, mask):
    size = mesh.size(axis)
    if q.shape[2] % size:
        raise ValueError(f"seq len {q.shape[2]} not divisible by {axis} "
                         f"axis ({size})")
    args = [_shard(t, mesh, axis, batch_axis, 2) for t in (q, k, v)]
    m = _shard(mask, mesh, axis, batch_axis, 1) if mask is not None else None
    return _gather(local(*args, m), mesh, axis, batch_axis, 2)


def ring_attention(q, k, v, *, mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   batch_axis: Optional[str] = None, mask=None):
    """Exact attention of GLOBAL q, k, v (b, h, n, d) (the same on every
    rank) with the sequence split over ``axis`` (and the batch over
    ``batch_axis``); returns the global (b, h, n, d) on every rank.
    ``mask`` is the optional (b, n) pad mask (True = keep)."""
    group = mesh.group(axis)

    def local(q, k, v, m):
        return ring_attention_local(q, k, v, group=group, causal=causal,
                                    scale=scale, mask=m)

    return _sharded_attn(local, mesh, axis, batch_axis, q, k, v, mask)


def ulysses_attention(q, k, v, *, mesh, axis: str = "sp",
                      causal: bool = True, scale: Optional[float] = None,
                      batch_axis: Optional[str] = None, mask=None,
                      kv_chunks: Optional[int] = None):
    """``ring_attention``'s contract through the Ulysses body; the heads
    must divide over ``axis`` (``ValueError``, as JAX's)."""
    size = mesh.size(axis)
    if q.shape[1] % size != 0:
        raise ValueError(f"heads {q.shape[1]} not divisible by mesh axis "
                         f"{axis} ({size})")
    group = mesh.group(axis)

    def local(q, k, v, m):
        return ulysses_attention_local(q, k, v, group=group, causal=causal,
                                       scale=scale, mask=m,
                                       kv_chunks=kv_chunks)

    return _sharded_attn(local, mesh, axis, batch_axis, q, k, v, mask)
