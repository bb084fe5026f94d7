"""Collectives over a group of ranks, with the gradients JAX gives them.

The torch idiom of what ``dalle_pytorch_tpu/parallel/`` writes with
``lax.psum``, ``pmean``, ``all_gather``, ``all_to_all`` and ``ppermute``
inside ``shard_map``. Each differentiable one is a
``torch.autograd.Function`` whose backward is the transpose of the
collective:

* ``psum``'s is ``psum`` of the cotangents;
* ``all_gather``'s (tiled) is the summing ``reduce_scatter``;
* ``all_to_all``'s is the reverse all-to-all (split and concat axes
  swapped);
* ``ppermute``'s is the reverse rotation;
* ``broadcast_from``'s (the owner's value on every rank: a layer's
  weights reaching its fsdp group) is ``psum`` of the cotangents, kept
  by the owner alone.

These are the transposes under the convention the training step keeps:
the loss of a step is the SUM over a group's ranks of what each rank's
backward starts from, and a replicated parameter's gradient is the sum of
its ranks' gradients. A value that every rank of a group computes alike
(a pipeline's loss on every stage) therefore enters each rank's backward
divided by the group's size, so no gradient is counted once for each rank
(``parallel/pipeline.py``). Only the sum of the ranks' cotangents of such
a value is defined, so ``replicated`` may average them: every rank then
holds the same share, and the gradients of the parameters upstream are
the same on every rank, each rounded once.

A ``Group`` is a list of global ranks and this rank's place among them;
a group of one needs no process group, and every collective over it is
the identity, so one process runs the same code with no
``torch.distributed`` at all. Every rank of a group must issue the same
collectives in the same order, forward and backward.

On a ``gloo`` group gloo runs all-reduce, broadcast, all-gather,
reduce-scatter and all-to-all on CUDA tensors as they are
(``GLOO_CUDA``); its point-to-point send and receive take none (on the
H100 machine with torch 2.x, ``writev: Bad address`` ends the process),
so ``ppermute`` goes through a pinned host buffer: copied out, sent and
received on the host, copied back (``STATS['staged']`` names the
operations that did). 16-bit floats travel as their bytes and
``bool`` as uint8; reductions run in float32. ``STATS`` also counts
each operation's calls, bytes and host milliseconds (the wall time of the
call, waiting on peers included).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """Global ranks ``ranks`` in group order, this rank at ``index``;
    ``pg`` the process group (None for a group of one)."""
    ranks: Tuple[int, ...]
    index: int = 0
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


SELF = Group((0,), 0, None)


def world() -> Group:
    """Every rank (this process alone when no group was joined)."""
    if not dist.is_initialized():
        return SELF
    return Group(tuple(range(dist.get_world_size())), dist.get_rank(),
                 dist.group.WORLD)


STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(calls={}, bytes=0, host_ms=0.0, staged=set())


reset_stats()


# the operations gloo runs on CUDA tensors without a host copy
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather",
                       "reduce_scatter", "all_to_all"})


def _backend(group: Group) -> str:
    return dist.get_backend(group.pg)


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _run(op: str, t: torch.Tensor, group: Group, fn, reduce: bool = False,
         shape=None) -> torch.Tensor:
    """``fn(wire)`` on ``t`` as it travels over ``group``'s backend: on
    gloo, CUDA tensors through pinned host memory, 16-bit floats as their
    bytes (or float32 for a reduction), bool as uint8. Returns the result
    in ``t``'s device and dtype, of ``shape`` (default ``t``'s)."""
    t0 = time.perf_counter()
    dtype, device = t.dtype, t.device
    shape = tuple(t.shape) if shape is None else tuple(shape)
    wire = t.contiguous()
    gloo = _backend(group) == "gloo"
    bits = False
    if gloo and dtype == torch.bool:
        wire = wire.to(torch.uint8)
    elif gloo and dtype in (torch.bfloat16, torch.float16):
        bits = not reduce
        wire = wire.reshape(-1).view(torch.uint8) if bits else wire.float()
    staged = gloo and device.type == "cuda" and op not in GLOO_CUDA
    if staged:
        host = _pinned(wire)
        host.copy_(wire)
        wire = host
        STATS["staged"].add(op)
    out = fn(wire)
    if staged:
        out = out.to(device)
    if out.dtype != dtype:
        out = out.view(dtype).reshape(shape) if bits else out.to(dtype)
    STATS["calls"][op] = STATS["calls"].get(op, 0) + 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["host_ms"] += (time.perf_counter() - t0) * 1e3
    return out


# -- the raw collectives (no autograd) ---------------------------------------

def _psum(t: torch.Tensor, group: Group) -> torch.Tensor:
    if group.size == 1:
        return t

    def fn(w):
        w = w.clone()
        dist.all_reduce(w, group=group.pg)
        return w

    return _run("all_reduce", t, group, fn, reduce=True)


def _gather0(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Tiled all-gather along dim 0."""
    def fn(w):
        out = w.new_empty((group.size * w.shape[0],) + tuple(w.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, w, group=group.pg)
        return out

    return _run("all_gather", t, group, fn,
                shape=(group.size * t.shape[0],) + tuple(t.shape[1:]))


def _all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    if group.size == 1:
        return t
    return _gather0(t.movedim(dim, 0), group).movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Sum over the group, then this rank's ``1/size`` chunk along
    ``dim``."""
    if group.size == 1:
        return t
    t = t.movedim(dim, 0)

    def fn(w):
        out = w.new_empty((w.shape[0] // group.size,) + tuple(w.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, w, group=group.pg)
        return out

    return _run("reduce_scatter", t, group, fn, reduce=True).movedim(0, dim)


def _all_to_all(t: torch.Tensor, group: Group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: chunk ``j`` of ``split_dim`` goes to
    rank ``j``; the chunks received concatenate along ``concat_dim`` in
    rank order."""
    n = group.size
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    inp = torch.stack(t.chunk(n, dim=split_dim), dim=0)

    def fn(w):
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=group.pg)
        return out

    out = _run("all_to_all", inp, group, fn)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _ppermute(t: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    """Send to the rank ``shift`` places on, receive from the one
    ``shift`` places back."""
    n = group.size
    if n == 1 or shift % n == 0:
        return t
    dst = group.ranks[(group.index + shift) % n]
    src = group.ranks[(group.index - shift) % n]

    def fn(w):
        out = torch.empty_like(w)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, dst, group.pg),
            dist.P2POp(dist.irecv, out, src, group.pg)])
        for r in reqs:
            r.wait()
        return out

    return _run("ppermute", t, group, fn)


def broadcast(t: torch.Tensor, group: Group, src_index: int = 0
              ) -> torch.Tensor:
    """``t`` of the group's rank ``src_index`` on every rank of the group
    (a new tensor; no gradient)."""
    if group.size == 1:
        return t

    def fn(w):
        w = w.clone()
        dist.broadcast(w, src=group.ranks[src_index], group=group.pg)
        return w

    return _run("broadcast", t, group, fn)


def pmax(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient): the sharded
    softmax's shift, which its gradient does not depend on."""
    if group.size == 1:
        return t

    def fn(w):
        w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group.pg)
        return w

    return _run("all_reduce", t, group, fn, reduce=True)


def psum_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """In-place sum over the group (no gradient): the step's gradient
    reduction."""
    if group.size > 1:
        t.copy_(_psum(t, group))
    return t


# -- differentiable collectives ----------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, \
            None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        return broadcast(x, group, src)

    @staticmethod
    def backward(ctx, g):
        g = _psum(g, ctx.group)
        if ctx.group.index != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum``: the sum over the group on every rank."""
    if group.size == 1:
        return x
    return _PSum.apply(x, group) if _differentiable(x) else _psum(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.pmean``."""
    return psum(x, group) / group.size if group.size > 1 else x


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the ranks' tensors concatenated
    along ``dim`` in rank order."""
    if group.size == 1:
        return x
    return _AllGather.apply(x, group, dim) if _differentiable(x) \
        else _all_gather(x, group, dim)


def all_to_all(x: torch.Tensor, group: Group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``."""
    if group.size == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim) \
        if _differentiable(x) else _all_to_all(x, group, split_dim,
                                               concat_dim)


def ppermute(x: torch.Tensor, group: Group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the rotation ``i -> i + shift``."""
    if group.size == 1:
        return x
    return _PPermute.apply(x, group, shift) if _differentiable(x) \
        else _ppermute(x, group, shift)


def broadcast_from(x: torch.Tensor, group: Group, src: int) -> torch.Tensor:
    """The value of the group's rank ``src`` on every rank, its gradient
    the sum of the ranks' cotangents on ``src`` (zeros elsewhere). Every
    rank passes a tensor of the same shape and dtype (a placeholder where
    it holds no value) that requires a gradient whenever the owner's
    does, so the backward's ``psum`` runs on every rank."""
    if group.size == 1:
        return x
    return _BroadcastFrom.apply(x, group, src) if _differentiable(x) \
        else broadcast(x, group, src)

