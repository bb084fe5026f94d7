"""Mixture-of-Experts feed-forward: top-k routing over dense one-hot
dispatch and combine tensors.

Port of ``dalle_pytorch_tpu/ops/moe.py`` (``:38-119``): ``MoEConfig``,
the parameters (``MoE``: a bias-free f32-run router and expert-stacked
GEGLU weights, ``w1`` (E, d, 2h) and ``w2`` (E, h, d) in the JAX
layout, so weights cross over as they are) and ``moe_apply``.

Each batch row routes its n tokens on its own, as the JAX ``vmap`` over
rows does (GShard's groups): capacity ``C = max(1, int(ceil(n*k/E) *
capacity_factor))`` a row, the router in f32, top-k gates renormalised,
first-come queue positions by cumsum, and tokens over an expert's
capacity dropped (the residual still carries them). The Switch aux loss
``E * sum_e(top1_frac_e * mean_prob_e)`` is averaged over rows in f32.
The dispatch and combine tensors are (b, n, E, C): the k axis is summed
out before the queue positions are applied, so no (b, n, k, E, C)
tensor is built.

Expert parallelism (``moe_param_specs``, ``parallel/placement.py``): a
rank of the ``ep`` group stores experts ``[r E/ep, (r+1) E/ep)`` of each
stack (``MoE.ep`` names the group). Every rank holds the same tokens
and the same router, so the routing, the capacity and the aux are the
same on every rank; a rank runs its experts on their queues and the
combine is one ``psum`` over ``ep``. Under the training step's
convention (``parallel/collectives.py``) the input's cotangent from the
local experts is a partial sum that the replicated parameters' gradient
sum over ``ep`` completes, and the aux, computed alike on every rank,
enters each rank's share of the loss once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    num_experts: int = 8
    k: int = 2                       # experts per token
    ff_mult: int = 4
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.k > self.num_experts:
            raise ValueError(
                f"k={self.k} experts per token exceeds num_experts="
                f"{self.num_experts}")


class MoE(nn.Module):
    """The JAX ``moe_init`` tree: ``router`` (an ``nn.Linear`` without
    bias), ``w1`` (E, d, 2h) and ``w2`` (E, h, d); ``ep`` the group its
    expert stacks are split over (None: all experts here)."""

    ep = None

    def __init__(self, cfg: MoEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        hidden = cfg.dim * cfg.ff_mult
        e = cfg.num_experts
        self.router = nn.Linear(cfg.dim, e, bias=False, **kw)
        self.w1 = nn.Parameter(torch.empty((e, cfg.dim, hidden * 2), **kw))
        self.w2 = nn.Parameter(torch.empty((e, hidden, cfg.dim), **kw))

    @torch.no_grad()
    def init_experts_(self, g: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) per expert, as ``core.linear_init`` (the
        router is an ``nn.Linear``: ``core.init_params_`` covers it and
        calls this for the rest)."""
        core.uniform_fan_in_(self.w1, self.w1.shape[1], g)
        core.uniform_fan_in_(self.w2, self.w2.shape[1], g)


def moe_init(cfg: MoEConfig, g: torch.Generator, *, device=None,
             dtype=None) -> MoE:
    """Seeded random ``MoE`` parameters from generator ``g``."""
    m = MoE(cfg, device=device, dtype=dtype)
    core.init_params_(m, g)
    return m


def capacity(cfg: MoEConfig, n: int) -> int:
    """Queue slots per expert for a row of ``n`` tokens, at least 1 (a
    0-wide queue would drop every token)."""
    return max(1, int(-(-n * cfg.k // cfg.num_experts)
                      * cfg.capacity_factor))


def route(p: MoE, x: torch.Tensor, cfg: MoEConfig):
    """The router's decisions for x (b, n, d): (dispatch (b, n, E, C)
    f32 0/1, combine (b, n, E, C) f32 gate weights, aux scalar f32)."""
    e, k = cfg.num_experts, cfg.k
    cap = capacity(cfg, x.shape[1])
    logits = core.linear(p.router, x.float())
    probs = torch.softmax(logits, dim=-1)                       # (b, n, E)
    # a stable descending sort keeps the lower expert first on ties, as
    # lax.top_k does
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]                     # (b, n, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = torch.nn.functional.one_hot(idx, e).float()        # (b,n,k,E)
    chosen = onehot.sum(dim=2)                                  # (b, n, E)
    ranks = torch.cumsum(chosen, dim=1) - chosen    # first-come positions
    kept = onehot * (ranks < cap)[:, :, None, :].float()
    pos = (ranks[..., None] == torch.arange(
        cap, device=x.device, dtype=ranks.dtype)).float()      # (b,n,E,C)
    # top-k experts are distinct: at most one k term per (token, expert)
    dispatch = kept.sum(dim=2)[..., None] * pos
    combine = (kept * gate[..., None]).sum(dim=2)[..., None] * pos
    aux = e * (onehot[:, :, 0].mean(dim=1) * probs.mean(dim=1)).sum(dim=-1)
    return dispatch, combine, aux.mean()


def moe_apply(p: MoE, x: torch.Tensor, *,
              cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, n, d) -> (out (b, n, d), aux load-balance loss, f32). Over
    an ``ep`` group this rank's experts run and their outputs are summed
    over the group."""
    cdt = x.dtype
    dispatch, combine, aux = route(p, x, cfg)
    ep = p.ep or col.SELF
    if ep.size > 1:
        e = cfg.num_experts // ep.size
        mine = slice(ep.index * e, (ep.index + 1) * e)
        dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]
    xin = torch.einsum("btec,btd->becd", dispatch.to(cdt), x)  # (b,E,C,d)
    h = torch.einsum("becd,edf->becf", xin, p.w1.to(cdt))
    h, gates = h.chunk(2, dim=-1)
    h = h * core.gelu(gates)
    eout = torch.einsum("becf,efd->becd", h, p.w2.to(cdt))
    if ep.size == 1:
        return torch.einsum("btec,becd->btd", combine.to(cdt), eout), aux
    # the ranks' partial combines of the same cdt operands as the one
    # process's, accumulated and summed in float32, rounded once
    out = torch.einsum("btec,becd->btd", combine.to(cdt).float(),
                       eout.float())
    return col.psum(out, ep).to(cdt), aux


def moe_param_specs(axis: str = "ep") -> dict:
    """{parameter name within an ``MoE``: ``placement.Spec``}: the expert
    stacks split over ``axis`` on their expert dimension, the router
    whole (JAX's ``moe_param_specs``, ``ops/moe.py:127-132``)."""
    from dalle_pytorch_tpu_torch.parallel.placement import Spec
    return {"router.weight": Spec(), "w1": Spec(None, (axis, None, None)),
            "w2": Spec(None, (axis, None, None))}
