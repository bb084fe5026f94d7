"""Reversible execution engine: activation memory that does not grow
with depth.

Port of ``dalle_pytorch_tpu/ops/reversible.py`` (``:55-188``), the
RevNet-style engine of the reference (``reversible.py:54-157``):

* the input is duplicated into two streams, ``x1 = x2 = x``;
* each layer computes ``y1 = x1 + f(x2)`` and ``y2 = x2 + g(y1)``, with
  ``f`` the PreNorm attention branch and ``g`` the PreNorm GEGLU branch
  (``ops/transformer.py``);
* only the final ``(y1, y2)`` is saved, and the output is their mean;
* the backward inverts each layer in reverse order, ``x2 = y2 - g(y1)``
  and then ``x1 = y1 - f(x2)``, recomputing each branch under
  ``torch.enable_grad()`` and taking its cotangents with
  ``torch.autograd.grad``. Dropout replays from the same explicit keys
  (``_layer_keys``), as JAX's stateless keys make it do.

The layers' parameters are inputs of the ``torch.autograd.Function``,
and its backward returns their gradients, so ``loss.backward()``,
``torch.autograd.grad(loss, params)`` and ``accumulate_grads`` all see
them. On the flash path each layer's backward recomputes ``f``'s
forward: a step launches K1 twice a layer and K2a and K2b once each.
Dense and sparse layers go by the per-layer Python bool of
``cfg.sparse_pattern``, as the sequential loop does. Under fsdp each
layer's weights are fetched from their owner in the forward and again
in the backward's recompute (``placement.fetch_leaves``), and their
gradients summed over the group into the owner's parameters; under tp
the branches' sums over the group run in both. In bfloat16 the
inversion loses bits (``x2 = y2 - g(y1)`` rounds), as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from dalle_pytorch_tpu_torch.parallel import placement as PL


def _branches(cfg, keys, mask, train):
    """f(layer, i, h) and g(layer, i, h): layer i's attention and
    feed-forward branches under its dropout keys."""
    # ops/transformer.py imports this module
    from dalle_pytorch_tpu_torch.ops import transformer as T
    pattern = cfg.sparse_pattern

    def key(i, j):
        return keys[i][j] if train else None

    def f(layer, i, h):
        return T.attn_branch(layer, h, mask, cfg, key(i, 0), train,
                             is_sparse=pattern[i])

    def g(layer, i, h):
        return T.ff_branch(layer, h, cfg, key(i, 1), train)

    return f, g


def _grad_params(module: torch.nn.Module) -> list:
    return [p for p in module.parameters() if p.requires_grad]


def _branch_grads(layer, view, sub: str, fn, h, dy):
    """(dh, {id(param): gradient}) of branch ``fn`` of ``view`` (layer
    ``layer``'s weights, fetched) at ``h`` against ``dy``. Under fsdp the
    view's weights are leaves fetched from their owner: their gradients
    are summed over the group into the owner's parameters."""
    with torch.enable_grad():
        h = h.detach().requires_grad_()
        ps = _grad_params(getattr(view, sub))
        out = fn(view, h)
        dh, *dps = torch.autograd.grad(out, [h] + ps, dy, allow_unused=True)
    owned = _grad_params(getattr(layer, sub))
    if view is not layer:
        dps = PL.owner_grads(layer, ps, dps)
    return dh, out.detach(), dict(zip(map(id, owned), dps or []))


class _RevSequence(torch.autograd.Function):
    """x -> mean of the two streams after every layer; the parameters
    this rank stores follow as inputs so their gradients come back from
    ``backward``."""

    @staticmethod
    def forward(ctx, x, model, cfg, keys, mask, train, *params):
        f, g = _branches(cfg, keys, mask, train)
        x1 = x2 = x
        for i in range(cfg.depth):
            view = PL.fetch_layer(model.layers[i])
            x1 = x1 + f(view, i, x2)
            x2 = x2 + g(view, i, x1)
        ctx.save_for_backward(x1, x2, keys, mask)
        ctx.model, ctx.cfg, ctx.train = model, cfg, train
        ctx.params = params
        return (x1 + x2) * 0.5

    @staticmethod
    def backward(ctx, dout):
        y1, y2, keys, mask = ctx.saved_tensors
        model, cfg = ctx.model, ctx.cfg
        f, g = _branches(cfg, keys, mask, ctx.train)
        dy1 = dy2 = dout * 0.5
        grads = {}
        for i in reversed(range(cfg.depth)):
            layer = model.layers[i]
            view = PL.fetch_leaves(layer)
            # invert g: x2 = y2 - g(y1); cotangents into (y1, ff params)
            dh, out, dps = _branch_grads(
                layer, view, "ff", lambda v, h: g(v, i, h), y1, dy2)
            x2 = y2 - out
            dy1 = dy1 + dh
            grads.update(dps)
            # invert f: x1 = y1 - f(x2); cotangents into (x2, attn params)
            dh, out, dps = _branch_grads(
                layer, view, "attn", lambda v, h: f(v, i, h), x2, dy1)
            x1 = y1 - out
            dy2 = dy2 + dh
            grads.update(dps)
            y1, y2 = x1, x2
        return (dy1 + dy2, None, None, None, None, None,
                *(grads.get(id(p)) for p in ctx.params))


def reversible_apply(model, x: torch.Tensor, *, cfg,
                     mask: Optional[torch.Tensor] = None,
                     rng: Optional[torch.Tensor] = None,
                     train: bool = False) -> torch.Tensor:
    """The reversible stack on x (b, n, dim): duplicate the stream, run
    the layers, average the streams (reference
    ``ReversibleSequence.forward``). ``model`` is an
    ``ops/transformer.py::Transformer``."""
    from dalle_pytorch_tpu_torch.ops import transformer as T
    keys = T._layer_keys(rng, cfg.depth, x.device)
    return _RevSequence.apply(x, model, cfg, keys, mask, train,
                              *[p for p in model.layers.parameters()
                                if not p.is_meta])
