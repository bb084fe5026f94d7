"""Int8 weights for the decode path.

Port of ``dalle_pytorch_tpu/ops/quant.py`` (``:30-55``). A linear's
weight is stored as int8 with one float32 scale per output channel
(symmetric: ``scale = max(max|w| / 127, 1e-12)`` over the contraction
axis), in a ``QuantLinear`` module in place of the ``nn.Linear``;
``core.linear`` applies it with JAX's order of operations (the int8
weight cast to the activation dtype, the product, then the scale in the
activation dtype). The int8 values are exact in bfloat16 (|q| <= 127),
so the only error is the rounding of w to its nearest scale multiple.

Inference only: a ``QuantLinear`` holds buffers, not parameters, and
``quantize_module_int8`` returns a quantized copy, never a checkpoint.
Only modules whose linears ``core.linear`` applies are quantized:
embedding tables are gathered by row and keep their weights
(``models/dalle.py::quantize_for_decode`` picks the transformer and the
vocabulary head, as the JAX function does).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn


class QuantLinear(nn.Module):
    """``w_q`` int8 (out, in), ``scale`` float32 (out,), ``bias`` in the
    stored dtype or None: the JAX ``{"w_q", "scale", ["b"]}`` leaf."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


def quantize_linear_int8(p: nn.Linear) -> QuantLinear:
    """Per-output-channel symmetric int8 of ``p.weight`` (out, in)."""
    w = p.weight.detach().float()
    scale = torch.clamp(w.abs().amax(dim=-1) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    bias = None if p.bias is None else p.bias.detach().clone()
    return QuantLinear(w_q.to(torch.int8), scale, bias)


def quantize_module_int8(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every ``nn.Linear`` inside it (or itself)
    replaced by its ``QuantLinear``; every other module is copied as it
    is (``quantize_tree_int8``)."""
    if isinstance(module, nn.Linear):
        return quantize_linear_int8(module)
    out = copy.deepcopy(module)
    for name, child in list(out.named_modules()):
        if not isinstance(child, nn.Linear):
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = out.get_submodule(parent_name) if parent_name else out
        setattr(parent, attr, quantize_linear_int8(child))
    return out
