"""Where each parameter lives across the ranks of a mesh, and the module
views that run on those pieces.

What JAX says with a ``PartitionSpec`` per leaf of a depth-stacked tree
and leaves to GSPMD, the port says with a ``Spec`` per parameter name
and carries out itself:

* ``Spec.layers`` names the axis that splits the stack's depth into
  contiguous blocks of layers (JAX's spec on the leading depth axis:
  ``fsdp``, or a pipeline's ``pp``). A rank stores the layers of its
  block; the others sit on the meta device. Where every rank of the
  group runs every layer (fsdp), a layer's weights reach the group from
  their owner before it runs (``fetch_layer``: one broadcast of the
  layer's weights as one buffer, whose transpose sums the group's
  cotangents into the owner). A pipeline's stages each run only their
  own layers (``Spec.staged``) and fetch nothing.
* ``Spec.dims`` names, per dimension of the torch tensor, the axis that
  splits it (None: whole). A dimension that fuses several blocks is
  split block by block (``fused_parts``): the qkv projection's rows are
  q, k and v, and a tensor-parallel rank takes its heads' rows of each
  third; GEGLU's ``w1`` rows are the hidden half and the gates half, and
  the rank takes its slice of each. JAX's spec on such a dimension only
  places it; the computation GSPMD compiles is the one these pieces run.

``attach`` tells the modules which group their pieces span
(``Attention.tp``, ``FeedForward.tp``, ``MoE.ep``, the head's ``tp``,
a layer's ``fsdp``), and the ops read it: ``ops/attention.py`` runs the
rank's heads and sums the row-parallel product over ``tp`` before the
bias, ``ops/transformer.py`` the GEGLU likewise, ``ops/moe.py`` its
experts, ``models/dalle.py`` the column-parallel head's softmax.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from dalle_pytorch_tpu_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class Spec:
    """The placement of one parameter: ``layers`` the axis splitting the
    stack's depth (a layer's parameters only), ``dims`` the axis
    splitting each dimension of the torch tensor, None where whole
    (missing trailing entries are None); ``staged`` where each rank of
    ``layers`` runs only the layers it stores (a pipeline's stages),
    else every rank runs every layer and fetches it from its owner."""
    layers: Optional[str] = None
    dims: Tuple[Optional[str], ...] = ()
    staged: bool = False

    def dim(self, i: int) -> Optional[str]:
        return self.dims[i] if i < len(self.dims) else None

    def axes(self) -> frozenset:
        return frozenset(a for a in (self.layers, *self.dims) if a)


REPLICATED = Spec()

_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def layer_of(name: str) -> Optional[int]:
    """The stack layer a parameter name belongs to (None: not a layer's)."""
    m = _LAYER.search(name)
    return int(m.group(1)) if m else None


def fused_parts(name: str) -> int:
    """How many blocks the split dimension of ``name`` fuses: 3 for the
    qkv projection, 2 for GEGLU's ``w1`` (hidden, gates), else 1."""
    if name.endswith("attn.qkv.weight"):
        return 3
    if name.endswith("ff.w1.weight") or name.endswith("ff.w1.bias"):
        return 2
    return 1


def spec_of(specs: Optional[dict], name: str) -> Spec:
    return (specs or {}).get(name) or REPLICATED


def split(t: torch.Tensor, dim: int, parts: int, size: int,
          index: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s piece of ``t`` along ``dim``: its
    ``1/size`` slice of each of the ``parts`` blocks, concatenated."""
    n = t.shape[dim]
    if n % (parts * size):
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {parts} x {size} pieces")
    blocks = t.reshape(*t.shape[:dim], parts, size, n // (parts * size),
                       *t.shape[dim + 1:])
    return blocks.select(dim + 1, index).reshape(
        *t.shape[:dim], n // size, *t.shape[dim + 1:])


def unsplit(gathered: torch.Tensor, dim: int, parts: int,
            size: int) -> torch.Tensor:
    """The whole tensor from the ranks' pieces concatenated along ``dim``
    in rank order (``split``'s inverse)."""
    n = gathered.shape[dim]
    blocks = gathered.reshape(*gathered.shape[:dim], size, parts,
                              n // (parts * size),
                              *gathered.shape[dim + 1:])
    return blocks.transpose(dim, dim + 1).reshape(gathered.shape)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's piece of a tensor of ``shape``."""
    return tuple(s // mesh.size(spec.dim(i)) for i, s in enumerate(shape))


def check(model: nn.Module, specs: dict, mesh) -> None:
    """``ValueError`` for a spec that names a parameter the model lacks,
    or a dimension (each of its fused blocks) or a depth its mesh axis
    does not divide (JAX refuses such a placement when it puts the
    array)."""
    names = dict(model.named_parameters())
    for name, spec in specs.items():
        if name not in names:
            raise ValueError(f"param spec for {name!r}, which the model "
                             "does not have")
        p = names[name]
        if spec is None:
            continue
        for i, a in enumerate(spec.dims):
            n = mesh.size(a)
            if a and p.shape[i] % (n * fused_parts(name)):
                raise ValueError(
                    f"{name}: dimension {i} of size {p.shape[i]} does not "
                    f"split over mesh axis {a!r} of size {n}")
        if spec.layers:
            depth = len(stack_of(model))
            n = mesh.size(spec.layers)
            if depth % n:
                raise ValueError(f"{name}: depth {depth} does not split "
                                 f"over mesh axis {spec.layers!r} of size "
                                 f"{n}")


def stack_of(model: nn.Module):
    """The layers of a DALLE's (or a bare ``Transformer``'s) stack."""
    return getattr(model, "transformer", model).layers


def owner(name: str, spec: Spec, mesh, depth: int) -> Optional[int]:
    """The rank (on ``spec.layers``) storing a layer parameter split over
    the depth; None for one every rank stores."""
    if not spec.layers or mesh.size(spec.layers) == 1:
        return None
    return layer_of(name) // (depth // mesh.size(spec.layers))


def shard(t: torch.Tensor, name: str, spec: Spec, mesh,
          index: Optional[int] = None) -> torch.Tensor:
    """This rank's piece of the whole ``t`` (every split dimension); on a
    one-axis mesh of devices in one process (``parallel/serve_specs.py``)
    the piece of the device at ``index``."""
    for i in range(t.dim()):
        a = spec.dim(i)
        if a and mesh.size(a) > 1:
            t = split(t, i, fused_parts(name), mesh.size(a),
                      mesh.index(a) if index is None else index)
    return t.contiguous()


def gather(t: torch.Tensor, name: str, spec: Spec, mesh,
           own: Optional[int]) -> torch.Tensor:
    """The whole tensor from the ranks' pieces (no gradient): the owner's
    piece over ``spec.layers`` (``t`` a placeholder elsewhere), then the
    split dimensions gathered. Every rank of those groups calls it."""
    t = t.detach()
    if own is not None:
        t = col.broadcast(t, mesh.group(spec.layers), own)
    for i in range(t.dim()):
        a = spec.dim(i)
        if a and mesh.size(a) > 1:
            t = unsplit(col.all_gather(t, mesh.group(a), dim=i), i,
                        fused_parts(name), mesh.size(a))
    return t


# -- the modules' groups -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Owner:
    """A layer stored on one rank of ``group`` (``index``) and fetched by
    every rank that runs it; ``device`` where the placeholders go."""
    group: col.Group
    index: int
    device: torch.device


def _pair(specs, prefix: str, col_name: str, row_name: str,
          what: str) -> Optional[str]:
    """The axis of a column-parallel / row-parallel pair (None: whole),
    ``ValueError`` when the two are not split over the same axis."""
    c = spec_of(specs, f"{prefix}{col_name}")
    r = spec_of(specs, f"{prefix}{row_name}")
    if c.dim(0) != r.dim(1) or c.dim(1) or r.dim(0):
        raise ValueError(f"{what} {prefix!r}: {col_name} {c.dims} and "
                         f"{row_name} {r.dims} are not a column-parallel "
                         "and row-parallel pair over one axis")
    return c.dim(0)


def attach(model: nn.Module, specs: dict, mesh) -> None:
    """Tell each module of ``model`` the groups its pieces span."""
    stack = stack_of(model)
    depth = len(stack)
    base = "transformer." if hasattr(model, "transformer") else ""
    dev = next(p.device for p in model.parameters() if not p.is_meta)
    for i, layer in enumerate(stack):
        pre = f"{base}layers.{i}."
        tp = _pair(specs, pre, "attn.qkv.weight", "attn.out.weight",
                   "attention")
        if tp and mesh.size(tp) > 1:
            layer.attn.tp = mesh.group(tp)
        if hasattr(layer.ff, "moe"):
            e1 = spec_of(specs, pre + "ff.moe.w1").dim(0)
            e2 = spec_of(specs, pre + "ff.moe.w2").dim(0)
            if e1 != e2:
                raise ValueError(f"MoE {pre!r}: w1 over {e1!r} and w2 over "
                                 f"{e2!r}")
            if e1 and mesh.size(e1) > 1:
                layer.ff.moe.ep = mesh.group(e1)
        else:
            tp = _pair(specs, pre, "ff.w1.weight", "ff.w2.weight",
                       "feed-forward")
            if spec_of(specs, pre + "ff.w1.bias").dim(0) != tp:
                raise ValueError(f"feed-forward {pre!r}: w1's bias is not "
                                 "split with its weight")
            if tp and mesh.size(tp) > 1:
                layer.ff.tp = mesh.group(tp)
        axes = {(spec_of(specs, pre + n).layers,
                 spec_of(specs, pre + n).staged)
                for n, _ in layer.named_parameters()}
        if len(axes) != 1:
            raise ValueError(f"layer {i}: its parameters split the depth "
                             f"over different axes {sorted(map(str, axes))}")
        ax, staged = axes.pop()
        if ax and not staged and mesh.size(ax) > 1:
            layer.fsdp = Owner(mesh.group(ax), i // (depth // mesh.size(ax)),
                               dev)
    if hasattr(model, "logits_proj"):
        w = spec_of(specs, "logits_proj.weight")
        b = spec_of(specs, "logits_proj.bias")
        if w.dim(1) or w.dim(0) != b.dim(0):
            raise ValueError(f"logits head: weight {w.dims} and bias "
                             f"{b.dims} are not one column-parallel split")
        if w.dim(0) and mesh.size(w.dim(0)) > 1:
            model.logits_proj.tp = mesh.group(w.dim(0))


# -- fetching a layer ------------------------------------------------------------

def bind(module: nn.Module, tensors: Dict[str, torch.Tensor],
         prefix: str = "") -> nn.Module:
    """A view of ``module`` whose parameters are ``tensors`` (by name),
    and whose buffers are too where ``tensors`` names them (an int8
    layer's weights are buffers): a shallow copy of each submodule,
    attributes kept, the module's own tensors untouched."""
    out = copy.copy(module)
    out.__dict__ = dict(module.__dict__)
    out._parameters = {n: None if v is None else tensors[prefix + n]
                       for n, v in module._parameters.items()}
    out._buffers = {n: tensors.get(prefix + n, v)
                    for n, v in module._buffers.items()}
    out._modules = {n: bind(m, tensors, f"{prefix}{n}.")
                    for n, m in module._modules.items()}
    return out


def fetch_layer(layer: nn.Module) -> nn.Module:
    """``layer`` with its weights on every rank of its fsdp group: the
    owner's parameters as one buffer through ``collectives.
    broadcast_from`` (the others pass a placeholder of zeros, which
    requires a gradient while gradients are recorded, so that every
    rank's backward sums its cotangents into the owner's parameters).
    A layer stored whole is returned as it is."""
    own = getattr(layer, "fsdp", None)
    if own is None or own.group.size == 1:
        return layer
    named = list(layer.named_parameters())
    dtypes = {p.dtype for _, p in named}
    if len(dtypes) != 1:
        raise ValueError(f"fsdp fetches a layer of one dtype, got "
                         f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    grad = torch.is_grad_enabled() and any(p.requires_grad for _, p in named)
    if own.group.index == own.index:
        flat = torch.cat([p.reshape(-1) for _, p in named])
    else:
        flat = torch.zeros(sum(p.numel() for _, p in named), dtype=dtype,
                           device=own.device, requires_grad=grad)
    flat = col.broadcast_from(flat, own.group, own.index)
    tensors, off = {}, 0
    for n, p in named:
        tensors[n] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return bind(layer, tensors)


def fetch_leaves(layer: nn.Module) -> nn.Module:
    """``layer`` with its weights on every rank of its fsdp group as
    leaves of no graph (each requires a gradient where its parameter
    does): the reversible stack's backward differentiates its branches
    against them and hands the gradients to ``owner_grads``. A layer
    stored whole is returned as it is."""
    own = getattr(layer, "fsdp", None)
    if own is None or own.group.size == 1:
        return layer
    with torch.no_grad():
        view = fetch_layer(layer)
    tensors = {n: t.detach().requires_grad_(p.requires_grad)
               for (n, t), (_, p) in zip(view.named_parameters(),
                                         layer.named_parameters())}
    return bind(layer, tensors)


def owner_grads(layer: nn.Module, leaves, grads) -> list:
    """The gradients of ``fetch_leaves``' ``leaves`` summed over the
    layer's fsdp group (one buffer): the owner's gradients of its
    parameters, None on the other ranks."""
    own = layer.fsdp
    flat = torch.cat([(g if g is not None else torch.zeros_like(t))
                      .reshape(-1) for t, g in zip(leaves, grads)])
    flat = col.psum(flat, own.group)
    if own.group.index != own.index:
        return [None] * len(leaves)
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def replica_axes(specs: Optional[dict], mesh, skip: Iterable) -> Tuple:
    """The mesh axes (in mesh order) that split some parameter but not
    the batch or the sequence: every rank of one of them sees the same
    rows and computes the same loss (tp, fsdp, ep)."""
    named = set()
    for s in (specs or {}).values():
        if s is not None:
            named |= s.axes()
    skip = set(skip)
    return tuple(a for a in mesh.axis_names
                 if a in named and a not in skip and mesh.size(a) > 1)


def splits(specs: Optional[dict], mesh) -> bool:
    """Whether ``specs`` split any parameter over an axis of ``mesh``."""
    return any(mesh.size(a) > 1 for s in (specs or {}).values()
               if s is not None for a in s.axes())
