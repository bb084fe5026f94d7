"""Serve-side partition rules: one decode engine over a list of devices.

Port of ``dalle_pytorch_tpu/parallel/serve_specs.py``. The serving mesh
(``serve/mesh_engine.py``) must emit tokens BYTE-IDENTICAL to the single
engine's, so its rules split only what is stored and never what is
summed:

* a transformer layer's parameters split the stack's DEPTH
  (``placement.Spec(layers=SERVE_AXIS)``): layer i lives on its owner's
  device and is fetched whole before it runs;
* the KV store, the dense slot cache ``(depth, slots, heads, len, dh)``
  or the page pool ``(depth, pages, heads, page_size, dh)`` with its int8
  scale pages, splits its HEADS (dim 2) when the mesh size divides them;
* the embedding tables split their vocab ROWS and the logits head its
  OUTPUT columns (``Spec(dims=(SERVE_AXIS,))``: dim 0 of the torch
  tensor in both cases), each when the mesh size divides it;
* everything else, and everything the host touches (per-slot state,
  block tables, the emit ring), stays whole on the first device.

JAX reaches the devices through GSPMD and one mesh axis; the port is one
process over a device list, so a ``ServeMesh`` carries the list and
answers ``size``/``axis_names`` as ``parallel/mesh.py``'s rank mesh
does, which lets ``placement``'s ``Spec``, ``owner``, ``split`` and
``shard`` serve both. A dimension the mesh size does not divide stays
whole: an odd config costs memory, never correctness.

``visible_devices`` is the one place the replica set, the worker and the
server list the devices a mesh may take.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from dalle_pytorch_tpu_torch.parallel import placement as PL

# the serving model-parallel axis: every split tensor splits one dim
SERVE_AXIS = "mp"


def visible_devices() -> List[torch.device]:
    """The cards this process sees, in index order (empty without
    CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ServeMesh:
    """A one-axis mesh over ``devices`` (which may repeat one device):
    the surface ``placement``'s helpers read (``size``, ``axis_names``),
    with no ranks and no process groups."""

    def __init__(self, devices: Sequence, axis: str = SERVE_AXIS):
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    def size(self, axis) -> int:
        return len(self.devices) if axis == self.axis else 1

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}


def serve_mesh(devices: Sequence, axis: str = SERVE_AXIS) -> ServeMesh:
    return ServeMesh(devices, axis)


def slice_devices(devices: Sequence, index: int,
                  per_replica: int) -> Tuple:
    """Replica ``index``'s devices: the host's devices split into
    ``len(devices) // m`` slices that do not overlap, and replica
    ``index`` takes slice ``index % n_slices`` (``per_replica=1`` is the
    single-card ``devices[i % n]``). Raises only where the host cannot
    hold one slice."""
    m = int(per_replica)
    if m < 1:
        raise ValueError(f"devices_per_replica must be >= 1, got {m}")
    n_slices = len(devices) // m
    if n_slices < 1:
        raise ValueError(
            f"a {m}-device mesh slice does not fit this host: only "
            f"{len(devices)} device(s) visible")
    lo = (index % n_slices) * m
    return tuple(devices[lo:lo + m])


def _div(n: int, mesh: ServeMesh) -> bool:
    return n % mesh.size(mesh.axis) == 0


def model_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` by name (an int8 model's
    weights are buffers)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def serve_param_specs(model: nn.Module, mesh: ServeMesh) -> Dict[str,
                                                                 PL.Spec]:
    """A ``placement.Spec`` per tensor of a port ``DALLE`` under the
    serve rules (module docstring): ``transformer.layers.{i}.…`` split
    the depth, ``text_emb``/``image_emb`` their rows, the logits head
    (``logits_proj``'s weight, int8 ``w_q``, ``scale`` and bias) its
    output columns; the rest whole."""
    ax = mesh.axis
    depth = len(PL.stack_of(model))
    specs = {}
    for name, t in model_tensors(model).items():
        spec = PL.REPLICATED
        if PL.layer_of(name) is not None and _div(depth, mesh):
            spec = PL.Spec(layers=ax)
        elif name.startswith("logits_proj.") and t.dim() >= 1 \
                and _div(t.shape[0], mesh):
            spec = PL.Spec(dims=(ax,))
        elif name in ("text_emb.weight", "image_emb.weight") \
                and _div(t.shape[0], mesh):
            spec = PL.Spec(dims=(ax,))
        specs[name] = spec
    return specs


def kv_heads_shard(heads: int, mesh_size: int) -> bool:
    """THE predicate for splitting a KV store: heads split iff the mesh
    size divides them. ``serve_kv_specs`` (the live pool) and the
    replica set's config-only model (``ReplicaSet._kv_bytes_per_shard``)
    share it, so the two never drift."""
    return int(mesh_size) > 0 and heads % int(mesh_size) == 0


def serve_kv_specs(cache: Dict[str, torch.Tensor],
                   mesh: ServeMesh) -> Dict[str, PL.Spec]:
    """A ``Spec`` per buffer of a KV store (dense cache or page pool,
    int8 scales included): heads sit at dim 2 in both layouts."""
    m = mesh.size(mesh.axis)
    return {k: (PL.Spec(dims=(None, None, mesh.axis))
                if kv_heads_shard(buf.shape[2], m) else PL.REPLICATED)
            for k, buf in cache.items()}


def kv_is_sharded(specs: Dict[str, PL.Spec]) -> bool:
    return any(s != PL.REPLICATED for s in specs.values())


def replicate_sync(mesh: ServeMesh, dim: int) -> Callable:
    """The gather of per-device pieces along ``dim`` onto the mesh's
    first device, in device order: data movement only."""
    home = mesh.devices[0]

    def sync(pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(pieces) == 1:
            return pieces[0].to(home)
        return torch.cat([p.to(home) for p in pieces], dim=dim)

    return sync


def tensor_bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def per_shard_bytes(held: Sequence[Dict[str, torch.Tensor]]) -> int:
    """Bytes ONE device of the mesh stores: the tensors the first shard
    holds (``held[s]`` what shard s holds: whole tensors, its pieces and
    the layers it owns). Counted tensor by tensor, as JAX's
    ``shard_shape`` model counts, so two shards on one card stay apart."""
    return tensor_bytes(held[0].values())


def param_bytes(model: nn.Module) -> int:
    """Total parameter bytes of the model."""
    return tensor_bytes(model_tensors(model).values())


def mesh_shape_desc(mesh: ServeMesh) -> Dict[str, int]:
    """``{axis: size}``: the /stats ``mesh_shape`` field."""
    return dict(mesh.shape)


def mesh_device_ids(mesh: ServeMesh) -> List[str]:
    """The devices by name (``cuda:0``), in mesh order."""
    return [str(d) for d in mesh.devices]
