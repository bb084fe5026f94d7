"""The serving mesh: one logical ``Engine`` with its weights and KV store
split over a list of devices.

Port of ``dalle_pytorch_tpu/serve/mesh_engine.py``. A replica on one card
cannot serve a model whose weights and page pool exceed that card;
``MeshEngine`` spreads both over ``devices`` by the rules of
``parallel/serve_specs.py`` and keeps the single engine's whole surface
(admission, chunks, the emit ring, eviction, the prefix cache, guided
pairs, speculation, migration, ``fence``, ``stats``), so the replica set,
its worker and the server drive it unchanged:

* layer i's weights are stored on the device that owns its block of the
  depth and fetched onto ``devices[0]`` when the layer runs (a copy only
  where the two devices differ: JAX's per-layer all-gather);
* the embedding tables' rows and the logits head's output columns are
  split, and each of their tensors is read whole on ``devices[0]`` (a
  concatenation) before the lookup or the product;
* the KV store is split along its heads (``ops.decode.HeadShards``):
  each shard's rows are written on its device, and a layer's read joins
  the shards' views on ``devices[0]``;
* the per-slot state, the block tables and the emit ring stay on
  ``devices[0]``, where all the arithmetic runs, and so does every
  tensor the rules leave whole.

The engine keeps only what it placed (``held``), never the caller's
tensors. The serving entry points (``cli/serve.py``, the worker) load a
mesh's model on the CPU, so that no card holds it whole.

What the joins move grows with the KV store: each decode step brings
every layer's K/V of the other shards' heads (each slot's ``total_len``
rows), their layers and their pieces of the tables onto ``devices[0]``
(``step_join_bytes`` reckons it, ``stats()['join_bytes']`` counts it),
where JAX's mesh moves only the attention output.

Every sync is data movement, and the arithmetic is the single engine's
on the same shapes, so the tokens are BYTE-IDENTICAL to the single
engine's (``tests/test_torch_mesh_engine.py``). JAX shards the attention
and the head's product and gathers their outputs; in PyTorch a product
over a slice of the heads or of the columns may take another kernel
than the whole one (a batched matmul picks its kernel by the batch
count) and round differently, so the port gathers the inputs instead.

``devices`` may repeat a device: ``["cpu", "cpu"]`` in the CPU tests,
``[cuda:0, cuda:0]`` on a host with one card. ``per_shard_bytes`` counts
the tensors each shard holds, which one card's allocator cannot tell
apart.

``paged_attn='kernel'`` is refused with the typed ``MeshPagedAttnError``,
as JAX refuses it: the mesh reads its pool through the gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import decode as decode_ops
from dalle_pytorch_tpu_torch.parallel import placement as PL
from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine


class MeshPagedAttnError(ValueError):
    """Typed refusal of ``paged_attn='kernel'`` on a mesh engine (JAX's
    ``serve_mesh_paged_attn_unsupported``): the mesh reads its
    head-split pool through the gather. ``record`` is the structured
    event."""

    def __init__(self, record: dict):
        super().__init__(
            "paged_attn='kernel' is not supported on a mesh engine: its "
            "pool is split along the heads over the mesh's devices, and "
            "kernel K4 reads one pool on one card. Use "
            "paged_attn='gather', or serve one-card replicas for the "
            "kernel path.")
        self.record = record


class _Join:
    """The pieces of one tensor joined whole on the compute device, in
    shard order (``serve_specs.replicate_sync``): data movement only.
    ``moved`` counts the bytes of the pieces past shard 0's, which a
    mesh of distinct cards carries between them (counted also where two
    shards share a card and nothing moves)."""

    def __init__(self, mesh: SS.ServeMesh):
        self.syncs = {d: SS.replicate_sync(mesh, dim=d) for d in (0, 1)}
        self.home = mesh.devices[0]
        self.moved = 0

    def __call__(self, pieces: Sequence[torch.Tensor],
                 dim: int = 0) -> torch.Tensor:
        self.moved += SS.tensor_bytes(pieces[1:])
        return self.syncs[dim](pieces)


class _Stack(nn.Module):
    """A depth-split layer stack as the engine runs it: item i is layer
    i bound to its weights on the compute device, fetched from their
    owner's device when it runs (bound once where they already lie
    there). ``layers`` are views bound to the held tensors, so the stack
    keeps no other copy of the weights."""

    def __init__(self, layers: List[nn.Module],
                 tensors: List[Dict[str, torch.Tensor]],
                 owners: List[int], join: _Join):
        super().__init__()
        bound = [layer if all(t.device == join.home for t in ts.values())
                 else None for layer, ts in zip(layers, tensors)]
        # plain attributes: the stack registers no submodules
        self.__dict__["_items"] = (list(layers), list(tensors),
                                   list(owners), join, bound)

    def __len__(self) -> int:
        return len(self._items[0])

    def __getitem__(self, i):
        layers, tensors, owners, join, bound = self._items
        if isinstance(i, slice):
            return _Stack(layers[i], tensors[i], owners[i], join)
        if owners[i] != 0:
            join.moved += SS.tensor_bytes(tensors[i].values())
        if bound[i] is not None:
            return bound[i]
        return PL.bind(layers[i], {n: t.to(join.home)
                                   for n, t in tensors[i].items()})

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class _Split(nn.Module):
    """A module whose tensors are split (an embedding's rows, the logits
    head's output columns): each of them (``weight``, or int8 ``w_q``
    and ``scale``; ``bias``) reads whole on the compute device, its
    pieces joined in order, so the model computes the single engine's
    lookup or product."""

    def __init__(self, pieces: Dict[str, Optional[List[torch.Tensor]]],
                 join: _Join):
        super().__init__()
        self.__dict__["_pieces"] = pieces
        self.__dict__["_join"] = join

    def __getattr__(self, name: str):
        pieces = self.__dict__.get("_pieces", {})
        if name in pieces:
            ps = pieces[name]
            return None if ps is None else self.__dict__["_join"](ps)
        return super().__getattr__(name)


class MeshEngine(Engine):
    """``Engine`` over ``devices`` (every visible card when None); every
    other argument, counter and method is the base engine's, less
    ``device`` (the mesh computes on ``devices[0]``)."""

    def __init__(self, model: D.DALLE, queue: S.RequestQueue, *,
                 devices: Optional[Sequence] = None, **kwargs):
        if kwargs.get("paged_attn", "gather") == "kernel":
            raise MeshPagedAttnError(S.structured_event(
                "serve_mesh_paged_attn_unsupported", paged_attn="kernel"))
        if "device" in kwargs:
            raise TypeError("MeshEngine takes devices=, not device=")
        if devices is None:
            devices = SS.visible_devices()
            if not devices:
                raise RuntimeError(
                    "no CUDA device is visible: a mesh engine runs on the "
                    "cards unless the caller passes devices=['cpu', ...]")
        self.devices = tuple(torch.device(d) for d in devices)
        self.mesh = SS.serve_mesh(self.devices)
        self.n_shards = len(self.devices)
        self.kv_sharded = False
        self.params_sharded = False
        super().__init__(model, queue, device=self.devices[0], **kwargs)

    # -- placement -----------------------------------------------------------

    def _place_model(self, model: D.DALLE) -> D.DALLE:
        """Store each tensor where the serve specs put it (``held[s]``
        what shard s holds: a split tensor's piece, the layers it owns,
        and on shard 0, where the arithmetic runs, every whole tensor)
        and return the view the engine computes with on ``devices[0]``.
        The view holds no reference to ``model``'s tensors: a caller that
        drops ``model`` leaves only ``held`` (where ``model`` lies on the
        CPU, as the serving entry points load it for a mesh, no card
        ever holds the whole model)."""
        self.param_specs = specs = SS.serve_param_specs(model, self.mesh)
        self.params_sharded = any(s != PL.REPLICATED for s in specs.values())
        tensors = SS.model_tensors(model)
        self.param_bytes = SS.tensor_bytes(tensors.values())
        depth = len(PL.stack_of(model))
        held: List[Dict[str, torch.Tensor]] = [{} for _ in self.devices]
        where: Dict[str, List[int]] = {}
        for name, t in tensors.items():
            spec = specs[name]
            own = PL.owner(name, spec, self.mesh, depth)
            where[name] = (list(range(self.n_shards))
                           if spec.dims and any(spec.dims)
                           else [0 if own is None else own])
            for s in where[name]:
                held[s][name] = PL.shard(t.detach(), name, spec, self.mesh,
                                         index=s).to(self.devices[s])
        self.held = held
        self._join = join = _Join(self.mesh)
        # every module rebound to the held tensors (a split tensor to
        # shard 0's piece until its module is replaced below)
        view = PL.bind(model, {n: held[where[n][0]][n] for n in tensors})
        owners = [0] * depth
        for n in tensors:
            if PL.layer_of(n) is not None:
                owners[PL.layer_of(n)] = where[n][0]
        per = [{n[len(f"transformer.layers.{i}."):]: t
                for n, t in held[owners[i]].items() if PL.layer_of(n) == i}
               for i in range(depth)]
        view.transformer._modules["layers"] = _Stack(
            list(view.transformer.layers), per, owners, join)
        self._split = {}
        for child, module in model._modules.items():
            own = {**module._parameters, **module._buffers}
            if any(len(where[f"{child}.{n}"]) > 1 for n in own
                   if own[n] is not None):
                self._split[child] = {
                    n: None if v is None
                    else [held[s][f"{child}.{n}"] for s in where[
                        f"{child}.{n}"]] for n, v in own.items()}
                view._modules[child] = _Split(self._split[child], join)
        return view

    def _place_kv(self, make):
        """The KV store split along its heads, one part per device, as
        ``serve_kv_specs`` places its shapes (whole on ``devices[0]``
        where the mesh size does not divide the heads)."""
        tcfg = self.cfg.transformer
        specs = SS.serve_kv_specs(make(tcfg, torch.device("meta")),
                                  self.mesh)
        if self.n_shards == 1 or not SS.kv_is_sharded(specs):
            return make(tcfg, self.devices[0])
        self.kv_sharded = True
        part = dataclasses.replace(tcfg, heads=tcfg.heads // self.n_shards)
        return decode_ops.HeadShards(
            [make(part, d) for d in self.devices], self.devices,
            join=lambda pieces: self._join(pieces, dim=1))

    def step_join_bytes(self) -> int:
        """The bytes one decode step (the gather read, no speculation)
        joins onto ``devices[0]`` from the other shards, reckoned from
        the shapes: the layers they own, their heads of every layer's
        K/V as the read takes it (each slot's ``total_len`` rows), and
        their pieces of the split tables and head, each read once a
        step. ``join_bytes`` in ``stats()`` counts what was joined."""
        _, tensors, owners, _, _ = self.model.transformer.layers._items
        layers = sum(SS.tensor_bytes(ts.values())
                     for ts, own in zip(tensors, owners) if own != 0)
        split = sum(SS.tensor_bytes(ps[1:]) for pieces in self._split.values()
                    for ps in pieces.values() if ps is not None)
        kv = 0
        for part, _, _ in decode_ops.pool_shards(self.pool)[1:]:
            for buf in part.values():
                row = buf.shape[4] if buf.dim() == 5 else 1
                kv += (buf.shape[0] * self.num_slots * buf.shape[2]
                       * self.total_len * row * buf.element_size())
        return layers + split + kv

    def kv_bytes_per_shard(self) -> int:
        """The KV bytes one device of the mesh holds."""
        part = decode_ops.pool_shards(self.pool)[0][0]
        return SS.tensor_bytes(part.values())

    def _mesh_stats(self) -> dict:
        return {
            "devices_per_replica": self.n_shards,
            "mesh_shape": SS.mesh_shape_desc(self.mesh),
            "mesh_devices": SS.mesh_device_ids(self.mesh),
            "kv_sharded": self.kv_sharded,
            "params_sharded": self.params_sharded,
            "kv_hbm_bytes_per_shard": self.kv_bytes_per_shard(),
            "param_bytes_per_shard": SS.per_shard_bytes(self.held),
            "join_bytes": self._join.moved,
        }


def hbm_report(engine: Engine) -> dict:
    """The bytes of an engine's two largest stores, the weights and the
    KV store, whole and per shard: a single engine holds both whole on
    its one device, a ``MeshEngine`` reports what one device of its mesh
    holds."""
    mesh = isinstance(engine, MeshEngine)
    params_b = engine.param_bytes if mesh \
        else SS.param_bytes(engine.model)
    kv_b = engine.kv_hbm_bytes()
    params_ps = SS.per_shard_bytes(engine.held) if mesh else params_b
    kv_ps = engine.kv_bytes_per_shard() if mesh else kv_b
    return {
        "param_bytes": params_b,
        "kv_hbm_bytes": kv_b,
        "total_bytes": params_b + kv_b,
        "param_bytes_per_shard": params_ps,
        "kv_hbm_bytes_per_shard": kv_ps,
        "total_bytes_per_shard": params_ps + kv_ps,
        "devices": engine.n_shards if mesh else 1,
    }
