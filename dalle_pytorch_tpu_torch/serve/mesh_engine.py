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
* the KV store is split along its heads (``ops.decode.HeadShards``):
  each shard's rows are written on its device, and each shard attends
  over its own heads there; only the attention outputs are joined on
  ``devices[0]``, before the out projection (JAX's ``out_sync``);
* the logits head's output columns are split: each shard computes its
  columns' logits on its device, and they are joined along the
  vocabulary on ``devices[0]`` before sampling (JAX's ``_logits_sync``,
  the engine's ``_logits`` seam);
* the embedding tables' rows are split: each shard looks up the ids on
  its device (its own rows, the others' clamped into range), and the
  looked-up rows are gathered on ``devices[0]``, each id's from its
  owner (data movement: a whole-table lookup's values);
* the per-slot state, the block tables and the emit ring stay on
  ``devices[0]``, where the rest of the arithmetic runs, and so does
  every tensor the rules leave whole.

The engine keeps only what it placed (``held``), never the caller's
tensors. The serving entry points (``cli/serve.py``, the worker) load a
mesh's model on the CPU, so that no card holds it whole.

What reaches ``devices[0]`` in a decode step is the other shards'
layers, their heads' attention outputs (each slot's W fresh rows, not
its ``total_len`` cached ones), their logits' columns and their
looked-up embedding rows (``step_join_bytes`` reckons it,
``stats()['join_bytes']`` counts it). No cached K/V row leaves its
device in a decode step; a page's copy (the prefix cache's snapshot)
is joined whole at admission.

Every sync is data movement, and no summed dimension is ever split, so
the mesh computes the single engine's arithmetic; a product over a
slice of the heads or of the columns may still round in the last bit
where the whole one does not (PyTorch's batched matmul can pick its
kernel by the batch count), so the mesh is held to the single engine by
its tokens (``tests/test_torch_mesh_engine.py``), as the port is held
to JAX.

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
from dalle_pytorch_tpu_torch.ops import core
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
    """The pieces of one tensor joined on the compute device, in shard
    order (``serve_specs.replicate_sync``): data movement only.
    ``moved`` counts the bytes of the pieces past shard 0's, which a
    mesh of distinct cards carries between them (counted also where two
    shards share a card and nothing moves)."""

    def __init__(self, mesh: SS.ServeMesh):
        self.mesh = mesh
        self.home = mesh.devices[0]
        self.moved = 0

    def __call__(self, pieces: Sequence[torch.Tensor],
                 dim: int = 0) -> torch.Tensor:
        self.moved += SS.tensor_bytes(pieces[1:])
        return SS.replicate_sync(self.mesh, dim)(pieces)


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


class _Rows:
    """An embedding table split by rows, as the models read it:
    ``rows[ids]`` looks the ids up on every shard's device (each shard
    its own rows, the ids it does not hold clamped into range) and
    gathers on the compute device the row of each id from the shard
    that holds it: the values of a lookup in the whole table."""

    def __init__(self, pieces: List[torch.Tensor], join: _Join):
        self.pieces = pieces
        self.join = join

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.pieces[0].shape[0]
        flat = ids.reshape(-1)
        looked = self.join([piece[(flat.to(piece.device) - s * n)
                                  .clamp(0, piece.shape[0] - 1)]
                            for s, piece in enumerate(self.pieces)])
        owner = (flat // n).clamp(max=len(self.pieces) - 1)
        rows = looked.view(len(self.pieces), flat.shape[0], -1)[
            owner, torch.arange(flat.shape[0], device=flat.device)]
        return rows.view(*ids.shape, -1)


class _SplitRows(nn.Module):
    """An embedding whose table's rows are split: ``weight`` is the
    table as ``_Rows`` reads it."""

    def __init__(self, pieces: List[torch.Tensor], join: _Join):
        super().__init__()
        self.__dict__["weight"] = _Rows(pieces, join)


class _SplitColumns(nn.Module):
    """The logits head with its output columns split: called on x (rows,
    dim), each shard computes its columns on its device from x moved
    there (``parts``: each shard's head bound to its pieces), and the
    columns are joined along the vocabulary on the compute device."""

    def __init__(self, parts: List[nn.Module],
                 devices: Sequence[torch.device], join: _Join):
        super().__init__()
        self.__dict__["parts"] = list(zip(parts, devices))
        self.__dict__["join"] = join

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.join([core.linear(p, x.to(dev))
                          for p, dev in self.parts], dim=-1)


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
        # the split tables (the serve specs split only these, each of
        # their tensors along dim 0)
        for child, module in model._modules.items():
            names = [f"{child}.{n}" for n, t in {
                **module._parameters, **module._buffers}.items()
                if t is not None]
            if not any(len(where[n]) > 1 for n in names):
                continue
            if child == "logits_proj":
                view._modules[child] = _SplitColumns(
                    [PL.bind(module, {n[len(child) + 1:]: held[s][n]
                                      for n in names})
                     for s in range(self.n_shards)], self.devices, join)
            else:
                view._modules[child] = _SplitRows(
                    [held[s][f"{child}.weight"]
                     for s in range(self.n_shards)], join)
        return view

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head's logits on ``devices[0]``: where its columns are
        split, each shard's computed on its own device."""
        head = self.model.logits_proj
        if not isinstance(head, _SplitColumns):
            return super()._logits(h)
        return head(core.layernorm(self.model.logits_ln, h))

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

    def step_join_terms(self) -> Dict[str, int]:
        """The bytes one decode step (the gather read, no speculation)
        joins onto ``devices[0]`` from the other shards, reckoned from
        the shapes, by what they are: ``layers``, the layers they own;
        ``attention``, their heads' attention outputs, one row a slot a
        layer (no cached row: it does not grow with ``total_len``);
        ``logits``, their columns of the logits, a row a slot; and
        ``rows``, their looked-up rows of the two embedding tables, one
        a slot each."""
        _, tensors, owners, _, _ = self.model.transformer.layers._items
        act = self.model.logits_ln.weight.element_size()
        tcfg = self.cfg.transformer
        terms = {
            "layers": sum(SS.tensor_bytes(ts.values())
                          for ts, own in zip(tensors, owners) if own != 0),
            "attention": sum(
                tcfg.depth * self.num_slots * part["k"].shape[2]
                * tcfg.dim_head * act
                for part, _, _ in decode_ops.pool_shards(self.pool)[1:]),
            "logits": 0, "rows": 0}
        for module in self.model._modules.values():
            if isinstance(module, _SplitColumns):
                # every tensor of a shard's head has its columns at dim 0
                terms["logits"] += sum(
                    self.num_slots * act
                    * next(iter(SS.model_tensors(p).values())).shape[0]
                    for p, _ in module.parts[1:])
            elif isinstance(module, _SplitRows):
                terms["rows"] += sum(
                    self.num_slots * SS.tensor_bytes([piece[0]])
                    for piece in module.weight.pieces[1:])
        return terms

    def step_join_bytes(self) -> int:
        """The sum of ``step_join_terms``: what ``stats()['join_bytes']``
        counts in a decode step."""
        return sum(self.step_join_terms().values())

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
