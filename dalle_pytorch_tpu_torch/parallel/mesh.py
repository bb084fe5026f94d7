"""The ranks of a run laid out on named axes.

Port of ``dalle_pytorch_tpu/parallel/mesh.py`` (``:28-74``), with the
same axis names: ``dp`` (data parallel: the batch split, gradients
averaged), ``sp`` (the sequence split, ``parallel/sequence.py``), ``pp``
(pipeline stages, ``parallel/pipeline.py``), and the axes that split
parameters but not the batch (``parallel/placement.py``): ``tp``
(Megatron tensor parallelism), ``fsdp`` (layers stored in blocks) and
``ep`` (MoE experts). ``make_mesh`` lays
the world's ranks out row-major over the axes, as JAX reshapes its
device list, and gives each axis a group: for every slice along an axis
one ``dist.new_group``, created in the same order on every rank (the
creation itself is a collective), of which a rank keeps the one it lies
in. One process is a mesh whose axes are all of size 1, with no groups.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dalle_pytorch_tpu_torch.parallel import collectives as col


@dataclasses.dataclass
class Mesh:
    """``shape`` {axis: size} in order; ``ranks`` the global ranks in that
    shape; ``coords`` this rank's index on each axis; ``groups`` the
    ``collectives.Group`` of each axis this rank lies in."""
    shape: Dict[str, int]
    ranks: np.ndarray
    coords: Dict[str, int]
    groups: Dict[str, col.Group]

    @property
    def axis_names(self):
        return tuple(self.shape)

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis else 0

    def group(self, axis: Optional[str]) -> col.Group:
        """The group of ``axis`` (a group of one for an axis the mesh
        lacks or None)."""
        return self.groups.get(axis, col.SELF) if axis else col.SELF


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """The mesh ``{axis: size}`` over every rank (default ``{'dp':
    world}``); the sizes must multiply to the world size
    (``ValueError``, as JAX's). Every rank calls it with the same
    sizes."""
    from dalle_pytorch_tpu_torch.parallel import multihost
    world = multihost.process_count()
    rank = multihost.process_index()
    if axis_sizes is None:
        axis_sizes = {"dp": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs "
                         f"{int(np.prod(sizes))} devices, have {world}")
    ranks = np.arange(world).reshape(sizes)
    where = np.argwhere(ranks == rank)[0]
    coords = {n: int(i) for n, i in zip(names, where)}
    timeout = datetime.timedelta(
        seconds=timeout_s if timeout_s is not None else
        multihost.timeout_s())
    groups = {}
    for ax, name in enumerate(names):
        if sizes[ax] == 1:
            continue
        # every slice along this axis, in one fixed order on every rank
        others = [range(s) for i, s in enumerate(sizes) if i != ax]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(ax, slice(None))
            members = tuple(int(r) for r in ranks[tuple(idx)])
            pg = dist.new_group(list(members), timeout=timeout)
            if rank in members:
                groups[name] = col.Group(members, members.index(rank), pg)
    return Mesh(dict(zip(names, sizes)), ranks, coords, groups)


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor],
              axes: Optional[Sequence[str]] = None) -> None:
    """Set every tensor, in place, to the values of the root of each axis
    in ``axes`` (every axis of the mesh when None) in turn, so replicas
    start identical. Every rank of a group passes its tensors in the same
    order."""
    tensors = [t for t in tensors if not t.is_meta]
    with torch.no_grad():
        for ax in (mesh.axis_names if axes is None else axes):
            g = mesh.group(ax)
            if g.size == 1:
                continue
            for t in tensors:
                t.copy_(col.broadcast(t.detach(), g, 0))


def shard_batch(mesh: Mesh, batch, axis: str = "dp", *, local: bool):
    """This rank's part of a batch: with ``local=False`` the batch is the
    global one and every array entry keeps the rows of this rank's
    ``axis`` coordinate (``rows / size`` each, contiguous); with
    ``local=True`` the batch is already this rank's (each process read its
    own rows, ``data/prefetch.py::shard_for_host``) and comes back as it
    is. Scalars pass unchanged either way."""
    if local:
        return batch
    n, i = mesh.size(axis), mesh.index(axis)
    if n == 1:
        return batch

    def take(v):
        if getattr(v, "ndim", 0) < 1:
            return v
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} rows does not "
                             f"split over {axis} {n}")
        per = v.shape[0] // n
        return v[i * per:(i + 1) * per]

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)
