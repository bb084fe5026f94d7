"""Joining the processes of a run into one ``torch.distributed`` group.

Port of ``dalle_pytorch_tpu/parallel/multihost.py`` (``:35-139``). Every
process of a run is one rank on one device and runs the same program;
``initialize`` joins it to the others, after which ``parallel/mesh.py``
lays the ranks out on named axes. Each field resolves in JAX's order:
the argument, then JAX's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), then torchrun's
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``). With none of them the run is one process and
``initialize`` returns False.

The backend is an explicit choice recorded on the group and never
changed after a failure: ``nccl`` where every rank of a host has a card
of its own, ``gloo`` otherwise (the CPU, or more ranks than cards: NCCL
refuses two ranks on one device). ``deadline_s`` bounds each join
attempt (``resilience/retry.py``, ``faults.on_backend_init`` inside);
exhausted attempts raise ``BringupError`` with the attempts' record. Every
group's collectives wait at most ``timeout_s`` for a peer, so a rank
that died fails its peers instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = "JAX_COORDINATOR_ADDRESS"
_ENV_NPROC = "JAX_NUM_PROCESSES"
_ENV_PID = "JAX_PROCESS_ID"

# a collective that waits longer on a peer than this fails
DEFAULT_TIMEOUT_S = 300.0

_state: dict = {}


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def _coordinator(arg: Optional[str]) -> Optional[str]:
    if arg:
        return arg
    if os.environ.get(_ENV_COORD):
        return os.environ[_ENV_COORD]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _is_local(coord: str) -> bool:
    host = coord.rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def pick_backend(device, num_processes: int, coordinator: str = "") -> str:
    """``gloo`` on the CPU or where the host's ranks outnumber its cards,
    else ``nccl``. The host's ranks are ``LOCAL_WORLD_SIZE`` (torchrun),
    all of them with a local coordinator, else one."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    local = _env_int("LOCAL_WORLD_SIZE")
    if local is None:
        local = num_processes if (not coordinator
                                  or _is_local(coordinator)) else 1
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               deadline_s: Optional[float] = None,
               max_attempts: int = 3,
               on_event=None, *, backend: Optional[str] = None,
               device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or form) the group of ranks; True when a group was formed,
    False for a lone process (no coordinator and no process count
    anywhere). ``backend`` None picks one with ``pick_backend`` for
    ``device`` (None: the card). ``local_device_ids`` are the cards this
    host's ranks use (rank ``local_rank`` takes entry ``local_rank %
    len``). Idempotent: a second call returns True."""
    if _state.get("initialized"):
        return True
    coord = _coordinator(coordinator_address)
    nproc = num_processes if num_processes is not None else _env_int(
        _ENV_NPROC, "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int(_ENV_PID,
                                                             "RANK")
    if coord is None and nproc is None:
        return False
    missing = [name for name, v in (("coordinator address", coord),
                                    ("process count", nproc),
                                    ("process id", pid)) if v is None]
    if missing:
        raise ValueError(f"joining a multi-process run needs the "
                         f"{', '.join(missing)} too (flags, JAX_* or "
                         f"torchrun's variables)")
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} is outside [0, {nproc})")
    if backend is None:
        backend = pick_backend(device, nproc, coord)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = pid if _is_local(coord) else 0
    # an attempt cut by the deadline gives up on its own at the deadline:
    # the store's connect timeout is the same number
    join_timeout = float(deadline_s) if deadline_s and deadline_s > 0 \
        else float(timeout_s)

    def _join(attempt: int = 0):
        from dalle_pytorch_tpu_torch.resilience import faults
        faults.on_backend_init(attempt)
        if dist.is_initialized():
            return
        store = dist.TCPStore(
            coord.rsplit(":", 1)[0].strip("[]"),
            int(coord.rsplit(":", 1)[1]), nproc, pid == 0,
            timeout=datetime.timedelta(seconds=join_timeout),
            wait_for_workers=False)
        dist.init_process_group(
            backend, store=store, world_size=nproc, rank=pid,
            timeout=datetime.timedelta(seconds=timeout_s))

    if deadline_s and deadline_s > 0:
        from dalle_pytorch_tpu_torch.resilience import retry as rretry
        policy = rretry.RetryPolicy(max_attempts=max(max_attempts, 1),
                                    deadline_s=deadline_s)
        rretry.retry_with_backoff(_join, policy, label="multihost_init",
                                  on_event=on_event)
    else:
        _join()
    _state.update(initialized=True, backend=backend, rank=pid,
                  world=nproc, local_rank=local_rank,
                  local_device_ids=(list(local_device_ids)
                                    if local_device_ids else None),
                  timeout_s=float(timeout_s), coordinator=coord)
    return True


def shutdown() -> None:
    """Leave the group (every rank calls it; a no-op when alone)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.clear()


def backend() -> Optional[str]:
    """The group's backend, None for a lone process."""
    return _state.get("backend")


def timeout_s() -> float:
    return _state.get("timeout_s", DEFAULT_TIMEOUT_S)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when the caller names one, else
    ``cuda:(local_rank % cards)`` (through ``local_device_ids`` when
    given). Ranks share a card when there are more ranks than cards; a
    rank never moves to the CPU on its own."""
    from dalle_pytorch_tpu_torch.device import resolve_device
    if device is not None:
        return resolve_device(device)
    resolve_device(None)                  # raises without a card
    ids = _state.get("local_device_ids") or list(
        range(torch.cuda.device_count()))
    return torch.device("cuda", ids[_state.get("local_rank", 0) % len(ids)])


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and samples
    (rank 0)."""
    return process_index() == 0


def barrier() -> None:
    """Every rank waits for the others (a no-op when alone). On gloo the
    wait is bounded by the group's timeout."""
    if dist.is_initialized():
        if backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s()))


def fetch_local(x, group=None) -> np.ndarray:
    """A rank-sharded tensor (each rank its rows) as numpy on every rank:
    its rows gathered over ``group`` (a ``collectives.Group``, default
    every rank) in rank order. Every rank of the group must call it together;
    alone it is ``np.asarray``."""
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    group = group if group is not None else col.world()
    t = torch.as_tensor(x).detach()
    if group.size == 1:
        return t.cpu().numpy()
    return col.all_gather(t, group, dim=0).cpu().numpy()
