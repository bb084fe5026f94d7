"""Host-side prefetching onto the device.

Port of ``dalle_pytorch_tpu/data/prefetch.py``: a worker thread stays
``depth`` batches ahead of the training loop, running the batch's
``transform`` (the image reads) and its copy to the device while the
device runs the current step. Each numpy array of a batch becomes a
tensor; on a CUDA device it is pinned and copied with
``.to(device, non_blocking=True)``, ordered before the step on the
device's stream. The resilience contract is the JAX module's: a worker
exception is re-raised on the consumer's side after the good batches
queued before it; ``max_bad_records`` skips (and reports) up to that
many records whose transform or copy fails; a worker that dies without
its sentinel is restarted once; ``source_pos`` counts the source records
the consumer has received, skipped ones included.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch


def shard_for_host(items: Sequence[Any],
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None, *,
                   mesh=None, axis: str = "dp") -> Sequence[Any]:
    """Contiguous slice of a dataset for this rank (equal lengths,
    trailing remainder dropped, so every rank steps in lockstep). The
    defaults come from the group: the rank's coordinate on ``mesh``'s
    ``axis`` of its size, not its rank, so the ranks of one sp or pp
    group read the same rows (without a mesh, the rank of the world)."""
    if process_index is None or process_count is None:
        if mesh is not None:
            pi, pc = mesh.index(axis), mesh.size(axis)
        else:
            from dalle_pytorch_tpu_torch.parallel import multihost
            pi, pc = multihost.process_index(), multihost.process_count()
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    per = len(items) // process_count
    if per == 0:
        raise ValueError(f"{len(items)} items cannot feed {process_count} "
                         "hosts")
    return items[process_index * per:(process_index + 1) * per]


def to_device(batch, device: Optional[torch.device]):
    """numpy arrays of a batch (a dict, list, tuple or array) -> tensors
    on ``device`` (pinned and copied without blocking on CUDA); other
    leaves unchanged. ``device=None`` keeps numpy arrays as they are."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if device is None or not isinstance(batch, (np.ndarray, torch.Tensor)):
        return batch
    t = torch.as_tensor(batch)
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    """Wraps a host batch iterator; yields batches on ``device``."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None,
                 device=None, max_bad_records: int = 0,
                 on_event: Optional[Callable[[dict], None]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._transform = transform
        self._device = None if device is None else torch.device(device)
        self._max_bad = max(int(max_bad_records), 0)
        self._on_event = on_event
        self._it = iter(it)
        self.bad_records = 0
        # source records consumed up to and including the last batch this
        # consumer received (bad skipped records counted)
        self.source_pos = 0
        # the worker's running position: an attribute, so a restarted
        # worker counts on from where the dead one stopped
        self._worker_pos = 0
        self._thread_restarts_left = 1
        self._start_worker()

    def _start_worker(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _emit(self, kind: str, **fields) -> None:
        if self._on_event is None:
            return
        from dalle_pytorch_tpu_torch.utils.metrics import structured_event
        try:
            self._on_event(structured_event(kind, **fields))
        except Exception:
            pass                  # an event sink must never kill the feed

    def _worker(self):
        it = self._it
        pos = self._worker_pos
        try:
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                except BaseException as e:
                    self._err = e
                    return
                pos += 1
                self._worker_pos = pos
                try:
                    if self._transform is not None:
                        batch = self._transform(batch)
                    batch = to_device(batch, self._device)
                except BaseException as e:
                    if self.bad_records < self._max_bad:
                        self.bad_records += 1
                        self._emit("prefetch_bad_record",
                                   error=f"{type(e).__name__}: {e}",
                                   skipped=self.bad_records,
                                   cap=self._max_bad)
                        continue
                    self._err = e
                    return
                # each batch travels with the worker's source position, so
                # source_pos never runs ahead of what the consumer has
                self._q.put((pos, batch))
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._thread.is_alive():
                    continue
                if not self._q.empty():
                    continue
                # the worker died without its sentinel: restart it once,
                # then give up loudly (a silently dead feed would hang)
                if self._thread_restarts_left > 0:
                    self._thread_restarts_left -= 1
                    self._emit("prefetch_restart")
                    self._start_worker()
                    continue
                raise RuntimeError(
                    "prefetch worker died without reporting an error "
                    "(restart already spent)")
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        self.source_pos, batch = item
        return batch


def prefetch(it: Iterable, depth: int = 2,
             transform: Optional[Callable[[Any], Any]] = None,
             device=None, max_bad_records: int = 0,
             on_event: Optional[Callable[[dict], None]] = None) -> Prefetcher:
    """``for batch in prefetch(dataset.epoch(e), device=dev): ...``"""
    return Prefetcher(it, depth=depth, transform=transform, device=device,
                      max_bad_records=max_bad_records, on_event=on_event)
