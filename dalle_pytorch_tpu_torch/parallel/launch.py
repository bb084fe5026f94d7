"""Start the ranks of a run as processes on this host, and wait for them.

``spawn(fn, n)`` starts ``n`` spawned processes (never forked: a parent
that holds a CUDA context cannot fork one), joins them into one group
through ``multihost.initialize`` on a free localhost port, runs
``fn(rank, *args)`` in each and returns the ranks' results in rank
order. ``fn`` must be a module-level function and its arguments and
result picklable. Every wait has a deadline: a rank that raises fails
the call with its traceback, and one that outlives ``timeout_s`` is
killed with the others, so no caller waits forever on a dead peer.
Each rank's collectives wait at most ``group_timeout_s`` on a peer. A
group whose join fails (the rendezvous on the chosen port: another
process may take the port between its choice and the store's bind)
is stopped and started again on a fresh port, up to ``_JOIN_ATTEMPTS``
times; ``fn`` runs only in a group that joined.

By default each rank runs on its card, ``cuda:(local_rank % cards)``;
``device='cpu'`` runs it on the CPU over ``gloo``, which is how the
tests run the parallel paths; a script that calls it needs an ``if
__name__ == '__main__':`` guard, since each rank imports the caller's
module afresh.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, fn, args, out, device,
               backend, group_timeout_s, threads) -> None:
    import torch
    from dalle_pytorch_tpu_torch.parallel import multihost
    if threads:
        torch.set_num_threads(threads)
    try:
        multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=n, process_id=rank,
                             backend=backend, device=device,
                             timeout_s=group_timeout_s)
    except Exception:                       # noqa: BLE001 — sent home
        out.put((rank, None, traceback.format_exc()))
        return
    try:
        if device is None or str(device).startswith("cuda"):
            torch.cuda.set_device(multihost.local_device(device))
        out.put((rank, True, fn(rank, *args)))
    except (Exception, SystemExit):         # sent home, the rank ends
        out.put((rank, False, traceback.format_exc()))
    finally:
        try:
            multihost.shutdown()
        except Exception:                    # noqa: BLE001
            pass


_JOIN_ATTEMPTS = 3


class _JoinFailed(RuntimeError):
    """A rank of the group could not join it."""


def spawn(fn: Callable, n: int, args: Sequence = (), *,
          device: Optional[str] = None, backend: Optional[str] = None,
          timeout_s: float = 300.0, group_timeout_s: float = 120.0,
          threads: int = 1) -> list:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each in its own rank
    process on ``device`` (None: the rank's card). Raises
    ``RuntimeError`` with the failing ranks' tracebacks (after
    ``_JOIN_ATTEMPTS`` groups that could not join, the last one's), or
    ``TimeoutError`` after ``timeout_s`` an attempt; every process
    started is stopped before it returns."""
    for attempt in range(_JOIN_ATTEMPTS):
        try:
            return _spawn_once(fn, n, args, device, backend, timeout_s,
                               group_timeout_s, threads)
        except _JoinFailed as e:
            if attempt == _JOIN_ATTEMPTS - 1:
                raise RuntimeError(str(e)) from None


def _spawn_once(fn, n, args, device, backend, timeout_s, group_timeout_s,
                threads) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, fn, tuple(args), out, device,
                               backend, group_timeout_s, threads))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(n)) - set(results))} did not "
                    f"finish within {timeout_s:g} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results
                        and r not in errors and p.exitcode not in (0, None)]
                if dead:
                    # give a dying rank's message a moment to arrive
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(
                            f"rank(s) {dead} died with exit codes "
                            f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok is None:
                errors[rank] = value
                raise _JoinFailed(f"rank {rank} could not join:\n{value}")
            (results if ok else errors)[rank] = value
            if errors:
                raise RuntimeError("".join(
                    f"rank {r} failed:\n{tb}" for r, tb in
                    sorted(errors.items())))
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        out.close()
    return [results[r] for r in range(n)]
