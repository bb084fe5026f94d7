"""The child-process engine worker: the other end of ``serve/ipc.py``.

Port of ``dalle_pytorch_tpu/serve/worker.py``. ``worker_main`` is what a
spawned process replica runs: resolve its device (the card unless the
spec says otherwise; a spec that asks for the card where none is visible
dies with a CRASH frame and exit 1, it never serves from the CPU), build
a private ``Engine`` on its own copy of the weights (a ``MeshEngine``
over its slice of its own host's devices where the spec's
``devices_per_replica`` is above 1), then loop: drain the
parent's frames, step the engine, ship completed results and heartbeat
snapshots back. The worker holds no authority: every request it runs
also lives in the parent's shadow, so it may die at any instruction and
the supervisor replays its open work on a survivor.

The worker does not care how its frames travel: a spawned child over a
pipe (``worker_main``), a spawned child that dials back over TCP
(``worker_main_dial``) and a worker started by hand (``python -m
dalle_pytorch_tpu_torch.serve.worker --connect HOST:PORT --index N``,
the token in ``DALLE_WORKER_TOKEN``) run the same loop. Its invariants:

* **results ride the frame whose snapshot counts them**, and the parent
  absorbs the results first;
* **a dead parent means exit**: every read, write and idle nap goes
  through the transport, and EOF, a reset or a stalled send ends the
  process (exit 3);
* **every frame is sequenced**, both ways;
* **local handles are stand-ins** with the parent's request id and
  arrival position; the caller's future never leaves the parent;
* **the RSS watchdog dies loudly**: past ``rss_limit_mb`` the worker
  exits 137 with no goodbye, as a container memory kill does;
* **a known first dispatch announces itself**: before the step that
  loads the kernels and warms the libraries the worker sends a
  ``compiling`` heartbeat, so the parent's hang deadline does not read
  the warm-up as a wedge.

On the card the kernels are built by the parent before the first child
spawns (``ReplicaSet``): a child finds K4's library in ``build/kernels/``
and only loads it. K4's launch count is per process; the snapshots carry
it home.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict

from dalle_pytorch_tpu_torch.serve import ipc
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
# when this module (and with it torch and the engine) finished importing:
# the first stamp of READY's bring-up record
_IMPORTED_T = time.perf_counter()

# exit codes are protocol (the parent decodes them): 0 clean, 1 crash
# (after a best-effort CRASH frame), 3 parent or transport gone, 4 the
# parent refused the HELLO, 5 the spec's checkpoint is missing or
# invalid (ipc.BAD_CKPT_EXIT), 137 the RSS watchdog (ipc.OOM_EXIT)
PARENT_GONE_EXIT = 3
REJECTED_EXIT = 4


class WorkerCheckpointError(RuntimeError):
    """The checkpoint a checkpoint-path spec names is missing, fails
    ``checkpoint.validate``, has no valid epoch (``latest:`` form) or no
    EMA where the spec asks for one. The worker ships the reason in a
    CRASH frame and exits ``ipc.BAD_CKPT_EXIT``; ``record`` is the
    structured event."""

    def __init__(self, record: dict):
        super().__init__(
            f"worker checkpoint rejected: {record.get('reason')} "
            f"(path {record.get('path')!r})")
        self.record = record


def load_ckpt_params(spec: dict, device):
    """The ``DALLE`` a checkpoint-path spec names, on ``device``, through
    the port's ``checkpoint.py`` (either package's checkpoints): a
    directory that must pass ``checkpoint.validate``, or
    ``latest:<models_dir>:<name>`` (the newest valid epoch). Then the
    spec's transforms in the CLI's order: ``ckpt_use_ema`` loads the
    checkpoint's EMA, ``ckpt_quantize`` int8 (``int8`` or ``int8_kv``)
    quantizes the decode path."""
    from dalle_pytorch_tpu_torch import checkpoint as ckpt
    from dalle_pytorch_tpu_torch.cli.gen_dalle import _ema_weights
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.utils.metrics import structured_event

    path = str(spec["ckpt_path"])
    if path.startswith("latest:"):
        try:
            _, models_dir, name = path.split(":", 2)
        except ValueError:
            raise WorkerCheckpointError(structured_event(
                "serve_worker_ckpt_invalid", path=path,
                reason="malformed latest:<models_dir>:<name> spec")) \
                from None
        found = ckpt.latest_valid(models_dir, name)
        if found is None:
            raise WorkerCheckpointError(structured_event(
                "serve_worker_ckpt_invalid", path=path,
                reason=f"no valid checkpoint for {name!r} under "
                       f"{models_dir!r}"))
        path = found[0]
    else:
        ok, reason = ckpt.validate(path)
        if not ok:
            raise WorkerCheckpointError(structured_event(
                "serve_worker_ckpt_invalid", path=path, reason=reason))
    quantize = str(spec.get("ckpt_quantize") or "none")
    if quantize not in ("none", "int8", "int8_kv"):
        raise WorkerCheckpointError(structured_event(
            "serve_worker_ckpt_invalid", path=path,
            reason=f"unknown ckpt_quantize {quantize!r} (expected "
                   f"'none', 'int8', or 'int8_kv')"))
    params, manifest = ckpt.restore_params(path)
    model = from_jax.dalle_from_jax(
        params, ckpt.dalle_config_from_manifest(manifest), device=device)
    if spec.get("ckpt_use_ema") and not _ema_weights(model, path):
        raise WorkerCheckpointError(structured_event(
            "serve_worker_ckpt_invalid", path=path,
            reason="spec asks for EMA weights but the checkpoint "
                   "carries none (train with --ema_decay)"))
    if quantize != "none":
        model = D.quantize_for_decode(model)
    return model


def worker_device(spec: dict):
    """The spec's device through ``resolve_device``; the card where none
    is visible raises (a worker never falls back to the CPU)."""
    import torch

    from dalle_pytorch_tpu_torch.device import resolve_device
    device = resolve_device(spec.get("device"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"spec asks for {device} but no CUDA device is visible to "
            f"worker pid {os.getpid()}: a worker never serves from the CPU")
    return device


def rss_mb() -> int:
    """Resident set size in MiB (``/proc/self/statm``; elsewhere the peak,
    ``ru_maxrss``)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE // (1 << 20)
    except (OSError, IndexError, ValueError):
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak >> 20 if sys.platform == "darwin" else peak >> 10


class _FrameSender:
    """The worker's one writing point: every frame gets the next tx
    sequence number."""

    def __init__(self, transport, start_seq: int):
        self.transport = transport
        self.seq = int(start_seq)

    def send(self, kind: str, payload: dict) -> None:
        self.transport.send_bytes(ipc.encode_frame(kind, payload,
                                                   self.seq))
        self.seq += 1


def worker_main(conn) -> None:
    """The pipe transport's spawn entry point. The parent sends the spec,
    pickled, down the pipe ahead of any frame (``ipc._send_spec``), so
    that spawning never waits for this process's imports."""
    try:
        spec = pickle.loads(recv_spec(conn.fileno()))
    except (EOFError, OSError):
        os._exit(PARENT_GONE_EXIT)
    _worker_shell(spec, T.PipeTransport(conn), start_seq=0)


def recv_spec(fd: int) -> bytearray:
    """The spec ``ipc._send_spec`` writes on the pipe: an 8-byte length,
    then the bytes, read into one buffer."""
    def fill(view) -> None:
        got = 0
        while got < len(view):
            n = os.readv(fd, [view[got:]])
            if n == 0:
                raise EOFError("the parent closed the pipe mid-spec")
            got += n

    head = bytearray(ipc._SPEC_LEN.size)
    fill(memoryview(head))
    (n,) = ipc._SPEC_LEN.unpack(head)
    body = bytearray(n)
    fill(memoryview(body))
    return body


def worker_main_dial(host: str, port: int, token: str,
                     index: int) -> None:
    """The socket transport's entry point (spawned, or ``main`` below):
    dial the parent's listener, HELLO, receive the spec, run the loop."""
    try:
        transport, spec = T.dial_parent(host, port, token, index)
    except T.IPCError as e:
        print(f"serve-worker[{index}]: attach rejected: {e}", flush=True)
        os._exit(REJECTED_EXIT)
    except OSError as e:
        print(f"serve-worker[{index}]: cannot reach parent "
              f"{host}:{port}: {e}", flush=True)
        os._exit(PARENT_GONE_EXIT)
    # seq 0 of each direction went to HELLO / HELLO_OK
    _worker_shell(spec, transport, start_seq=1)


def _worker_shell(spec: dict, transport, start_seq: int) -> None:
    """Run the loop; every way it ends becomes an exit code of the
    protocol (signals show as negative exit codes to the parent)."""
    sender = _FrameSender(transport, start_seq)
    try:
        _run(spec, transport, sender, rx_seq=start_seq)
    except (EOFError, BrokenPipeError, ConnectionResetError,
            ConnectionAbortedError):
        os._exit(PARENT_GONE_EXIT)
    except MemoryError:
        os._exit(ipc.OOM_EXIT)
    except WorkerCheckpointError as e:
        try:
            sender.send(ipc.CRASH, {"error": repr(e)})
        except Exception:   # noqa: BLE001 — the transport may be gone
            pass
        os._exit(ipc.BAD_CKPT_EXIT)
    except BaseException as e:  # noqa: BLE001 — ship the reason, then die
        try:
            sender.send(ipc.CRASH, {"error": repr(e)})
        except Exception:   # noqa: BLE001 — the transport may be gone too
            pass
        os._exit(1)
    os._exit(0)


def _run(spec: dict, conn, sender: _FrameSender, rx_seq: int) -> None:
    from dalle_pytorch_tpu_torch.resilience import faults

    # the parent decides which plan this child gets (``child_plan_for``:
    # a hard kill's fire-once must outlive the child)
    if spec.get("faults"):
        faults.activate(faults.FaultPlan(**spec["faults"]))
    rss_limit = int(spec.get("rss_limit_mb") or 0)
    index = int(spec["index"])

    from dalle_pytorch_tpu_torch.serve.engine import Engine, MigrationError

    # bring-up stamps (perf_counter: one clock machine-wide), shipped in
    # READY: where a child's seconds to READY go
    boot = {"imported": _IMPORTED_T, "run": time.perf_counter()}
    device = worker_device(spec)
    mesh_m = int(spec.get("devices_per_replica") or 1)
    # a mesh places its shards from a host copy: no card holds it whole
    model_device = "cpu" if mesh_m > 1 else device
    if spec.get("model") is not None:
        model = ipc.model_from_host(spec["model"], model_device)
    else:
        model = load_ckpt_params(spec, model_device)
    boot["model"] = time.perf_counter()
    kw = spec["engine_kwargs"]
    if device.type == "cuda" and kw.get("paged_attn") == "kernel":
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        PA.load_kernel()        # the parent built it: this only loads
    queue = S.RequestQueue(max_depth=1 << 30, clock=time.perf_counter)
    if mesh_m > 1:
        # replica = mesh slice, in the child: its own host's devices
        from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
        from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
        engine = MeshEngine(model, queue, complete=None,
                            clock=time.perf_counter,
                            devices=SS.slice_devices(SS.visible_devices(),
                                                     index, mesh_m), **kw)
    else:
        engine = Engine(model, queue, complete=None,
                        clock=time.perf_counter, device=device, **kw)
    boot["engine"] = time.perf_counter()

    open_handles: Dict[int, S.RequestHandle] = {}
    # READY names the weights generation this worker serves: a rolling
    # upgrade checks the attach landed on the one it asked for
    sender.send(ipc.READY, {"pid": os.getpid(), "device": str(device),
                            "rss_mb": rss_mb(),
                            "weights_version": engine.weights_version,
                            "boot": boot})

    hb_interval = float(spec.get("heartbeat_interval_s", 0.05))
    idle_sleep = float(spec.get("idle_sleep_s", 0.002))
    last_hb = 0.0
    flight_seq = 0      # ring records already shipped

    def send_snapshot(kind: str, results=None,
                      compiling: bool = False) -> None:
        nonlocal last_hb, flight_seq
        chunks = engine.decode_steps // engine.chunk_steps
        payload = {"snap": ipc.engine_snapshot(engine, chunks, rss_mb(),
                                               compiling)}
        # the ring's increments ride every snapshot frame: the parent's
        # mirror is as fresh as the last frame that landed
        flight_seq, events = engine.flight.since(flight_seq)
        if events:
            payload["events"] = events
        if results is not None:
            payload["results"] = results
        sender.send(kind, payload)
        last_hb = time.perf_counter()

    while True:
        # 1. the parent's frames; EOF or a reset here is the parent dying
        # (_worker_shell's exit 3); a broken sequence is a protocol error
        # the worker dies on loudly (CRASH, exit 1)
        while conn.poll(0):
            kind, payload, seq = ipc.decode_frame(conn.recv_bytes())
            rx_seq = ipc.seq_check(seq, rx_seq)
            if kind == ipc.ADMIT:
                now = time.perf_counter()
                for d in payload["requests"]:
                    h = S.RequestHandle.from_wire(d, now)
                    open_handles[h.request.request_id] = h
                    # requeue, not submit: the parent's request id and
                    # arrival position survive the boundary
                    queue.requeue(h, count=False)
            elif kind == ipc.FENCE:
                engine.fence()
                sender.send(ipc.BYE, {"reason": "fenced"})
                return
            elif kind == ipc.SHUTDOWN:
                engine.cancel_active("server shutdown")
                for h in queue.drain():
                    h.fulfill(S.Result(
                        status=S.CANCELLED,
                        request_id=h.request.request_id,
                        reason="server shutdown"))
                sender.send(ipc.BYE, {"reason": "shutdown"})
                return
            elif kind == ipc.STATS_REQ:
                sender.send(ipc.STATS, {"stats": {
                    **engine.stats(),
                    "paged_decode_launches": ipc.k4_launches()}})
            elif kind == ipc.MIGRATE_OUT:
                # success VACATES the slot: the request leaves with no
                # result frame (the target's completion ships it). The
                # export harvests the chunks in flight first, so a
                # snapshot goes ahead of the reply: the parent holds the
                # counters of those tokens before it can fence this child
                rid = int(payload["request_id"])
                try:
                    snap, _h = engine.export_request(rid)
                except MigrationError as e:
                    sender.send(ipc.MIGRATE_OUT, {
                        "request_id": rid, "ok": False,
                        "reason": e.reason, "error": str(e)})
                except Exception as e:    # noqa: BLE001 — typed fallback
                    sender.send(ipc.MIGRATE_OUT, {
                        "request_id": rid, "ok": False,
                        "reason": "transfer", "error": repr(e)})
                else:
                    open_handles.pop(rid, None)
                    send_snapshot(ipc.HEARTBEAT)
                    sender.send(ipc.MIGRATE_OUT, {
                        "request_id": rid, "ok": True, "snap": snap})
            elif kind == ipc.MIGRATE_IN:
                # the stand-in handle import_slot rebuilds joins
                # open_handles; a refused import leaves the engine as it
                # was and the NACK sends the parent to replay
                snap = payload["snap"]
                rid = int(snap.get("request_id", -1))
                try:
                    slot_i = engine.import_slot(snap)
                except MigrationError as e:
                    sender.send(ipc.MIGRATE_ACK, {
                        "request_id": rid, "ok": False,
                        "reason": e.reason, "error": str(e)})
                except Exception as e:    # noqa: BLE001 — typed fallback
                    sender.send(ipc.MIGRATE_ACK, {
                        "request_id": rid, "ok": False,
                        "reason": "transfer", "error": repr(e)})
                else:
                    open_handles[rid] = engine.slots[slot_i].handle
                    sender.send(ipc.MIGRATE_ACK,
                                {"request_id": rid, "ok": True})
            else:
                raise ipc.IPCError(
                    f"unexpected frame kind {kind!r} from parent")

        chunks = engine.decode_steps // engine.chunk_steps
        # the soft catalog (crash, hang), the hard one (real SIGKILL and
        # SIGSEGV, OOM against the watchdog, a garbage frame) and the
        # network one (reset, torn frame, stall, duplicate, reorder)
        faults.on_replica_chunk(index, chunks)
        faults.on_worker_chunk(index, chunks,
                               emit_frame=conn.send_bytes,
                               rss_limit_mb=rss_limit, rss_mb=rss_mb,
                               transport=conn, sender=sender)

        # 2. the RSS watchdog: abrupt, no goodbye, exit 137
        if rss_limit and rss_mb() > rss_limit:
            os._exit(ipc.OOM_EXIT)

        # 3. announce a known-blocking first dispatch before it runs
        warming = engine.compile_pending()
        if warming:
            send_snapshot(ipc.HEARTBEAT, compiling=True)

        busy = engine.step_once()

        # 4. completions, in batches under the pipe's atomic write; only
        # the last batch carries the snapshot, which counts them all
        done = [rid for rid, h in open_handles.items() if h.done()]
        if done:
            wires = []
            for rid in done:
                h = open_handles.pop(rid)
                w = h.result(timeout=0).to_wire()
                if h.trace is not None:
                    # the stand-in's spans go home with the result
                    w["spans"] = h.trace.wire_spans()
                wires.append(w)
            for i in range(0, len(wires), ipc.HARVEST_BATCH):
                batch = wires[i:i + ipc.HARVEST_BATCH]
                if i + ipc.HARVEST_BATCH >= len(wires):
                    send_snapshot(ipc.HARVEST, results=batch)
                else:
                    sender.send(ipc.HARVEST,
                                {"results": batch, "snap": None})
        elif warming or time.perf_counter() - last_hb >= hb_interval:
            # after the first dispatch at once: its exemption from the
            # hang deadline ends with it
            send_snapshot(ipc.HEARTBEAT)

        # 5. the idle nap is a poll of the transport: it wakes for new
        # work and notices a dead parent
        if not busy and engine.idle():
            conn.poll(idle_sleep)


def main(argv=None) -> None:
    """A worker started by hand or by a launcher:

        DALLE_WORKER_TOKEN=<token> python -m \\
            dalle_pytorch_tpu_torch.serve.worker --connect HOST:PORT --index N

    Dials the serving parent's ``--transport socket`` listener and serves
    as replica N until the parent fences it, shuts it down or dies."""
    import argparse

    p = argparse.ArgumentParser(
        description="dial into a serving parent's --transport socket "
                    "listener as one engine-replica worker")
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="the parent's worker endpoint (cli.serve "
                        "--worker_endpoint; printed at startup)")
    p.add_argument("--index", type=int, required=True,
                   help="the replica index this worker serves as")
    p.add_argument("--token", default="",
                   help=f"HELLO token (prefer the {T.TOKEN_ENV} "
                        f"environment variable: argv shows in `ps`)")
    args = p.parse_args(argv)
    token = args.token or os.environ.get(T.TOKEN_ENV, "")
    if not token:
        raise SystemExit(f"no attach token: set {T.TOKEN_ENV} or pass "
                         f"--token")
    host, port = T.parse_endpoint(args.connect)
    worker_main_dial(host, port, token, args.index)


if __name__ == "__main__":
    main()
