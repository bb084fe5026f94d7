"""Typed IPC between the replica set and its process workers.

Port of ``dalle_pytorch_tpu/serve/ipc.py``. With ``isolation='process'``
one replica is one child process (``serve/worker.py``) with its own
interpreter, its own CUDA context and its own ``Engine``, so a segfault,
a host OOM kill or a ``kill -9`` takes down ONE replica. Parent and child
share nothing but a transport (``serve/transport.py``: a duplex pipe, or
a dial-back TCP socket) carrying framed, versioned, sequence-numbered,
CRC32-checked messages, byte for byte the JAX package's frames:

  parent -> child:  ADMIT, FENCE, SHUTDOWN, STATS_REQ, MIGRATE_OUT (export
                    one request's slot), MIGRATE_IN (install a snapshot)
  child -> parent:  READY, HEARTBEAT, HARVEST (results + the engine's
                    snapshot), STATS, CRASH, BYE, MIGRATE_OUT (the export
                    reply), MIGRATE_ACK (the import verdict)

The rules the zero-loss contract rests on:

* **The parent never trusts the child.** Every handle routed to a child
  stays in the parent's *shadow* (``ChildEngineClient.shadow``) until its
  result frame lands; reclaim reads the shadow, never the corpse.
* **Counters ride the frames that explain them.** A harvest frame carries
  the child's lifetime counters and per-request progress AS OF that
  frame, and a completion is never counted ahead of the frame that ships
  its result; whatever prefix of frames the parent read before the child
  died is a consistent state.
* **Corruption fences, never hangs.** Every frame is checked (magic,
  version, kind, CRC32) before its payload is parsed; a frame that fails
  raises ``IPCError``, the client marks itself poisoned and the
  supervisor fences the replica.
* **Delivery order is verified.** Every frame carries a per-connection
  sequence number; a gap, a duplicate or a reorder is ``IPCError``.
* **Two clocks never cross raw.** Deadlines ship as remaining budget and
  latency is restamped on the parent's clock; the snapshot stamps of the
  IPC-lag metric are ``perf_counter`` (CLOCK_MONOTONIC on Linux, one
  epoch machine-wide).

What the port adds: the spec carries the served ``DALLE`` as its state
on the host (``host_model``: config, CPU tensors, whether it is int8) or
a checkpoint path, and the device as a string, never a CUDA tensor; and a
snapshot carries the child's launches of kernel K4
(``paged_decode_launches``), a module count the parent cannot read.

The client is SINGLE-OWNER: only the replica set's control thread (or the
sync driver) touches ``route``/``pump``/``fence``/``reclaim``.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import pickle
import signal
import struct
import subprocess
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

from dalle_pytorch_tpu_torch.obs import flight as oflight
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T
from dalle_pytorch_tpu_torch.serve.engine import COUNTERS
from dalle_pytorch_tpu_torch.serve.transport import IPCError  # noqa: F401
#                      (re-exported: the typed error every layer fences on)

# the header's version: it pins the FRAME LAYOUT only; payloads evolve by
# field tolerance (``from_wire``'s ``.get`` defaults)
PROTOCOL_VERSION = 2

# frame kinds, in JAX's order: a kind's wire id is its position
ADMIT = "admit"
FENCE = "fence"
SHUTDOWN = "shutdown"
STATS_REQ = "stats_req"
READY = "ready"
HEARTBEAT = "heartbeat"
HARVEST = "harvest"
STATS = "stats"
CRASH = "crash"
BYE = "bye"
HELLO = "hello"
HELLO_OK = "hello_ok"
MIGRATE_OUT = "migrate_out"
MIGRATE_IN = "migrate_in"
MIGRATE_ACK = "migrate_ack"

KINDS = (ADMIT, FENCE, SHUTDOWN, STATS_REQ,
         READY, HEARTBEAT, HARVEST, STATS, CRASH, BYE,
         HELLO, HELLO_OK,
         MIGRATE_OUT, MIGRATE_IN, MIGRATE_ACK)
_KIND_ID = {k: i for i, k in enumerate(KINDS)}

_MAGIC = 0xD5
# magic, version, kind, pad, seq, crc32(payload)
_HEADER = struct.Struct("<BBBxII")

# results a harvest frame: keeps frames under the pipe's atomic write
HARVEST_BATCH = 8

# the exit code of a worker whose RSS watchdog trips (128 + SIGKILL, the
# container memory-kill convention)
OOM_EXIT = 137

# the exit code of a worker whose checkpoint-path spec names a missing or
# invalid checkpoint
BAD_CKPT_EXIT = 5


def encode_frame(kind: str, payload: dict, seq: int = 0) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    return _HEADER.pack(_MAGIC, PROTOCOL_VERSION, _KIND_ID[kind],
                        seq & 0xFFFFFFFF, zlib.crc32(body)) + body


def decode_frame(data: bytes):
    """-> (kind, payload, seq); ``IPCError`` on anything untrustworthy."""
    if len(data) < _HEADER.size:
        raise IPCError(f"truncated frame: {len(data)} bytes < "
                       f"{_HEADER.size}-byte header")
    magic, version, kind_id, seq, crc = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise IPCError(f"bad magic 0x{magic:02x}")
    if version != PROTOCOL_VERSION:
        raise IPCError(f"protocol version skew: peer speaks v{version}, "
                       f"this process v{PROTOCOL_VERSION}")
    if kind_id >= len(KINDS):
        raise IPCError(f"unknown frame kind id {kind_id}")
    body = data[_HEADER.size:]
    if zlib.crc32(body) != crc:
        raise IPCError("payload checksum mismatch (corrupt or torn frame)")
    try:
        payload = json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise IPCError(f"unparseable payload: {e}") from None
    if not isinstance(payload, dict):
        raise IPCError(f"payload must be an object, got "
                       f"{type(payload).__name__}")
    return KINDS[kind_id], payload, seq


def seq_check(got: int, expected: int) -> int:
    """Check one received frame's sequence number; returns the next one
    expected. A mismatch (lost, duplicated or reordered delivery) is
    ``IPCError``. The wire field is u32, so the comparison masks."""
    if got != (expected & 0xFFFFFFFF):
        how = ("duplicate or reordered delivery"
               if got < (expected & 0xFFFFFFFF)
               else "gap: lost frame(s)")
        raise IPCError(f"frame sequence broken: got seq {got}, "
                       f"expected {expected & 0xFFFFFFFF} ({how})")
    return expected + 1


def k4_launches() -> int:
    """This process's launches of kernel K4 (prefix and visible walks)."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    fn = PA.paged_decode_attention
    return int(fn.launches) + int(fn.visible_launches)


def engine_snapshot(engine, chunks: int, rss_mb: int,
                    compiling: bool) -> dict:
    """The child engine's state as one wire dict (JAX's keys, and the
    process's K4 launches)."""
    return {
        "counters": engine.counters(),
        "progress": {str(k): int(v)
                     for k, v in engine.progress_snapshot().items()},
        "active_slots": int(engine.active_slots()),
        "queued": int(engine.queue.depth()),
        "chunks": int(chunks),
        "compiling": bool(compiling),
        "rss_mb": int(rss_mb),
        "t": time.perf_counter(),
        "pages_free": (int(engine.alloc.free)
                       if engine.kv == "paged" else -1),
        # the oldest page-deferred request's (id, pages needed): handed
        # back to the shared queue when this replica is fenced
        "hol": (None if engine.kv != "paged" or engine._hol_rid is None
                else [int(engine._hol_rid), int(engine._hol_need)]),
        "paged_decode_launches": k4_launches(),
    }


def _snap_fields(payload: dict):
    """Validate and convert a snapshot payload; ``IPCError`` on wrong
    shapes. A counter or field a peer does not send decodes as its
    default."""
    try:
        raw = payload["counters"]
        if not isinstance(raw, dict):
            raise TypeError(f"counters must be a dict, got "
                            f"{type(raw).__name__}")
        counters = {k: int(raw.get(k, 0)) for k in COUNTERS}
        progress = {int(k): int(v)
                    for k, v in payload["progress"].items()}
        raw_hol = payload.get("hol")
        hol = (None if raw_hol is None
               else (int(raw_hol[0]), int(raw_hol[1])))
        return (counters, progress, int(payload["active_slots"]),
                int(payload["queued"]), int(payload["chunks"]),
                bool(payload["compiling"]), int(payload["rss_mb"]),
                float(payload["t"]), int(payload["pages_free"]), hol,
                int(payload.get("paged_decode_launches", 0)))
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise IPCError(f"malformed snapshot: {e!r}") from None


def host_model(model) -> bytes:
    """The served ``DALLE`` for a worker's spec, pickled: its config,
    whether its linears are int8 (``quantize_for_decode``), and its state
    as CPU tensors. ``model_from_host`` rebuilds it on the worker's
    device. A facade's held VAE stays behind."""
    import torch

    from dalle_pytorch_tpu_torch.ops.quant import QuantLinear
    with torch.no_grad():
        state = {k: v.detach().to("cpu")
                 for k, v in model.state_dict().items()}
    return pickle.dumps({
        "cfg": model.cfg,
        "quantized": isinstance(model.logits_proj, QuantLinear),
        "state": state})


def model_from_host(blob: bytes, device):
    """Inverse of ``host_model``: the module built on ``device`` in the
    state's dtype (int8 as it was), then the state copied in. (Built on
    ``meta`` and assigned, it would import torch's distributed tensor
    machinery: seconds of a child's bring-up.)"""
    from dalle_pytorch_tpu_torch.models import dalle as D
    host = pickle.loads(blob)
    state = host["state"]
    model = D.DALLE(host["cfg"], device=device,
                    dtype=state["text_emb.weight"].dtype)
    if host["quantized"]:
        model = D.quantize_for_decode(model)
    model.load_state_dict(state)
    return model


_SPEC_LEN = struct.Struct("<Q")


def _send_spec(conn, blob: bytes) -> None:
    """The spec down a pipe, raw, ahead of any frame: its length, then
    its bytes (``worker.recv_spec`` reads them into one buffer; a
    connection's own ``recv_bytes`` reads a message of a model's size in
    pipe-sized pieces, each into a buffer of the whole size)."""
    try:
        fd = conn.fileno()
        view = memoryview(_SPEC_LEN.pack(len(blob)) + blob)
        off = 0
        while off < len(view):
            off += os.write(fd, view[off:])
    except (OSError, ValueError):
        pass        # the child died first: supervision sees it by its PID


class ChildEngineClient:
    """The parent's end of one process replica. Quacks like ``Engine``
    where the replica set reads one (the ``COUNTERS`` as attributes,
    ``num_slots``, ``kv``, ``active_slots()``, ``last_heartbeat``,
    ``compiling``, ``fenced``, ``inflight_handles()``), and adds the
    process half: PID liveness, exit decoding, the shadow and hard kill.

    Three launch shapes, by ``transport`` and ``worker_cmd``:

    * ``'pipe'``: a spawned local child over a duplex pipe;
    * ``'socket'``, ``worker_cmd=None``: a spawned local child that dials
      back to the parent's ``WorkerListener`` and receives its spec over
      the authenticated socket;
    * ``'socket'``, ``worker_cmd=<template>``: the worker started by an
      operator command (``{endpoint}``, ``{index}``, ``{token}``; the
      token also in ``DALLE_WORKER_TOKEN``); ``worker_cmd=''`` starts
      nothing and waits for a worker started by hand.

    Without a local PID the socket is the liveness signal."""

    def __init__(self, model_blob: Optional[bytes], *, index: int,
                 engine_kwargs: dict,
                 device: str = "cuda",
                 ckpt_path: Optional[str] = None,
                 ckpt_use_ema: bool = False,
                 ckpt_quantize: str = "none",
                 heartbeat_interval_s: float = 0.05,
                 rss_limit_mb: int = 0,
                 fault_plan: Optional[dict] = None,
                 idle_sleep_s: float = 0.002,
                 clock: Callable[[], float] = time.perf_counter,
                 on_done: Optional[Callable] = None,
                 transport: str = "pipe",
                 listener: Optional[T.WorkerListener] = None,
                 worker_cmd: Optional[str] = None,
                 num_pages: int = 0,
                 devices_per_replica: int = 1):
        from dalle_pytorch_tpu_torch.serve import worker as worker_mod

        self._launch_pc = time.perf_counter()
        self.clock = clock
        self.index = int(index)
        self.num_slots = int(engine_kwargs.get("num_slots", 4))
        self.chunk_steps = int(engine_kwargs.get("chunk_steps", 8))
        self.kv = str(engine_kwargs.get("kv", "dense"))
        # the child's pool as the set models it; with ``pages_free`` the
        # surface an ``Engine`` shows its pool by
        self.num_pages = int(num_pages)
        self.on_done = on_done
        self.transport_kind = str(transport)
        if ckpt_path is None and model_blob is None:
            raise ValueError("ChildEngineClient needs a model or a "
                             "ckpt_path for the worker to load from")
        spec = {
            "index": self.index,
            # the host state (``host_model``), or nothing with a
            # checkpoint path: the worker loads and validates it itself
            "model": None if ckpt_path is not None else model_blob,
            "ckpt_path": ckpt_path,
            "ckpt_use_ema": bool(ckpt_use_ema),
            "ckpt_quantize": str(ckpt_quantize),
            "engine_kwargs": dict(engine_kwargs),
            "device": str(device),
            # above 1 the child builds a mesh over its own host's devices
            "devices_per_replica": int(devices_per_replica),
            "heartbeat_interval_s": float(heartbeat_interval_s),
            "rss_limit_mb": int(rss_limit_mb),
            "faults": fault_plan,
            "idle_sleep_s": float(idle_sleep_s),
        }
        self._listener = listener
        self._proc = None
        self._popen = None
        self._conn = None
        self.pid: Optional[int] = None
        self.peer = ""
        self.remote_host = ""
        self.awaiting_operator = False
        if transport == "pipe":
            # spawn, never fork: the parent holds a CUDA context, and the
            # child must build its own
            ctx = mp.get_context("spawn")
            parent_end, child_end = ctx.Pipe(duplex=True)
            self._conn = T.PipeTransport(parent_end)
            self._proc = ctx.Process(
                target=worker_mod.worker_main, args=(child_end,),
                daemon=True, name=f"serve-worker-{index}")
            self._proc.start()
            # the child sees the parent die as EOF only once no live
            # process holds a write handle of its end
            child_end.close()
            self.pid = self._proc.pid
            self.peer = f"pipe:pid={self.pid}"
            # the spec (the weights) goes down the pipe from a thread of
            # its own: the child reads it once its imports are done, and
            # a write the size of a model would hold this thread (the
            # set's supervisor) that long. The parent writes nothing else
            # before the child's READY, which follows the read
            threading.Thread(target=_send_spec,
                             args=(parent_end, pickle.dumps(spec)),
                             daemon=True,
                             name=f"serve-worker-spec-{index}").start()
        elif transport == "socket":
            if listener is None:
                raise ValueError("transport='socket' needs a "
                                 "WorkerListener")
            listener.expect(self.index, pickle.dumps(spec))
            if worker_cmd is None:
                ctx = mp.get_context("spawn")
                self._proc = ctx.Process(
                    target=worker_mod.worker_main_dial,
                    args=(listener.dial_host, listener.port,
                          listener.token, self.index),
                    daemon=True, name=f"serve-worker-{index}")
                self._proc.start()
                self.pid = self._proc.pid
            elif worker_cmd == "":
                # remote attach: no spawn deadline applies
                self.awaiting_operator = True
            else:
                import shlex
                cmd = worker_cmd.format(
                    endpoint=listener.advertise_endpoint,
                    index=self.index, token=listener.token)
                env = dict(os.environ)
                env[T.TOKEN_ENV] = listener.token
                self._popen = subprocess.Popen(shlex.split(cmd), env=env)
                self.pid = self._popen.pid
        else:
            raise ValueError(f"unknown transport {transport!r}")
        self.started_t = self.clock()
        # READY's bring-up record, seconds from the launch: the worker's
        # imports, the spec's arrival, the model on the device, the engine
        self.boot_s: Dict[str, float] = {}
        # over a socket, seq 0 of each direction went to HELLO/HELLO_OK
        self._tx_seq = 1 if transport == "socket" else 0
        self._rx_seq = 1 if transport == "socket" else 0

        self.ready = False
        self.fenced = False
        self.crashed = False            # the child shipped a CRASH frame
        self.poisoned = False           # protocol error: fence me
        self.bye = False
        self.last_error = ""
        self.worker_weights_version = ""    # READY's announcement
        # every handle routed here and not yet resolved
        self.shadow: Dict[int, S.RequestHandle] = {}
        # the parent's mirror of the child engine's flight ring
        self.flight = oflight.FlightRecorder(capacity=512)
        # the last frame's view of the child engine
        self.counter_state = {k: 0 for k in COUNTERS}
        self.progress: Dict[int, int] = {}
        self.active = 0
        self.queued = 0
        self.chunks = 0
        self.compiling = True           # bring-up is a compile phase
        self.rss_mb = 0
        self.pages_free = -1            # the last frame's; -1 before it
        # the child's clock at its last frame and its decode steps then,
        # in one assignment: the child's own time a step between frames
        self.step_clock = (0.0, 0)
        self.hol = None
        self.paged_decode_launches = 0
        self.last_heartbeat = self.clock()
        self.last_frame_t = self.clock()
        self.stats_reply: Optional[dict] = None
        # the child's answer to the ONE migration in flight
        self.migrate_reply: Optional[dict] = None
        # child stamp -> parent absorb lag of each snapshot frame
        self.ipc_lag_s: deque = deque(maxlen=10_000)

    def __getattr__(self, name):
        # the COUNTERS surface, mirrored from the last frame
        counters = self.__dict__.get("counter_state")
        if counters is not None and name in counters:
            return counters[name]
        raise AttributeError(name)

    # -- socket adoption ----------------------------------------------------

    def _maybe_attach(self) -> None:
        """Adopt the transport a dialing worker completed its HELLO on."""
        if self._conn is not None or self._listener is None:
            return
        t = self._listener.take(self.index)
        if t is None:
            return
        # one control thread drives every replica: a worker that stops
        # reading must cost a failed send, not everyone's deadlines
        t.set_send_timeout(2.0)
        self._conn = t
        self.peer = t.peer
        hello = t.hello or {}
        if self.pid is None:
            # a remote worker's pid: triage only, never liveness
            pid = hello.get("pid")
            self.pid = int(pid) if isinstance(pid, int) else None
        self.remote_host = str(hello.get("host") or "")
        if self.awaiting_operator:
            self.awaiting_operator = False
            self.started_t = self.clock()    # attach -> READY deadline

    # -- sending ------------------------------------------------------------

    def _send(self, kind: str, payload: dict) -> bool:
        self._maybe_attach()
        if self._conn is None:
            if not self.last_error:
                self.last_error = "no worker transport attached yet"
            return False
        try:
            self._conn.send_bytes(encode_frame(kind, payload,
                                               self._tx_seq))
            self._tx_seq += 1
            return True
        except (OSError, ValueError) as e:
            if not self.last_error:
                self.last_error = f"transport write failed: {e!r}"
            # a failed write over a live stream un-syncs the sequence:
            # poison, and supervision fences and replays
            if self._conn.alive():
                self.poisoned = True
            return False

    def route(self, handles: List[S.RequestHandle]) -> None:
        """Hand requests to the child. They enter the shadow FIRST: a
        failed write still leaves them to the reclaim sweep."""
        now = self.clock()
        for h in handles:
            self.shadow[h.request.request_id] = h
        self._send(ADMIT, {"requests": [h.to_wire(now) for h in handles]})

    def request_stats(self) -> None:
        self._send(STATS_REQ, {})

    # -- live migration -----------------------------------------------------

    def _await_migrate(self, timeout: float) -> Optional[dict]:
        """Pump until the child answers the migration in flight; None when
        the stream dies or the deadline passes."""
        deadline = self.clock() + timeout
        while True:
            self.pump(0.01)
            reply, self.migrate_reply = self.migrate_reply, None
            if reply is not None:
                return reply
            if self.poisoned or self.crashed or self.fenced \
                    or not self.alive_proc() \
                    or self.clock() >= deadline:
                return None

    def export_request(self, request_id: int,
                       timeout: float = 30.0) -> dict:
        """The child exports ``request_id``'s slot (MIGRATE_OUT) and
        vacates it; returns the snapshot. The handle stays in the shadow
        until the caller moves it. A refusal, a death or silence is a
        typed ``MigrationError`` with nothing lost."""
        from dalle_pytorch_tpu_torch.serve.engine import MigrationError
        if int(request_id) not in self.shadow:
            raise MigrationError(
                "not_found", f"request {request_id} is not routed here")
        if not self._send(MIGRATE_OUT, {"request_id": int(request_id)}):
            raise MigrationError(
                "source_dead", self.last_error or "transport write failed")
        reply = self._await_migrate(timeout)
        if reply is None:
            raise MigrationError(
                "source_dead", self.last_error or "source died or went "
                "silent mid-transfer")
        if not reply.get("ok"):
            raise MigrationError(str(reply.get("reason") or "transfer"),
                                 str(reply.get("error") or ""))
        snap = reply.get("snap")
        if not isinstance(snap, dict):
            raise MigrationError("transfer", "malformed export reply "
                                 "(no snapshot object)")
        return snap

    def import_request(self, snap: dict, handle: S.RequestHandle,
                       timeout: float = 30.0) -> None:
        """Ship a snapshot to this child (MIGRATE_IN) and wait for its
        MIGRATE_ACK. The handle enters the shadow first; a refused or
        unanswered import takes it out again and raises
        ``MigrationError``."""
        from dalle_pytorch_tpu_torch.serve.engine import MigrationError
        rid = int(snap.get("request_id", -1))
        self.shadow[rid] = handle
        sent = self._send(MIGRATE_IN, {"snap": snap})
        reply = self._await_migrate(timeout) if sent else None
        if reply is None or not reply.get("ok"):
            self.shadow.pop(rid, None)
            if reply is None:
                raise MigrationError(
                    "target_dead", self.last_error or "target died or "
                    "went silent mid-import")
            raise MigrationError(str(reply.get("reason") or "transfer"),
                                 str(reply.get("error") or ""))

    # -- receiving ----------------------------------------------------------

    def pump(self, poll_s: float = 0.0) -> bool:
        """Drain and dispatch every whole frame the child sent; True when
        any was. A fenced client never pumps; a frame that fails to
        decode poisons the client."""
        if self.fenced:
            return False
        self._maybe_attach()
        if self._conn is None:
            return False
        did = False
        first = True
        while True:
            try:
                if not self._conn.poll(poll_s if first else 0):
                    break
                data = self._conn.recv_bytes()
            except IPCError as e:
                # the transport caught a lie: a torn frame, a reset
                # mid-frame, an oversize length
                self.poisoned = True
                self.last_error = f"protocol error: {e}"
                break
            except (EOFError, OSError):
                break           # closed at a boundary: liveness decides
            first = False
            did = True
            try:
                kind, payload, seq = decode_frame(data)
                self._rx_seq = seq_check(seq, self._rx_seq)
                self.last_frame_t = self.clock()
                self._dispatch(kind, payload)
            except IPCError as e:
                self.poisoned = True
                self.last_error = f"protocol error: {e}"
                break
        return did

    def _dispatch(self, kind: str, payload: dict) -> None:
        if kind == READY:
            self.ready = True
            self.compiling = True       # the first chunks still compile
            self.last_heartbeat = self.clock()
            try:
                self.rss_mb = int(payload.get("rss_mb", 0))
            except (TypeError, ValueError):
                raise IPCError(f"malformed READY: {payload!r}") from None
            self.worker_weights_version = \
                str(payload.get("weights_version") or "")
            self.boot_s = self._boot_seconds(payload.get("boot"))
        elif kind in (HEARTBEAT, HARVEST):
            # ring increments, then results, then the snapshot that
            # counts them
            for ev in payload.get("events") or ():
                if isinstance(ev, dict):
                    self.flight.record(ev)
            if kind == HARVEST:
                for d in payload.get("results", ()):
                    self._absorb_result(d)
            if payload.get("snap") is not None:
                self._absorb_snapshot(payload["snap"])
            self.last_heartbeat = self.clock()
        elif kind == STATS:
            reply = payload.get("stats")
            if not isinstance(reply, dict):
                raise IPCError(f"malformed STATS: {payload!r}")
            self.stats_reply = reply
        elif kind == CRASH:
            self.crashed = True
            self.last_error = str(payload.get("error", "child crash"))
        elif kind == BYE:
            self.bye = True
        elif kind in (MIGRATE_OUT, MIGRATE_ACK):
            self.migrate_reply = payload
        else:
            raise IPCError(f"unexpected frame kind {kind!r} from child")

    def _boot_seconds(self, boot) -> Dict[str, float]:
        """READY's stamps as seconds from the launch (``ready`` the whole
        bring-up); advisory, so a malformed record is dropped. A worker
        started by hand was not launched here: only its own stages."""
        try:
            now = time.perf_counter()
            t0 = self._launch_pc if self._popen is not None \
                or self._proc is not None else float(boot["imported"])
            out = {k: round(float(boot[k]) - t0, 4)
                   for k in ("imported", "run", "model", "engine")}
        except (KeyError, TypeError, ValueError):
            return {}
        out["ready"] = round(now - t0, 4)
        return out

    def _absorb_result(self, d: dict) -> None:
        try:
            result = S.Result.from_wire(d)
        except (KeyError, TypeError, ValueError) as e:
            raise IPCError(f"malformed result: {e!r}") from None
        handle = self.shadow.pop(result.request_id, None)
        if handle is None or handle.done():
            return      # reclaimed and replayed already, or a stale echo
        # the child's spans join the parent's trace (one clock epoch)
        if handle.trace is not None and d.get("spans"):
            handle.trace.merge_wire(d["spans"], self.clock())
        # the caller's latency on the parent's clock
        result.total_s = round(self.clock() - handle.request.submit_t, 6)
        if self.on_done is not None:
            self.on_done(handle, result)
        else:
            handle.fulfill(result)

    def _absorb_snapshot(self, snap: dict) -> None:
        (self.counter_state, self.progress, self.active, self.queued,
         self.chunks, self.compiling, self.rss_mb, stamp,
         self.pages_free, self.hol,
         self.paged_decode_launches) = _snap_fields(snap)
        self.step_clock = (stamp, self.counter_state["decode_steps"])
        self.ipc_lag_s.append(max(time.perf_counter() - stamp, 0.0))

    # -- supervision surface ------------------------------------------------

    def active_slots(self) -> int:
        return self.active

    def inflight_handles(self) -> List[S.RequestHandle]:
        return list(self.shadow.values())

    def alive_proc(self) -> bool:
        """Liveness by the strongest signal: a dead socket is a dead
        replica; a local process (spawn or launcher) answers by PID; a
        worker not yet attached counts as alive (the attach deadline
        bounds that phase)."""
        if self._conn is not None and self._conn.kind == "socket" \
                and not self._conn.alive():
            return False
        if self._proc is not None:
            return self._proc.is_alive()
        if self._popen is not None:
            if self._popen.poll() is None:
                return True
            # the launcher exited: believe the live socket
            return self._conn is not None and self._conn.alive()
        if self._conn is None:
            return True
        return self._conn.alive()

    @staticmethod
    def _decode_exit(code: Optional[int]) -> str:
        if code is None:
            return "running"
        if code < 0:
            try:
                name = signal.Signals(-code).name
            except ValueError:
                name = f"signal {-code}"
            return f"killed by {name}"
        if code == OOM_EXIT:
            return f"oom-killed (exit {OOM_EXIT}: child RSS limit)"
        if code == BAD_CKPT_EXIT:
            return (f"invalid checkpoint (exit {BAD_CKPT_EXIT}: the "
                    f"worker's local checkpoint failed validation)")
        return f"exit code {code}"

    def exit_desc(self) -> str:
        """How the child died: the signal, the watchdog's 137, the
        checkpoint's 5 or the code; a remote worker has only its
        connection's state."""
        if self._proc is not None:
            return self._decode_exit(self._proc.exitcode)
        if self._popen is not None:
            return self._decode_exit(self._popen.poll())
        if self._conn is None:
            return "no worker attached"
        return f"remote worker: {self._conn.state_desc()}"

    def transport_info(self, now: Optional[float] = None) -> dict:
        """The per-replica transport block of /healthz and /stats."""
        now = self.clock() if now is None else now
        info = {"transport": self.transport_kind,
                "peer": self.peer or "unattached",
                "last_frame_age_s": round(
                    max(now - self.last_frame_t, 0.0), 4)}
        if self.remote_host:
            info["worker_host"] = self.remote_host
        return info

    # -- fencing / teardown -------------------------------------------------

    def fence(self) -> None:
        """One way: no frame from the child is processed again. The
        transport is closed (a live remote worker EOFs and exits) and the
        dial-in expectation cancelled."""
        self.fenced = True
        if self._listener is not None:
            try:
                self._listener.cancel(self.index)
            except Exception:   # noqa: BLE001 — teardown best-effort
                pass
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass

    def hard_kill(self, join_s: float = 5.0) -> None:
        """SIGKILL the child (idempotent). A remote worker has no process
        here: the fence's close reaches it."""
        if self._proc is not None:
            if self._proc.is_alive():
                try:
                    self._proc.kill()
                except (OSError, ValueError):
                    pass
            self._proc.join(join_s)
        elif self._popen is not None:
            try:
                self._popen.kill()
            except OSError:
                pass
            try:
                self._popen.wait(join_s)
            except (OSError, subprocess.TimeoutExpired):
                pass

    def salvage(self) -> None:
        """After the child is down, before ``fence``: absorb every whole
        frame it wrote. Results that made it fulfil their handles; the
        last snapshot is the last consistent counter state."""
        while self.pump():
            pass

    def reclaim(self) -> List[S.RequestHandle]:
        """Every routed, still-open handle (the replay set); clears the
        shadow. Once, after ``salvage`` and ``fence``."""
        out = [h for h in self.shadow.values() if not h.done()]
        self.shadow.clear()
        return out

    def retire_counters(self,
                        reclaimed: List[S.RequestHandle]) -> Dict[str, int]:
        """The dead child's counters less the reclaimed requests'
        harvested prefixes: their replay re-credits every token."""
        out = dict(self.counter_state)
        for h in reclaimed:
            n = self.progress.get(h.request.request_id, 0)
            out["tokens_decoded"] -= n
            out["occupancy_sum"] -= n
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Ask, wait, then kill; salvage and fence either way. A remote
        worker gets SHUTDOWN and a bounded wait for its BYE. A child still
        in bring-up holds no work (routing waits for READY) and would
        hear the shutdown only once its engine is built: it is killed at
        once."""
        if self._proc is not None:
            # wait only for a child that hears the shutdown
            if self.ready and self._proc.is_alive() \
                    and self._send(SHUTDOWN, {}):
                self._proc.join(timeout)
        elif self._popen is not None:
            if self.ready and self._popen.poll() is None \
                    and self._send(SHUTDOWN, {}):
                try:
                    self._popen.wait(timeout)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        elif self._conn is not None and self._conn.alive():
            self._send(SHUTDOWN, {})
            deadline = time.perf_counter() + timeout
            while not self.bye and time.perf_counter() < deadline:
                if self.poisoned or not self._conn.alive():
                    break
                if not self.pump(0.05):
                    time.sleep(0.01)
        self.hard_kill()
        self.salvage()
        self.fence()
