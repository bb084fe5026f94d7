"""How frame bytes move between the replica set and its process workers.

Port of ``dalle_pytorch_tpu/serve/transport.py``. ``serve/ipc.py`` speaks
framed, versioned, sequence-numbered, CRC-checked messages; this module
is what lies under the frames. Two transports share one contract
(``send_bytes`` / ``poll`` / ``recv_bytes``, the surface of a
``multiprocessing`` connection):

* ``PipeTransport``: a duplex ``multiprocessing`` pipe to a local child.
  The OS delivers each write whole.
* ``SocketTransport``: a TCP stream, framed as ``[u32 little-endian
  length][frame]``. A stream fails in ways a pipe cannot, and each one
  surfaces TYPED, never as a hang or a partial parse: a frame arriving
  in fragments is buffered to its boundary before it is handed up; EOF
  or a reset with part of a frame buffered is ``IPCError`` (a torn
  frame), a clean FIN at a boundary ``EOFError``, an RST there
  ``ConnectionResetError``; an oversize length prefix is ``IPCError``
  before anything is allocated; every receive is non-blocking behind
  ``poll``'s ``select``, and a send that the peer stops draining times
  out as ``BrokenPipeError``.

``WorkerListener`` is the parent's dial-in endpoint: workers connect TO
the parent, and the first frame on a connection must be a HELLO with the
shared token (``serve/auth.py``'s constant-time check; it travels in the
``DALLE_WORKER_TOKEN`` environment variable, never in argv), the
protocol version and the replica index the worker claims. A bad token, a
skewed version or an index nobody expects closes the connection and
attaches nothing. On success the parent answers HELLO_OK and sends the
worker's spec (weights and config, pickled) down the same socket, so a
worker started by hand needs only the endpoint, the token and an index:
``python -m dalle_pytorch_tpu_torch.serve.worker --connect HOST:PORT
--index N``. Only the worker unpickles, and only from the endpoint its
operator named; the parent parses nothing but JSON frames off the
network.
"""

from __future__ import annotations

import os
import pickle
import secrets
import select
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from dalle_pytorch_tpu_torch.serve import auth

# the variable a hand-started or launcher-started worker reads its HELLO
# token from (not argv: the secret must not show in `ps`)
TOKEN_ENV = "DALLE_WORKER_TOKEN"

# the socket frames' length prefix; the cap bounds what a garbage length
# can make the receive buffer take
_LEN = struct.Struct("<I")
MAX_FRAME_BYTES = 1 << 30


class IPCError(RuntimeError):
    """A frame or stream that cannot be believed: truncated, wrong magic,
    version skew, checksum mismatch, broken sequence, unparseable
    payload, mid-frame EOF, or a reset that tore a frame. The one safe
    answer is to FENCE the peer."""


class PipeTransport:
    """A ``multiprocessing`` duplex pipe behind the transport contract."""

    kind = "pipe"

    def __init__(self, conn):
        self._conn = conn
        self._closed = False
        self.peer = "pipe"

    def send_bytes(self, data: bytes) -> None:
        self._conn.send_bytes(data)

    def poll(self, timeout: float = 0.0) -> bool:
        if self._closed:
            return False
        return self._conn.poll(timeout)

    def recv_bytes(self) -> bytes:
        return self._conn.recv_bytes()

    def alive(self) -> bool:
        # a pipe lives as long as its process: the owner checks the PID
        return not self._closed

    def state_desc(self) -> str:
        return "closed" if self._closed else "open"

    def close(self) -> None:
        self._closed = True
        try:
            self._conn.close()
        except (OSError, AttributeError):
            pass


class SocketTransport:
    """A TCP stream behind the transport contract. ``poll`` selects and
    drains the socket into a buffer; ``recv_bytes`` hands back one whole
    frame from it or raises; no call blocks past ``poll``'s timeout, so a
    stalled peer is a heartbeat problem, never a wedged thread. Sends
    loop over ``select`` against a deadline."""

    kind = "socket"

    def __init__(self, sock: socket.socket, send_timeout_s: float = 30.0):
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                      # not TCP (a socketpair in tests)
        self._sock = sock
        self._send_timeout_s = float(send_timeout_s)
        self._buf = bytearray()
        self._eof = False
        self._reset: Optional[OSError] = None
        self._closed = False
        try:
            name = sock.getpeername()
            self.peer = (f"{name[0]}:{name[1]}"
                         if isinstance(name, tuple) and len(name) >= 2
                         else (str(name) or "socket"))
        except OSError:
            self.peer = "socket"
        # the worker's HELLO (pid, host), filled by the listener:
        # observability, never trusted for liveness
        self.hello: dict = {}

    # -- receive ------------------------------------------------------------

    def _fill(self) -> None:
        """Drain what the socket holds NOW into the buffer. EOF and
        resets are recorded, not raised: ``recv_bytes`` knows whether a
        partial frame makes them a tear."""
        if self._eof or self._closed:
            return
        while True:
            try:
                chunk = self._sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._eof = True
                self._reset = e
                return
            if not chunk:
                self._eof = True
                return
            self._buf += chunk

    def _ready(self) -> bool:
        """A whole frame is buffered, or an error is ready to raise."""
        if len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                return True           # recv_bytes raises the IPCError
            if len(self._buf) >= _LEN.size + n:
                return True
        return self._eof

    def poll(self, timeout: float = 0.0) -> bool:
        """True when ``recv_bytes`` will return a frame or raise; never
        blocks past ``timeout``."""
        if self._closed:
            return False
        if self._ready():
            return True
        self._fill()
        if self._ready():
            return True
        if timeout > 0 and not self._eof:
            try:
                r, _, _ = select.select([self._sock], [], [], timeout)
            except (OSError, ValueError):
                return True           # the fd died: recv_bytes says so
            if r:
                self._fill()
        return self._ready()

    def recv_bytes(self) -> bytes:
        if self._closed:
            raise EOFError("transport closed locally")
        if not self._ready():
            self._fill()
        if len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                raise IPCError(
                    f"declared frame length {n} exceeds the "
                    f"{MAX_FRAME_BYTES}-byte cap (corrupt stream)")
            if len(self._buf) >= _LEN.size + n:
                frame = bytes(self._buf[_LEN.size:_LEN.size + n])
                del self._buf[:_LEN.size + n]
                return frame
        if self._eof:
            if self._buf:
                how = (f"connection reset ({self._reset!r})"
                       if self._reset is not None else "peer closed")
                raise IPCError(
                    f"mid-frame EOF: {how} with {len(self._buf)} bytes "
                    f"of a partial frame buffered")
            if self._reset is not None:
                raise ConnectionResetError(str(self._reset))
            raise EOFError("peer closed the connection")
        raise BlockingIOError("no complete frame buffered (poll first)")

    # -- send ---------------------------------------------------------------

    def send_bytes(self, data: bytes) -> None:
        self._send_all(_LEN.pack(len(data)) + data)

    def send_partial_frame(self, frame: bytes, upto: int) -> None:
        """Fault injection only: the length prefix of the FULL frame, then
        its first ``upto`` bytes (a deterministic torn frame)."""
        self._send_all((_LEN.pack(len(frame)) + frame)[:_LEN.size + upto])

    def _send_all(self, payload: bytes) -> None:
        if self._closed:
            raise BrokenPipeError("transport closed locally")
        view = memoryview(payload)
        off = 0
        deadline = time.perf_counter() + self._send_timeout_s
        while off < len(payload):
            try:
                off += self._sock.send(view[off:])
                continue
            except (BlockingIOError, InterruptedError):
                pass
            left = deadline - time.perf_counter()
            if left <= 0:
                # a peer that stopped reading is a dead peer to the sender
                raise BrokenPipeError(
                    f"send stalled > {self._send_timeout_s:g}s "
                    f"(peer not reading)")
            try:
                select.select([], [self._sock], [], min(left, 0.5))
            except (OSError, ValueError) as e:
                raise BrokenPipeError(f"socket died mid-send: {e!r}")

    # -- lifecycle ----------------------------------------------------------

    def set_send_timeout(self, s: float) -> None:
        """Bound how long a send may block. The parent shortens it once
        it adopts a worker's transport: one control thread supervises
        every replica, and a peer that stops reading must cost a failed
        send (fenced by supervision), not everyone's deadlines."""
        self._send_timeout_s = float(s)

    def alive(self) -> bool:
        return not self._closed and not self._eof

    def state_desc(self) -> str:
        if self._closed:
            return "closed"
        if self._reset is not None:
            return "connection reset"
        if self._eof:
            return "connection closed by peer"
        return "open"

    def reset_hard(self) -> None:
        """Abort with an RST instead of a FIN (SO_LINGER 0): the fault
        catalog's stand-in for a network reset."""
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the handshake (the worker dials the parent)
# ---------------------------------------------------------------------------


def _recv_frame_deadline(transport, timeout_s: float) -> bytes:
    """One frame within ``timeout_s`` (the handshake only)."""
    deadline = time.perf_counter() + timeout_s
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            raise IPCError(f"handshake timed out after {timeout_s:g}s")
        if transport.poll(min(left, 0.25)):
            return transport.recv_bytes()


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    """``"host:port"`` -> ``(host, port)``; a bare ``":port"`` binds every
    interface."""
    host, sep, port = endpoint.rpartition(":")
    if not sep:
        raise ValueError(f"endpoint must be HOST:PORT, got {endpoint!r}")
    return host or "0.0.0.0", int(port)


def dial_parent(host: str, port: int, token: str, index: int, *,
                timeout_s: float = 60.0):
    """The worker's side of the attach: connect, HELLO (token, protocol
    version, index), await HELLO_OK, receive the pickled spec. Returns
    ``(transport, spec)``; any refusal is ``IPCError`` (the parent
    answers a bad HELLO by closing)."""
    from dalle_pytorch_tpu_torch.serve import ipc

    sock = socket.create_connection((host, port), timeout=timeout_s)
    transport = SocketTransport(sock)
    transport.send_bytes(ipc.encode_frame(ipc.HELLO, {
        "token": token, "version": ipc.PROTOCOL_VERSION,
        "index": int(index), "pid": os.getpid(),
        "host": socket.gethostname()}, seq=0))
    try:
        kind, payload, seq = ipc.decode_frame(
            _recv_frame_deadline(transport, timeout_s))
        if kind != ipc.HELLO_OK or seq != 0:
            raise IPCError(f"expected HELLO_OK/0, got {kind}/{seq}")
        spec = pickle.loads(_recv_frame_deadline(transport, timeout_s))
    except (EOFError, ConnectionResetError, OSError):
        # a parent that closes anywhere in the handshake refused us
        transport.close()
        raise IPCError(
            "parent closed during handshake (bad token, wrong index, "
            "or version skew)") from None
    except IPCError:
        transport.close()
        raise
    return transport, spec


class WorkerListener:
    """The parent's dial-in endpoint, shared by every socket replica. One
    accept thread, and a short-lived thread per handshake, so a dialer
    that connects and says nothing times out alone. A worker that passes
    the HELLO gets its spec and its transport is parked for
    ``ChildEngineClient`` to adopt; anything else is closed and counted
    (``rejected``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 token: Optional[str] = None,
                 handshake_timeout_s: float = 10.0,
                 on_event: Optional[Callable[[dict], None]] = None):
        self.token = token or secrets.token_hex(16)
        self._handshake_timeout_s = float(handshake_timeout_s)
        self._on_event = on_event
        self._sock = socket.create_server((host, port), backlog=16)
        name = self._sock.getsockname()
        self.host, self.port = name[0], int(name[1])
        self.endpoint = f"{self.host}:{self.port}"
        # a bind address is not a destination: what a local spawn dials,
        # and what a remote worker is told to dial
        self.dial_host = "127.0.0.1" if self.host == "0.0.0.0" \
            else self.host
        self.advertise_endpoint = (
            f"{socket.gethostname()}:{self.port}"
            if self.host == "0.0.0.0" else self.endpoint)
        self._lock = threading.Lock()
        self._expected: Dict[int, bytes] = {}       # index -> spec blob
        self._attached: Dict[int, SocketTransport] = {}
        self.rejected = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="serve-worker-listener")
        self._thread.start()

    # -- the registry (ChildEngineClient's calls) ---------------------------

    def expect(self, index: int, spec_blob: bytes) -> None:
        """A worker for replica ``index`` may dial in and get
        ``spec_blob``. Re-registering replaces, and closes a stale
        transport nobody took (its worker EOFs and exits)."""
        with self._lock:
            self._expected[int(index)] = spec_blob
            stale = self._attached.pop(int(index), None)
        if stale is not None:
            stale.close()

    def cancel(self, index: int) -> None:
        with self._lock:
            self._expected.pop(int(index), None)
            t = self._attached.pop(int(index), None)
        if t is not None:
            t.close()

    def take(self, index: int) -> Optional[SocketTransport]:
        """The transport a worker for ``index`` attached on since the
        last call, if any."""
        with self._lock:
            return self._attached.pop(int(index), None)

    def expected_indices(self) -> list:
        """The replica indices a worker may dial in as now (``/stats``):
        replicas born at runtime register, retired ones cancel."""
        with self._lock:
            return sorted(self._expected)

    # -- accept / handshake -------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event({"kind": kind, **fields})
            except Exception:   # noqa: BLE001 — observability only
                pass

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return              # the listener closed
            threading.Thread(
                target=self._handshake, args=(conn, addr), daemon=True,
                name="serve-worker-handshake").start()

    def _handshake(self, conn: socket.socket, addr) -> None:
        from dalle_pytorch_tpu_torch.serve import ipc

        transport = SocketTransport(conn)
        peer = transport.peer
        try:
            kind, payload, seq = ipc.decode_frame(_recv_frame_deadline(
                transport, self._handshake_timeout_s))
            if kind != ipc.HELLO or seq != 0:
                raise IPCError(f"first frame must be HELLO/0, "
                               f"got {kind}/{seq}")
            token = payload.get("token")
            index = payload.get("index")
            if not auth.check_token(token, self.token):
                raise IPCError("HELLO rejected: bad token")
            if not isinstance(index, int):
                raise IPCError("HELLO rejected: no index")
        except (IPCError, EOFError, ConnectionResetError, OSError) as e:
            self.rejected += 1
            self._event("serve_attach_rejected", peer=peer, error=repr(e))
            transport.close()
            return
        with self._lock:
            spec_blob = self._expected.get(index)
            if spec_blob is None or index in self._attached:
                self.rejected += 1
                self._event("serve_attach_rejected", peer=peer,
                            error=f"unexpected replica index {index}")
                transport.close()
                return
        try:
            transport.send_bytes(ipc.encode_frame(
                ipc.HELLO_OK, {"index": index}, seq=0))
            transport.send_bytes(spec_blob)
        except OSError as e:
            self.rejected += 1
            self._event("serve_attach_rejected", peer=peer,
                        error=f"spec hand-off failed: {e!r}")
            transport.close()
            return
        transport.hello = {k: payload.get(k) for k in ("pid", "host")}
        with self._lock:
            # attach once, and only while the expectation this dialer was
            # served under is still the current one: the lock was free
            # during the hand-off, when the replica may have been fenced
            # and re-registered (a new spec object) or another dialer won
            if index in self._attached \
                    or self._expected.get(index) is not spec_blob:
                self.rejected += 1
                stale = True
            else:
                self._expected.pop(index)
                self._attached[index] = transport
                stale = False
        if stale:
            self._event("serve_attach_rejected", peer=peer,
                        error=f"lost the attach race for replica "
                              f"{index} (stale or duplicate dialer)")
            transport.close()
            return
        self._event("serve_worker_attached", peer=peer, index=index,
                    pid=payload.get("pid"), host=payload.get("host"))

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            attached = list(self._attached.values())
            self._attached.clear()
            self._expected.clear()
        for t in attached:
            t.close()
