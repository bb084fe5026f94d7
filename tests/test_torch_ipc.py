"""The port's IPC layer (``serve/ipc.py``, ``serve/transport.py``) on the
CPU, against the JAX package's.

* the frame codec is byte-identical: for every kind, the same payload and
  sequence number encode to the same bytes in both packages, and each
  package decodes the other's frames;
* every untrustworthy frame is the same typed error in both: truncation,
  bad magic, version skew, an unknown kind, a flipped byte, a non-object
  payload, a broken sequence (gap, duplicate);
* ``Request``, ``RequestHandle`` and ``Result`` wire dicts equal JAX's,
  and ``Result.from_wire`` refuses an unknown status as JAX's does;
* the socket transport never surfaces a frame early whatever the split
  (every byte boundary, and seeded random fragments written by the
  test's own thread between reads), and tears, resets and oversize
  prefixes are typed;
* a ``ChildEngineClient`` fed garbage, a duplicate, a gap or a reorder
  poisons itself instead of hanging; a fenced client drops late frames;
  salvage fulfils what the child shipped and the retire arithmetic
  un-credits the reclaimed prefixes, as JAX's client does;
* the HELLO handshake: a good token attaches and receives the spec (the
  port's worker side against JAX's listener too), a bad token, an
  unexpected index and a silent dialer attach nothing.
"""

import pickle
import random
import socket
import struct
import time
from collections import deque

import numpy as np
import pytest

from dalle_pytorch_tpu.serve import ipc as JIPC
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve import transport as JT
from dalle_pytorch_tpu_torch.serve import ipc
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T

PAYLOAD = {"n": 3, "x": [1, 2.5, None, "s"], "nested": {"a": [True, -7]},
           "f": 0.1, "big": 2 ** 40, "text": "é ü"}


# -- the frame codec ----------------------------------------------------------


def test_protocol_constants_equal_jax():
    assert ipc.PROTOCOL_VERSION == JIPC.PROTOCOL_VERSION == 2
    assert ipc.KINDS == JIPC.KINDS
    assert ipc._MAGIC == JIPC._MAGIC == 0xD5
    assert ipc._HEADER.format == JIPC._HEADER.format == "<BBBxII"
    assert (ipc.HARVEST_BATCH, ipc.OOM_EXIT, ipc.BAD_CKPT_EXIT) == \
        (JIPC.HARVEST_BATCH, JIPC.OOM_EXIT, JIPC.BAD_CKPT_EXIT)
    assert T.TOKEN_ENV == JT.TOKEN_ENV
    assert T.MAX_FRAME_BYTES == JT.MAX_FRAME_BYTES


@pytest.mark.parametrize("kind", ipc.KINDS)
@pytest.mark.parametrize("seq", [0, 1, 77, 2 ** 32 - 1, 2 ** 32 + 5])
def test_frames_are_byte_identical_to_jax(kind, seq):
    payload = {"kind": kind, **PAYLOAD}
    frame = ipc.encode_frame(kind, payload, seq=seq)
    assert frame == JIPC.encode_frame(kind, payload, seq=seq)
    # each package decodes the other's frame
    assert ipc.decode_frame(JIPC.encode_frame(kind, payload, seq)) == \
        JIPC.decode_frame(frame) == (kind, payload, seq & 0xFFFFFFFF)


def _bad_frames():
    good = ipc.encode_frame(ipc.HEARTBEAT, {"t": 1.5, "a": 1})
    magic = bytearray(good)
    magic[0] ^= 0xFF
    skew = bytearray(good)
    skew[1] += 1
    kind = bytearray(good)
    kind[2] = 250
    flip = bytearray(good)
    flip[-3] ^= 0x10
    import json
    import zlib
    body = json.dumps([1, 2, 3]).encode()
    listy = struct.Struct("<BBBxII").pack(
        0xD5, ipc.PROTOCOL_VERSION, 4, 0, zlib.crc32(body)) + body
    junk = b"{not json"
    unparse = struct.Struct("<BBBxII").pack(
        0xD5, ipc.PROTOCOL_VERSION, 4, 0, zlib.crc32(junk)) + junk
    return [("empty", b"", "truncated"), ("header", good[:4], "truncated"),
            ("short_body", good[:-2], "checksum"),
            ("garbage", b"\xde\xad\xbe\xef not a frame", "magic"),
            ("magic", bytes(magic), "magic"),
            ("skew", bytes(skew), "version skew"),
            ("kind", bytes(kind), "kind"),
            ("flip", bytes(flip), "checksum"),
            ("list", listy, "object"), ("json", unparse, "unparseable")]


@pytest.mark.parametrize("name,data,match", _bad_frames(),
                         ids=[c[0] for c in _bad_frames()])
def test_bad_frames_raise_the_same_typed_error(name, data, match):
    with pytest.raises(ipc.IPCError, match=match) as port:
        ipc.decode_frame(data)
    with pytest.raises(JIPC.IPCError) as jax_err:
        JIPC.decode_frame(data)
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("got,expected,match", [
    (5, 5, None), (4, 5, "duplicate or reordered"), (7, 5, "gap"),
    (3, 2 ** 32 + 3, None)])
def test_seq_check_matches_jax(got, expected, match):
    if match is None:
        assert ipc.seq_check(got, expected) == \
            JIPC.seq_check(got, expected) == expected + 1
        return
    with pytest.raises(ipc.IPCError, match=match) as port:
        ipc.seq_check(got, expected)
    with pytest.raises(JIPC.IPCError) as jax_err:
        JIPC.seq_check(got, expected)
    assert str(port.value) == str(jax_err.value)


# -- the wire dicts -----------------------------------------------------------


def _requests(mod, rng, n):
    out = []
    for i in range(n):
        r = mod.Request(
            codes=tuple(rng.randrange(1, 50)
                        for _ in range(rng.randrange(1, 9))),
            seed=rng.randrange(-2 ** 31, 2 ** 31),
            sampling=mod.SamplingParams(
                temperature=rng.uniform(0.05, 3.0),
                filter_thres=rng.uniform(0.0, 0.99),
                top_p=rng.choice([0.0, rng.uniform(0.1, 1.0)])),
            priority=rng.randrange(-3, 4),
            deadline_s=rng.choice([None, rng.uniform(0.001, 1e4)]),
            cfg_scale=rng.choice([0.0, 3.0]),
            tenant=rng.choice(["", "acme"]),
            stream=rng.choice([False, True]),
            n_samples=rng.choice([1, 3]),
            image_seq_len_override=rng.choice([0, 8]),
            request_id=i, submit_t=rng.uniform(0, 1e6))
        h = mod.RequestHandle(r)
        h.queue_seq = rng.randrange(0, 10 ** 9)
        out.append(h)
    return out


def test_request_and_handle_wire_dicts_equal_jax():
    """60 fuzzed handles: the port's wire dict is JAX's, it survives a
    frame, and each package rebuilds the other's request exactly."""
    now = 123.25
    ours = _requests(S, random.Random(0xDA11E), 60)
    theirs = _requests(JS, random.Random(0xDA11E), 60)
    for h, j in zip(ours, theirs):
        wire = h.to_wire(now)
        assert wire == j.to_wire(now)
        _, payload, _ = ipc.decode_frame(JIPC.encode_frame(
            JIPC.ADMIT, {"requests": [wire]}, seq=3))
        back = S.RequestHandle.from_wire(payload["requests"][0], now=now)
        jback = JS.RequestHandle.from_wire(payload["requests"][0], now=now)
        assert back.to_wire(now) == jback.to_wire(now) == wire
        assert back.queue_seq == h.queue_seq


def _results(mod):
    rng = random.Random(7)
    toks = [rng.randrange(0, 512) for _ in range(48)]
    return [
        mod.Result(status=mod.OK, request_id=1,
                   tokens=np.asarray(toks, np.int32),
                   text_tokens=np.asarray([3, 1, 4, 1, 5], np.int32),
                   weights_version="v2", queued_s=0.125, decode_s=1.5,
                   total_s=1.625, clip_score=0.5, image=np.zeros(3),
                   samples=[mod.Result(status=mod.OK, request_id=9)]),
        mod.Result(status=mod.ERROR, request_id=2,
                   reason="prefill failed: boom"),
        mod.Result(status=mod.DEADLINE_EXCEEDED, request_id=3,
                   reason="deadline_s=1 exceeded (queued)", queued_s=1.0,
                   total_s=1.0),
        mod.Result(status=mod.CANCELLED, request_id=4,
                   reason="server shutdown"),
        mod.Result(status=mod.REJECTED, request_id=5, reason="queue_full")]


@pytest.mark.parametrize("i", range(5))
def test_result_wire_dicts_equal_jax(i):
    res, jres = _results(S)[i], _results(JS)[i]
    wire = res.to_wire()
    assert wire == jres.to_wire()
    assert not {"image", "clip_score", "samples", "trace"} & set(wire)
    _, payload, _ = ipc.decode_frame(JIPC.encode_frame(
        JIPC.HARVEST, {"results": [jres.to_wire()], "snap": None}))
    back = S.Result.from_wire(payload["results"][0])
    jback = JS.Result.from_wire(payload["results"][0])
    for name in ("status", "request_id", "reason", "weights_version",
                 "queued_s", "decode_s", "total_s"):
        assert getattr(back, name) == getattr(jback, name)
    for name in ("tokens", "text_tokens"):
        a, b = getattr(back, name), getattr(jback, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, np.asarray(b))
    assert back.image is None and back.clip_score is None


def test_result_from_wire_refuses_unknown_status_as_jax_does():
    wire = S.Result(status=S.OK, request_id=1).to_wire()
    wire["status"] = "mystery"
    with pytest.raises(ValueError, match="status") as port:
        S.Result.from_wire(wire)
    with pytest.raises(ValueError) as jax_err:
        JS.Result.from_wire(wire)
    assert str(port.value) == str(jax_err.value)
    del wire["weights_version"]
    wire["status"] = S.OK
    assert S.Result.from_wire(wire).weights_version == ""


# -- the socket transport -----------------------------------------------------


def _pair():
    a, b = socket.socketpair()
    return a, T.SocketTransport(b)


def _framed(frame: bytes) -> bytes:
    return struct.pack("<I", len(frame)) + frame


FRAME = ipc.encode_frame(ipc.HARVEST, {"results": [{"k": i}
                                                   for i in range(4)],
                                       "snap": None}, seq=7)


def test_split_point_matrix_every_byte_boundary():
    """Two writes split at every byte boundary: no frame surfaces early,
    and the whole one decodes, whatever the fragmentation."""
    framed = _framed(FRAME)
    for split in range(1, len(framed)):
        a, tb = _pair()
        a.sendall(framed[:split])
        assert not tb.poll(0), f"frame surfaced early at {split}"
        a.sendall(framed[split:])
        assert tb.poll(0.5)
        kind, payload, seq = ipc.decode_frame(tb.recv_bytes())
        assert (kind, seq) == (ipc.HARVEST, 7)
        assert payload["results"] == [{"k": i} for i in range(4)]
        a.close()
        tb.close()


def test_seeded_fragments_fed_between_reads():
    """50 frames in seeded 1..17-byte slices, each written by this thread
    between two non-blocking reads: every frame arrives whole, in order,
    consecutive sequence numbers, and none before its last byte."""
    rng = random.Random(0xF4A6)
    frames = [ipc.encode_frame(ipc.HEARTBEAT, {"i": i}, seq=i)
              for i in range(50)]
    stream = b"".join(_framed(f) for f in frames)
    ends = np.cumsum([len(_framed(f)) for f in frames])
    a, tb = _pair()
    got, expected_seq, off = [], 0, 0
    while off < len(stream):
        n = rng.randrange(1, 18)
        a.sendall(stream[off:off + n])
        off = min(off + n, len(stream))
        while tb.poll(0):
            kind, payload, seq = ipc.decode_frame(tb.recv_bytes())
            expected_seq = ipc.seq_check(seq, expected_seq)
            got.append(payload["i"])
        # exactly the frames whose last byte is written have surfaced
        assert len(got) == int(np.searchsorted(ends, off, side="right"))
    a.close()
    assert got == list(range(50))
    assert tb.poll(0.5)
    with pytest.raises(EOFError):
        tb.recv_bytes()


@pytest.mark.parametrize("cut", [1, 2, 3, 5, 8, 40, -2, -1])
def test_mid_frame_eof_is_typed(cut):
    """A peer that dies between two writes of one frame: cut the framed
    bytes and close; past the length prefix, a typed tear."""
    framed = _framed(FRAME)
    cut = cut % len(framed)
    a, tb = _pair()
    a.sendall(framed[:cut])
    a.close()
    assert tb.poll(0.5)
    with pytest.raises((T.IPCError, EOFError)) as ei:
        tb.recv_bytes()
    if cut > 4:
        assert isinstance(ei.value, T.IPCError)
        assert "mid-frame EOF" in str(ei.value)


def test_clean_eof_reset_and_oversize():
    a, tb = _pair()
    a.sendall(_framed(FRAME))
    a.close()
    assert tb.poll(0.5)
    ipc.decode_frame(tb.recv_bytes())
    with pytest.raises(EOFError):
        tb.recv_bytes()
    assert not tb.alive() and tb.state_desc() == "connection closed by peer"
    # half a frame, then an abortive close
    a, tb = _pair()
    ta = T.SocketTransport(a)
    ta.send_partial_frame(FRAME, len(FRAME) // 2)
    ta.reset_hard()
    assert tb.poll(0.5)
    with pytest.raises(T.IPCError, match="mid-frame EOF"):
        tb.recv_bytes()
    # a garbage length prefix is refused before it is allocated
    a, tb = _pair()
    a.sendall(struct.pack("<I", T.MAX_FRAME_BYTES + 1) + b"x" * 64)
    assert tb.poll(0.5)
    with pytest.raises(T.IPCError, match="cap"):
        tb.recv_bytes()
    # a silent peer costs the poll timeout, no more
    _, tb = _pair()
    t0 = time.perf_counter()
    assert not tb.poll(0.1)
    assert time.perf_counter() - t0 < 1.0


def test_send_to_a_peer_that_stops_reading_times_out():
    a, tb = _pair()
    tb.set_send_timeout(0.2)
    with pytest.raises(BrokenPipeError, match="stalled"):
        for _ in range(10_000):
            tb.send_bytes(b"x" * 65536)
    a.close()


# -- the client's poisoned-not-deadlocked contract ----------------------------


class FakeConn:
    """The parent end of a transport, with scripted frames."""

    kind = "fake"

    def __init__(self, frames):
        self.frames = list(frames)

    def poll(self, timeout=0):
        return bool(self.frames)

    def recv_bytes(self):
        if not self.frames:
            raise EOFError
        return self.frames.pop(0)

    def send_bytes(self, data):
        pass

    def alive(self):
        return True

    def close(self):
        pass


def shell(mod):
    """A ``ChildEngineClient`` of ``mod`` with the spawn bypassed."""
    c = mod.ChildEngineClient.__new__(mod.ChildEngineClient)
    c.clock = time.perf_counter
    c.index = 0
    c.num_slots, c.chunk_steps, c.kv = 2, 4, "dense"
    c.on_done = None
    c.ready = True
    c.fenced = c.crashed = c.poisoned = c.bye = False
    c.last_error = ""
    c.shadow = {}
    c.counter_state = {k: 0 for k in mod.COUNTERS}
    c.progress = {}
    c.active = c.queued = c.chunks = c.rss_mb = 0
    c.compiling = False
    c.pages_free = -1
    c.hol = None
    c.paged_decode_launches = 0
    c.last_heartbeat = c.last_frame_t = time.perf_counter()
    c.stats_reply = c.migrate_reply = None
    c.transport_kind, c.peer, c.remote_host = "pipe", "fake", ""
    c.awaiting_operator = False
    c.pid = 1
    c._listener = c._proc = c._popen = None
    c._tx_seq = c._rx_seq = 0
    c.ipc_lag_s = deque(maxlen=100)
    from dalle_pytorch_tpu.obs import flight as jflight
    from dalle_pytorch_tpu_torch.obs import flight as tflight
    c.flight = (tflight if mod is ipc else jflight).FlightRecorder(64)
    return c


def heartbeat(seq):
    return ipc.encode_frame(ipc.HEARTBEAT, {"snap": None}, seq=seq)


POISON = {
    "garbage": ([b"\xde\xad garbage"], "protocol error"),
    "duplicate": ([heartbeat(0), heartbeat(0)], "duplicate or reordered"),
    "gap": ([heartbeat(0), heartbeat(2)], "gap"),
    "reorder": ([heartbeat(1), heartbeat(0)], "gap"),
    "snapshot": ([ipc.encode_frame(ipc.HEARTBEAT,
                                   {"snap": {"counters": "nope"}})],
                 "malformed snapshot"),
    "result": ([ipc.encode_frame(ipc.HARVEST, {
        "results": [{"id": 1, "status": 5}], "snap": None})],
        "malformed result"),
}


@pytest.mark.parametrize("case", sorted(POISON))
def test_client_poisons_as_jax_does(case):
    frames, match = POISON[case]
    out = {}
    for mod in (ipc, JIPC):
        c = shell(mod)
        c._conn = FakeConn(frames)
        t0 = time.perf_counter()
        assert c.pump() is True
        assert time.perf_counter() - t0 < 1.0     # returned, not hung
        out[mod.__name__] = (c.poisoned, c.last_error)
    port, jax_side = out.values()
    assert port[0] and match in port[1]
    assert port == jax_side


def test_fenced_client_drops_late_frames():
    h = S.RequestHandle(S.Request(codes=(1,), request_id=9))
    c = shell(ipc)
    c.shadow[9] = h
    res = S.Result(status=S.OK, request_id=9,
                   tokens=np.asarray([1, 2], np.int32))
    c._conn = FakeConn([ipc.encode_frame(
        ipc.HARVEST, {"results": [res.to_wire()], "snap": None})])
    c.fence()
    assert c.pump() is False
    assert not h.done()


def test_salvage_reclaim_and_retire_match_jax():
    """Frames written before death fulfil their handles (and leave the
    reclaim set); the retire arithmetic un-credits the reclaimed
    request's harvested prefix; the mirror ring holds the shipped
    events. The same frames give JAX's client the same numbers."""
    snap = {"counters": {"tokens_decoded": 3, "occupancy_sum": 5,
                         "completed": 1},
            "progress": {"2": 2}, "active_slots": 1, "queued": 0,
            "chunks": 1, "compiling": False, "rss_mb": 10,
            "t": time.perf_counter(), "pages_free": 7, "hol": [2, 3],
            "paged_decode_launches": 11}
    frame = ipc.encode_frame(ipc.HARVEST, {
        "results": [S.Result(status=S.OK, request_id=1,
                             tokens=np.asarray([5], np.int32)).to_wire()],
        "snap": snap, "events": [{"kind": "x"}, "junk"]})
    out = {}
    for mod, smod in ((ipc, S), (JIPC, JS)):
        done_h = smod.RequestHandle(smod.Request(codes=(1,), request_id=1))
        open_h = smod.RequestHandle(smod.Request(codes=(2,), request_id=2))
        c = shell(mod)
        c.shadow = {1: done_h, 2: open_h}
        c._conn = FakeConn([frame])
        c.salvage()
        c.fence()
        assert done_h.done() and done_h.result(0).status == smod.OK
        reclaimed = c.reclaim()
        assert reclaimed == [open_h]
        retired = c.retire_counters(reclaimed)
        out[mod.__name__] = (retired["tokens_decoded"],
                             retired["occupancy_sum"], c.pages_free,
                             c.hol, [e["kind"] for e in c.flight.dump()])
    port, jax_side = out.values()
    assert port == (1, 3, 7, (2, 3), ["x"])
    assert port == jax_side


def test_snapshot_of_a_peer_without_new_fields_decodes():
    """A snapshot with no ``hol``, no K4 launches and an unknown counter
    decodes with their defaults (field tolerance, never a fence)."""
    c = shell(ipc)
    c._conn = FakeConn([ipc.encode_frame(ipc.HEARTBEAT, {"snap": {
        "counters": {"tokens_decoded": 4, "decode_traces": 1},
        "progress": {}, "active_slots": 0, "queued": 0, "chunks": 0,
        "compiling": True, "rss_mb": 1, "t": time.perf_counter(),
        "pages_free": -1}})])
    c.pump()
    assert not c.poisoned
    assert c.tokens_decoded == 4 and c.hol is None
    assert c.paged_decode_launches == 0


# -- the HELLO handshake ------------------------------------------------------


def _take(listener, index, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        t = listener.take(index)
        if t is not None:
            return t
        time.sleep(0.01)
    return None


@pytest.mark.parametrize("side", ["port", "port_worker_jax_listener"])
def test_good_token_attaches_and_receives_the_spec(side):
    make = T.WorkerListener if side == "port" else JT.WorkerListener
    listener = make("127.0.0.1", 0, handshake_timeout_s=5.0)
    try:
        spec = {"index": 3, "hello": "world", "n": [1, 2, 3]}
        listener.expect(3, pickle.dumps(spec))
        assert listener.expected_indices() == [3]
        transport, got = T.dial_parent("127.0.0.1", listener.port,
                                       listener.token, 3, timeout_s=10.0)
        assert got == spec
        attached = _take(listener, 3)
        assert attached is not None, "handshake never registered"
        assert attached.hello.get("pid") == __import__("os").getpid()
        assert listener.expected_indices() == []
        transport.send_bytes(ipc.encode_frame(ipc.READY,
                                              {"pid": 1, "rss_mb": 1}, 1))
        assert attached.poll(2.0)
        kind, _, seq = ipc.decode_frame(attached.recv_bytes())
        assert (kind, seq) == (ipc.READY, 1)
        transport.close()
    finally:
        listener.close()


@pytest.mark.parametrize("what", ["token", "index", "not_hello"])
def test_bad_hello_attaches_nothing(what):
    listener = T.WorkerListener("127.0.0.1", 0, handshake_timeout_s=5.0)
    try:
        listener.expect(0, pickle.dumps({"x": 1}))
        if what == "not_hello":
            s = socket.create_connection(("127.0.0.1", listener.port))
            ts = T.SocketTransport(s)
            ts.send_bytes(ipc.encode_frame(ipc.READY, {}, seq=0))
            assert ts.poll(5.0)
            with pytest.raises((EOFError, ConnectionResetError)):
                ts.recv_bytes()
        else:
            with pytest.raises(T.IPCError, match="handshake"):
                T.dial_parent("127.0.0.1", listener.port,
                              "wrong" if what == "token"
                              else listener.token,
                              0 if what == "token" else 7, timeout_s=5.0)
        deadline = time.perf_counter() + 2
        while listener.rejected < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert listener.rejected == 1
        assert listener.take(0) is None and listener.take(7) is None
        assert listener.expected_indices() == [0]
    finally:
        listener.close()


def test_silent_dialer_times_out_without_blocking_others():
    listener = T.WorkerListener("127.0.0.1", 0, handshake_timeout_s=0.3)
    try:
        listener.expect(0, pickle.dumps({"ok": True}))
        silent = socket.create_connection(("127.0.0.1", listener.port))
        transport, got = T.dial_parent("127.0.0.1", listener.port,
                                       listener.token, 0, timeout_s=10.0)
        assert got == {"ok": True}
        deadline = time.perf_counter() + 2
        while listener.rejected < 1 and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert listener.rejected == 1       # the silent one
        assert _take(listener, 0) is not None
        silent.close()
        transport.close()
    finally:
        listener.close()


def test_endpoints_and_cancel():
    assert T.parse_endpoint("10.0.0.1:77") == ("10.0.0.1", 77)
    assert T.parse_endpoint(":9") == ("0.0.0.0", 9)
    with pytest.raises(ValueError, match="HOST:PORT"):
        T.parse_endpoint("nope")
    listener = T.WorkerListener("127.0.0.1", 0)
    try:
        assert listener.dial_host == "127.0.0.1"
        assert listener.advertise_endpoint == listener.endpoint
        listener.expect(2, b"spec")
        listener.cancel(2)
        assert listener.expected_indices() == []
    finally:
        listener.close()


# -- the spec's weights -------------------------------------------------------


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
def test_host_model_round_trip(form):
    """A worker's spec carries the served model as host state
    (``host_model``): rebuilt on the worker's device it holds the same
    tensors, in the same dtypes, int8 weights and scales included; a
    facade's VAE stays behind."""
    import torch

    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.models import vae as TV
    from dalle_pytorch_tpu_torch.ops.quant import QuantLinear
    cfg = TD.DALLEConfig(dim=16, depth=2, num_text_tokens=50,
                         text_seq_len=8, heads=2, dim_head=8,
                         vae=TV.VAEConfig(image_size=16, num_tokens=32,
                                          codebook_dim=16, num_layers=2,
                                          hidden_dim=8))
    dtype = torch.bfloat16 if form == "bfloat16" else torch.float32
    model = TD.dalle_init(cfg, seed=3, device="cpu", dtype=dtype)
    if form == "int8":
        model = TD.quantize_for_decode(model)
    object.__setattr__(model, "vae", object())      # held, not shipped
    back = ipc.model_from_host(ipc.host_model(model), "cpu")
    assert back.cfg == model.cfg and back.vae is None
    assert isinstance(back.logits_proj, QuantLinear) == (form == "int8")
    want, got = model.state_dict(), back.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
