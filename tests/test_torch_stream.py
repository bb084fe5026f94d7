"""The port's token streams on the CPU, against the JAX package's.

The channel (``serve/stream.py``): the cases of ``tests/test_stream.py``
run against the port's ``TokenSink`` and the JAX one with the same
pushes, and the events come out equal (order and tags, replay
de-duplication by position, the drop policy for a consumer that reads
nothing, a terminal event that is never dropped, a group's channel that
ends once every member closed, heartbeats, SSE framing, ``pack_image``
bit-exact), besides each case's own checks.

The engine's side, with the tiny model of
``tests/test_torch_engine_features.py``: a streamed request's token
events concatenate to its result's tokens, equal to the JAX engine's; a
torn connection cancels the request, the engine reaps the slot and every
page returns to the free list, as in JAX; the previews come at the JAX
engine's prefixes and the final frame is the result's image, bit for
bit."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import postprocess as JP
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve import stream as JST
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import stream as ST
from dalle_pytorch_tpu_torch.serve.engine import Engine
from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor

PKGS = {"jax": (JS, JST), "port": (S, ST)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the channel: each case returns what it observed -----------------------------

def ok(S_, rid=0, **kw):
    return S_.Result(status=S_.OK, request_id=rid, **kw)


def case_order(S_, st):
    sink = st.TokenSink(request_id=9)
    sink.push_tokens(0, [1, 2])
    sink.push_tokens(2, [3])
    sink.close(ok(S_, 9, tokens=np.asarray([1, 2, 3])))
    evs = list(sink.events())
    assert [e["event"] for e in evs] == ["tokens", "tokens", "sample_done"]
    assert evs[-1]["n_tokens"] == 3 and sink.done
    return evs


def case_replay(S_, st):
    sink = st.TokenSink()
    sink.push_tokens(0, [1, 2, 3])
    sink.push_tokens(0, [1, 2, 3])          # a full replay
    sink.push_tokens(1, [2, 3, 4, 5])       # overlapping: 4, 5 are new
    sink.push_tokens(3, [4, 5])             # already delivered
    got = []
    while (ev := sink.get(timeout=0)) is not None:
        got.append(ev)
    assert [(e["pos"], e["tokens"]) for e in got] == [(0, [1, 2, 3]),
                                                     (3, [4, 5])]
    return got


def case_push_after_close(S_, st):
    sink = st.TokenSink()
    sink.close(ok(S_))
    sink.push_tokens(0, [1])
    return list(sink.events())


def case_first_close_wins(S_, st):
    sink = st.TokenSink()
    sink.close(ok(S_))
    sink.close(S_.Result(status=S_.ERROR, request_id=0, reason="late"))
    evs = list(sink.events())
    assert len(evs) == 1 and sink.result.status == S_.OK
    return evs


def case_overflow(S_, st):
    """A consumer that reads nothing: pushes past the ring shed the
    oldest and never block; the next read is an overflow event."""
    sink = st.TokenSink(max_events=4)
    t0 = time.perf_counter()
    for i in range(20):
        sink.push_tokens(i, [i])
    assert time.perf_counter() - t0 < 0.5
    sink.close(ok(S_))
    evs = list(sink.events())
    assert evs[0]["event"] == "overflow" and evs[0]["dropped"] == 17
    assert [e["pos"] for e in evs if e["event"] == "tokens"] == [17, 18, 19]
    return evs


def case_terminal_kept(S_, st):
    sink = st.TokenSink(max_events=4)
    for i in range(10):
        sink.push_tokens(i, [i])
    sink.close(ok(S_))
    for i in range(10, 20):
        sink.push_tokens(i, [i])
    evs = list(sink.events())
    assert [e["event"] for e in evs].count("sample_done") == 1
    return evs


def case_group(S_, st):
    sinks = st.TokenSink.group(3)
    sinks[1].push_tokens(0, [7])
    sinks[0].close(ok(S_, 0))
    sinks[2].close(ok(S_, 2))
    assert not sinks[0].done
    sinks[1].close(S_.Result(status=S_.ERROR, request_id=1, reason="boom"))
    evs = list(sinks[0].events())
    assert all(s.done for s in sinks)
    return evs


def case_heartbeat(S_, st):
    sink = st.TokenSink()
    t = threading.Thread(target=lambda: (time.sleep(0.12),
                                         sink.close(ok(S_))))
    t.start()
    kinds = [e["event"] for e in sink.events(heartbeat_s=0.03)]
    t.join()
    assert "heartbeat" in kinds and kinds[-1] == "sample_done"
    # heartbeats depend on the clock: compare the rest
    return [k for k in kinds if k != "heartbeat"]


def case_min_ring(S_, st):
    with pytest.raises(ValueError, match="max_events") as ei:
        st.TokenSink(max_events=2)
    return str(ei.value)


def case_sse(S_, st):
    return [st.sse_bytes({"event": "tokens", "pos": 3, "tokens": [1]}),
            st.sse_bytes({"event": "result", "status": "ok",
                          "tokens": [1, 2], "trace": {"a": 0.5}})]


def case_pack(S_, st):
    rng = np.random.default_rng(0)
    out = []
    for dtype in (np.float32, np.uint8):
        img = rng.standard_normal((4, 4, 3)).astype(dtype)
        packed = st.pack_image(img)
        back = st.unpack_image(packed)
        assert back.dtype == img.dtype and back.shape == img.shape
        np.testing.assert_array_equal(back, img)
        out.append(packed)
    return out


CASES = {f.__name__[5:]: f for f in (
    case_order, case_replay, case_push_after_close, case_first_close_wins,
    case_overflow, case_terminal_kept, case_group,
    case_heartbeat, case_min_ring, case_sse, case_pack)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sink_events_match_jax(name):
    got = {pkg: CASES[name](*mods) for pkg, mods in PKGS.items()}
    assert got["port"] == got["jax"]


def test_sink_never_blocks_the_engine_and_counts_drops():
    sink = ST.TokenSink(max_events=4)
    for i in range(100):
        sink.push_tokens(i, [i])
    assert sink.dropped == 96 and not sink.closed


# -- the engine's side ---------------------------------------------------------

JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return (dal_p, vae_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu"),
            from_jax.vae_from_jax(vae_p, TVCFG, device="cpu"))


def engine(pkg, bundle, **kw):
    if pkg == "jax":
        q = JS.RequestQueue(max_depth=16)
        return JEngine(bundle[0], JCFG, q, num_slots=2, chunk_steps=4,
                       **kw), q
    q = S.RequestQueue(max_depth=16)
    return Engine(bundle[2], q, num_slots=2, chunk_steps=4, device="cpu",
                  **kw), q


def events_by_kind(sink, kind):
    return [e for e in sink.events() if e["event"] == kind]


def test_streamed_tokens_are_the_result_and_match_jax(bundle):
    got = {}
    for pkg, (S_, st) in PKGS.items():
        eng, q = engine(pkg, bundle)
        sink = st.TokenSink()
        h = q.submit(S_.Request(codes=(3, 7, 9), seed=11, stream=True),
                     sink=sink)
        plain = q.submit(S_.Request(codes=(3, 7, 9), seed=11))
        eng.run_until_idle()
        res = h.result(timeout=30)
        assert res.status == S_.OK and sink.result is res
        toks = [t for e in events_by_kind(sink, "tokens")
                for t in e["tokens"]]
        np.testing.assert_array_equal(toks[-len(res.tokens):], res.tokens)
        np.testing.assert_array_equal(plain.result(timeout=30).tokens,
                                      res.tokens)
        got[pkg] = toks
    assert got["port"] == got["jax"]


def test_torn_connection_reaps_the_slot_like_jax(bundle):
    """The SSE writer's disconnect path: fulfilled ``cancelled``
    mid-stream, the slot reaped at the next step, every page back."""
    got = {}
    for pkg, (S_, st) in PKGS.items():
        eng, q = engine(pkg, bundle, kv="paged", page_size=8)
        sink = st.TokenSink()
        h = q.submit(S_.Request(codes=(3, 7, 9), seed=11, stream=True),
                     sink=sink)
        deadline = time.perf_counter() + 30
        first = None
        while first is None:
            eng.step_once()
            first = sink.get(timeout=0)
            assert time.perf_counter() < deadline
        assert eng.alloc.in_use > 0
        h.fulfill(S_.Result(status=S_.CANCELLED,
                            request_id=h.request.request_id,
                            reason="client disconnected mid-stream"))
        eng.run_until_idle()
        assert eng.reaped >= 1 and eng.alloc.in_use == 0
        assert sink.closed and sink.result.status == S_.CANCELLED
        assert list(sink.events())[-1]["event"] == "sample_done"
        reaped = [e for e in eng.flight.dump()
                  if e.get("kind") == "serve_slot_reaped"]
        got[pkg] = (first, eng.reaped, eng.tokens_decoded,
                    [(e["request_id"], e["tokens_done"]) for e in reaped])
    assert got["port"] == got["jax"]


def test_previews_match_jax_and_end_in_the_result_image(bundle):
    """Previews every chunk: frames at the JAX engine's prefixes with its
    pixels (to 1e-5), and the final frame is the result's image."""
    dal_p, vae_p, model, vae = bundle
    got = {}
    for pkg, (S_, st) in PKGS.items():
        post = (JP.PostProcessor(dal_p, vae_p, JCFG) if pkg == "jax"
                else PostProcessor(vae, model)).start()
        eng, q = engine(pkg, bundle, preview_every=1,
                        complete=post.submit)
        eng.on_preview = post.submit_preview
        sink = st.TokenSink()
        h = q.submit(S_.Request(codes=(5, 2, 8, 1, 4), seed=23,
                                stream=True), sink=sink)
        eng.run_until_idle()
        res = h.result(timeout=30)
        post.close()
        frames = events_by_kind(sink, "preview")
        assert [f["final"] for f in frames] == \
            [False] * (len(frames) - 1) + [True]
        last = st.unpack_image(frames[-1]["image"])
        np.testing.assert_array_equal(last, np.asarray(res.image))
        assert post.preview_frames == len(frames) and \
            post.preview_drops == 0
        got[pkg] = ([f["tokens_done"] for f in frames],
                    [st.unpack_image(f["image"]) for f in frames],
                    eng.previews_requested)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][2] == got["jax"][2] == len(got["port"][0]) - 1
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
