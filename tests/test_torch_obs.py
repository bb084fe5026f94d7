"""The port's observability, bring-up and admin-token check on the CPU,
against the JAX package's: the same calls into ``Trace``,
``FlightRecorder`` / ``RecordingMetrics``, ``Registry`` and ``Histogram``
give equal summaries, dumps, rendered text and percentiles;
``retry_with_backoff`` under a seeded jitter sleeps and records what
JAX's does; ``auth.check_http`` agrees on every header case. Through the
port's engine (the tiny model of ``tests/test_torch_engine_features.py``):
every request's trace rides its result and tiles its latency, the spans
and events land in the flight ring, a profile request is refused while
one is active and its torch.profiler trace is written; the server's
device claim retries an injected failure and surfaces a wedged one as a
``BringupError``."""

import json
import os
import random
import time

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.obs import flight as JFL
from dalle_pytorch_tpu.obs import registry as JREG
from dalle_pytorch_tpu.obs import trace as JTR
from dalle_pytorch_tpu.resilience import retry as JRETRY
from dalle_pytorch_tpu.serve import auth as JAUTH
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.obs import flight as FL
from dalle_pytorch_tpu_torch.obs import registry as REG
from dalle_pytorch_tpu_torch.obs import trace as TR
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience import retry as RETRY
from dalle_pytorch_tpu_torch.serve import auth as AUTH
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine, ProfileError
from dalle_pytorch_tpu_torch.serve.server import InferenceServer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_fault_plan():
    faults.deactivate()
    yield
    faults.deactivate()


# -- obs/trace.py ---------------------------------------------------------------

TRACE_CALLS = {
    "tiling": [("submit", 100.0, {}), ("queue_wait", 100.5, {}),
               ("prefill_admit", 100.75, {"bucket": 4, "mode": "cold"}),
               ("decode_chunk", 101.0, {"tokens": 4}),
               ("decode_chunk", 101.25, {"tokens": 4}),
               ("postprocess", 101.3, {"clip": True})],
    "evicted": [("submit", 0.0, {}), ("queue_wait", 0.1, {}),
                ("prefill_admit", 0.2, {"mode": "warm"}),
                ("decode_chunk", 0.4, {"tokens": 8}),
                ("evict", 0.45, {"pages_freed": 3}),
                ("prefill_admit", 0.9, {"mode": "cold"}),
                ("decode_chunk", 1.2, {"tokens": 8})],
    "backwards_clock": [("submit", 5.0, {}), ("queue_wait", 4.0, {})],
}


@pytest.mark.parametrize("case", sorted(TRACE_CALLS))
def test_trace_records_and_summary_match_jax(case):
    got = {}
    for name, mod in (("jax", JTR), ("port", TR)):
        tr = mod.Trace("tid", 7, t0=TRACE_CALLS[case][0][1])
        recs = [tr.span(n, t, **meta) for n, t, meta in TRACE_CALLS[case]]
        got[name] = (recs, tr.summary(), tr.has_in_attempt("queue_wait"),
                     tr.has_in_attempt("replayed_from"))
    assert got["port"] == got["jax"]
    if case == "tiling":
        assert got["port"][1]["span_total_s"] == pytest.approx(1.3)


def test_trace_ids_and_attach_like_jax():
    for rid in (0, 7, 2 ** 40 + 5):
        a, b = TR.new_trace_id(rid), JTR.new_trace_id(rid)
        assert a.split("-")[0] == b.split("-")[0] and len(a) == len(b)
    h = S.RequestHandle(S.Request(codes=(1,)))
    tr = TR.attach(h, 3, 1.0)
    assert h.trace is tr and tr.request_id == 3 and tr.attempt == 0
    assert TR.SPAN_KEYS == JTR.SPAN_KEYS


# -- obs/flight.py ----------------------------------------------------------------

def test_flight_recorder_matches_jax():
    got = {}
    for name, mod in (("jax", JFL), ("port", FL)):
        fl = mod.FlightRecorder(capacity=4)
        rec = {"i": -1}
        fl.record(rec)
        rec["i"] = 99                   # the ring kept its own copy
        for i in range(9):
            fl.record({"i": i, "kind": "k"})
        got[name] = (len(fl), fl.dump())
        with pytest.raises(ValueError):
            mod.FlightRecorder(capacity=0)
    assert got["port"] == got["jax"]
    assert [r["i"] for r in got["port"][1]] == [5, 6, 7, 8]


class Sink:
    def __init__(self):
        self.calls = []

    def event(self, **f):
        self.calls.append(("event", f))

    def resilience(self, kind, **f):
        self.calls.append(("resilience", kind, f))

    def step(self, *a, **kw):
        self.calls.append(("step", a, kw))


def test_recording_metrics_tee_and_wrap_match_jax():
    got = {}
    for name, mod in (("jax", JFL), ("port", FL)):
        sink = Sink()
        m = mod.wrap_metrics(mod.FlightRecorder(8), sink)
        m.event(event="resilience", kind="x", a=1)
        m.resilience("bringup_retry", attempt=2)
        m.step(3, 0.5)
        alone = mod.RecordingMetrics(mod.FlightRecorder(4), None)
        alone.event(kind="y")
        alone.step(1)
        outer = mod.wrap_metrics(mod.FlightRecorder(4), m)
        assert outer.inner is sink      # never two rings chained
        got[name] = ([{k: v for k, v in r.items() if k != "time"}
                      for r in m.flight.dump()], sink.calls,
                     alone.flight.dump())
    assert got["port"] == got["jax"]


# -- obs/registry.py ----------------------------------------------------------------

def registry_page(mod):
    reg = mod.Registry()
    lh = reg.histogram("x_seconds", "help text", buckets=(0.1, 1.0))
    lh2 = reg.histogram("y_ms", "other", buckets=(0.5, 5.0, 50.0),
                        window=3)
    for i, v in enumerate((0.05, 0.5, 5.0, 0.1, 1.0, 0.02)):
        lh.observe(v, weights_version=f"v{i % 2}")
        lh2.observe(v * 10)
    text = reg.render(
        counters=[("c_total", "a counter",
                   [({"k": 'we"ird\nvalue\\x'}, 3), (None, None)])],
        gauges=[("g", "a gauge", [(None, 1.5), ({"b": True}, True)]),
                ("inf", "an inf", [(None, float("inf"))]),
                ("empty", "dropped", [])])
    return (text, lh.percentiles((0.5, 0.9, 0.99)), lh.percentiles_ms(),
            lh2.percentiles((0.5,)), lh2.percentiles_ms())


def test_registry_renders_and_percentiles_match_jax():
    assert registry_page(REG) == registry_page(JREG)
    text = registry_page(REG)[0]
    assert 'x_seconds_bucket{le="+Inf",weights_version="v1"} 3' in text
    assert "empty" not in text and text.endswith("\n")


@pytest.mark.parametrize("values", [[], [0.05, 0.5, 5.0],
                                    list(np.linspace(0, 2, 101))])
def test_histogram_matches_jax(values):
    got = {}
    for name, mod in (("jax", JREG), ("port", REG)):
        h = mod.Histogram(buckets=(0.1, 1.0), window=50)
        for v in values:
            h.observe(v)
        got[name] = (h.snapshot(), h.window(),
                     [h.percentile(q) for q in (0.0, 0.5, 0.95, 0.99, 1)])
    assert got["port"] == got["jax"]
    with pytest.raises(ValueError):
        REG.Registry().histogram("9bad-name", "x")


# -- resilience/retry.py --------------------------------------------------------------

def retry_run(mod, fail_first: int, attempts: int, jitter: float):
    sleeps, events, calls = [], [], []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < fail_first:
            raise RuntimeError(f"fail {attempt}")
        return "ok"

    policy = mod.RetryPolicy(max_attempts=attempts, deadline_s=5.0,
                             base_backoff_s=0.5, backoff_multiplier=3.0,
                             max_backoff_s=2.0, jitter=jitter)
    try:
        out = mod.retry_with_backoff(flaky, policy, label="claim",
                                     on_event=events.append,
                                     rng=random.Random(4),
                                     sleep=sleeps.append)
    except mod.BringupError as e:
        out = ("BringupError", str(e),
               {k: v for k, v in e.record.items()
                if k not in ("time", "elapsed_s")})
    return (out, calls, sleeps,
            [{k: v for k, v in e.items() if k not in ("time", "elapsed_s")}
             for e in events])


@pytest.mark.parametrize("fail_first,attempts,jitter",
                         [(0, 3, 0.25), (2, 3, 0.25), (5, 4, 0.25),
                          (3, 3, 0.0)])
def test_retry_with_backoff_matches_jax(fail_first, attempts, jitter):
    assert retry_run(RETRY, fail_first, attempts, jitter) == \
        retry_run(JRETRY, fail_first, attempts, jitter)


def test_deadline_fires_instead_of_hanging():
    assert RETRY.call_with_deadline(lambda: 42, 5.0) == 42
    t0 = time.monotonic()
    with pytest.raises(RETRY.DeadlineExceeded):
        RETRY.call_with_deadline(lambda: time.sleep(30), 0.15, "wedged")
    assert time.monotonic() - t0 < 5.0


# -- serve/auth.py ------------------------------------------------------------------

AUTH_CASES = [({}, "tok"), ({"Authorization": "Bearer tok"}, "tok"),
              ({"Authorization": "Bearer nope"}, "tok"),
              ({"X-Admin-Token": "tok"}, "tok"),
              ({"Authorization": "Basic tok", "X-Admin-Token": "tok"}, "tok"),
              ({"Authorization": "Bearer "}, ""), ({"X-Admin-Token": ""}, ""),
              ({"X-API-Key": "tok"}, "tok")]


@pytest.mark.parametrize("i", range(len(AUTH_CASES)))
def test_check_http_matches_jax(i):
    headers, expected = AUTH_CASES[i]
    assert AUTH.check_http(headers, expected) == \
        JAUTH.check_http(headers, expected)
    assert AUTH.check_http(headers, expected, "X-API-Key") == \
        JAUTH.check_http(headers, expected, "X-API-Key")
    assert AUTH.check_token(["tok"], "tok") is False


# -- through the engine ----------------------------------------------------------------

JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
REQS = [S.Request(codes=(3, 7, 9), seed=11),
        S.Request(codes=(5, 2, 8, 1, 4), seed=23),
        S.Request(codes=(6, 6), seed=5)]


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return (from_jax.dalle_from_jax(dal_p, TCFG, device="cpu"),
            from_jax.vae_from_jax(vae_p, TVCFG, device="cpu"))


def engine(bundle, **kw):
    q = S.RequestQueue(max_depth=8)
    return Engine(bundle[0], q, num_slots=2, chunk_steps=4, device="cpu",
                  **kw), q


def test_traces_ride_results_and_tile_their_latency(bundle):
    eng, q = engine(bundle, kv="paged", page_size=4, num_pages=9)
    handles = [q.submit(r) for r in REQS]
    eng.run_until_idle()
    assert eng.evicted >= 1
    for h in handles:
        res = h.result(timeout=5)
        tr = res.trace
        assert res.ok and tr is not None and tr["attempts"] == 1
        names = [s["name"] for s in tr["spans"]]
        assert names[:3] == ["submit", "queue_wait", "prefill_admit"]
        assert "decode_chunk" in names
        # one clock, one process: the spans sum to the latency
        assert tr["span_total_s"] == pytest.approx(res.total_s, abs=2e-5)
    assert any("evict" in [s["name"] for s in h.result().trace["spans"]]
               for h in handles)
    kinds = {r.get("span") or r.get("kind") for r in eng.flight.dump()}
    assert {"queue_wait", "prefill_admit", "decode_chunk",
            "serve_evict"} <= kinds
    assert eng.stats()["flight_events"] == len(eng.flight)


def test_engine_events_reach_the_ring_and_the_sink(bundle):
    sink = Sink()
    eng, q = engine(bundle, metrics=sink, log_every=4)
    h = q.submit(S.Request(codes=(3,), seed=1, deadline_s=0.0))
    eng.run_until_idle()
    assert h.result(0).status == S.DEADLINE_EXCEEDED
    q.submit(REQS[0])
    eng.run_until_idle()
    ring = [r.get("kind") or r.get("event") for r in eng.flight.dump()]
    assert "serve_deadline" in ring and "serve" in ring
    forwarded = [f.get("kind") or f.get("event") for _, f in sink.calls]
    assert "serve_deadline" in forwarded and "serve" in forwarded


def test_profile_refused_while_active_and_written(bundle, tmp_path):
    eng, q = engine(bundle)
    rec = eng.request_profile(str(tmp_path / "prof"), chunks=2)
    assert rec["kind"] == "serve_profile_armed" and eng.profile_active()
    with pytest.raises(ProfileError) as ei:
        eng.request_profile(str(tmp_path / "other"), chunks=1)
    assert ei.value.record["reason"] == "capture_active"
    with pytest.raises(ValueError, match="chunks"):
        eng.request_profile(str(tmp_path / "x"), chunks=0)
    q.submit(REQS[0])
    eng.run_until_idle()
    assert not eng.profile_active() and eng.profiles_taken == 1
    done = [r for r in eng.flight.dump()
            if r.get("kind") == "serve_profile_done"]
    assert len(done) == 1 and done[0]["chunks"] == 2
    with open(done[0]["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert os.path.dirname(done[0]["trace"]) == str(tmp_path / "prof")
    eng.request_profile(str(tmp_path / "prof2"), chunks=1)   # re-armable


def test_device_claim_retries_and_surfaces_a_wedge(bundle, monkeypatch):
    """``start()`` claims the device under ``retry_with_backoff``: an
    injected failure of the first attempt is retried (one
    ``bringup_retry`` record) and serving starts; a claim that hangs past
    its deadline ends in a ``BringupError``."""
    model, vae = bundle
    monkeypatch.setattr(RETRY.RetryPolicy, "backoff",
                        lambda self, attempt, rng=None: 0.0)
    sink = Sink()
    srv = InferenceServer(model, vae, decode_images=False, device="cpu",
                          metrics=sink, init_retries=3)
    with faults.injected(backend_init_fail_attempts=1):
        srv.start()
    try:
        assert [c[1] for c in sink.calls if c[0] == "resilience"] == \
            ["bringup_retry"]
        assert srv.health()["ok"]
        assert srv.generate([3, 7, 9], seed=11, timeout=30).ok
    finally:
        srv.close()
    wedged = InferenceServer(model, vae, decode_images=False, device="cpu",
                             init_retries=1, init_deadline_s=0.2)
    with faults.injected(backend_init_hang_s=2.0):
        with pytest.raises(RETRY.BringupError) as ei:
            wedged.start()
    assert ei.value.record["label"] == "serve_backend_init"
    assert "DeadlineExceeded" in ei.value.record["errors"][0]
    wedged.close()
