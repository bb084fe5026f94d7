"""The port's HTTP server on the CPU, against the JAX server: the same
requests over HTTP on 127.0.0.1 to the JAX ``InferenceServer`` and the
port's, both paged (page 8) through the kernel read (K4's plain version
in the port, the interpreted Pallas kernel in JAX) with the prefix cache,
previews and a CLIP scoring every image.

Held equal: the tokens of plain, guided, best-of-2, short-grid and
streamed requests (CLIP scores to 1e-5); every ``_result_body`` apart
from its timings; the status codes and bodies of 400 (empty or over-long
prompt, a bad body), 429 (queue full), 503 (after ``close``), 404, 401
and 409 (``/admin/scale``), the bodies' ``time`` left out; ``/metrics``'
families and HELP lines, the e2e histogram's ``_count`` the delivered
requests; ``/stats``' keys; ``/healthz`` 200, then 503 once the engine
thread has died; ``close()`` cancelling queued and in-slot requests;
the queue's reject records. The fleet keywords raise ``TypeError``.

Tiny model (``tests/test_torch_engine_features.py``'s: dim 32, depth 2,
text 8 + image 16 tokens, VAE 16 px, CLIP of one layer); each server
runs once a module."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve import server as JSRV
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import server as SRV
from dalle_pytorch_tpu_torch.serve import stream as ST


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
CLIP_KW = dict(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=64,
               text_seq_len=8, text_enc_depth=1, visual_enc_depth=1,
               text_heads=2, visual_heads=2, visual_image_size=16,
               visual_patch_size=8, sparse_attn=False)
SERVER_KW = dict(num_slots=4, chunk_steps=2, queue_depth=16, kv="paged",
                 page_size=8, paged_attn="kernel", prefix_cache=True,
                 preview_every=2, weights_version="w1", admin_token="tok")

# (name, POST /generate body), sent in this order
REQUESTS = [
    ("plain", {"codes": [3, 7, 9], "seed": 11}),
    ("guided", {"codes": [5, 2, 8, 1, 4], "seed": 23, "cfg_scale": 3.0,
                "temperature": 0.7}),
    ("group", {"codes": [3, 7, 9], "seed": 11, "n_samples": 2}),
    ("full", {"codes": [6, 6], "seed": 5, "top_p": 0.9}),
    ("short", {"codes": [6, 6], "seed": 5, "top_p": 0.9,
               "image_seq_len_override": 4}),
    ("stream", {"codes": [3, 7, 9], "seed": 11, "stream": True}),
]
# (name, method, path, body or raw bytes, token)
ERRORS = [
    ("empty", "POST", "/generate", {"codes": []}, None),
    ("over_long", "POST", "/generate", {"codes": list(range(1, 10))}, None),
    ("bad_body", "POST", "/generate", b"{not json", None),
    ("get_404", "GET", "/nope", None, None),
    ("post_404", "POST", "/nope", {}, None),
    ("scale_401", "POST", "/admin/scale", {"op": "status"}, None),
    ("scale_409", "POST", "/admin/scale", {"op": "add"}, "tok"),
    ("scale_400", "POST", "/admin/scale", {"replica": 1}, "tok"),
    ("profile_401", "POST", "/admin/profile", {}, None),
    ("profile_no_dir", "POST", "/admin/profile", {}, "tok"),
]
# the keywords of process isolation and its transport (ROADMAP.md queue
# 1 item 2b) and of a device mesh (item 3c)
FLEET_KW = {"mesh_devices": 2,
            "isolation": "process", "child_rss_limit_mb": 100,
            "transport": "socket", "worker_endpoint": "127.0.0.1:1",
            "worker_cmd": "", "worker_ckpt": "x", "worker_use_ema": True,
            "worker_quantize": "int8", "attach_token": "t"}
# the replica-set keywords the port takes, as JAX's server does
SET_KW = {"replicas": 2, "replica_roles": ("prefill", "decode"),
          "max_replicas": 2, "autoscale": "policy",
          "load_weights": print, "heartbeat_s": 1.0}
# the timing fields of a result body
TIMES = ("queued_s", "decode_s", "total_s")
# stats() keys of the JAX single engine the port has no counterpart of:
# its compile counters (the port traces nothing), the pages-in-use p95
# and page-deferral count of its paged admission
JAX_ONLY_STATS = {"decode_compiles", "prefill_compiles",
                  "pages_in_use_p95", "deferred"}
# /metrics: both servers register the replica set's migration histogram
# on a single engine too (headers only), so no family is JAX's alone;
# two HELP texts name the port's own mechanism (torch.profiler, the emit
# ring's host read)
JAX_ONLY_FAMILIES = set()
OWN_HELP = {"dalle_serve_profile_active", "dalle_serve_harvests_total"}


@pytest.fixture(scope="module")
def weights():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    clip_p = jax.device_get(JC.clip_init(jax.random.PRNGKey(7),
                                         JC.CLIPConfig(**CLIP_KW)))
    port = (from_jax.dalle_from_jax(dal_p, TCFG, device="cpu"),
            from_jax.vae_from_jax(vae_p, TVCFG, device="cpu"),
            from_jax.clip_from_jax(clip_p, TC.CLIPConfig(**CLIP_KW),
                                   device="cpu"))
    return (dal_p, vae_p, clip_p), port


def jax_server(weights, **kw):
    dal_p, vae_p, clip_p = weights[0]
    return JSRV.InferenceServer(dal_p, vae_p, JCFG, clip_params=clip_p,
                                clip_cfg=JC.CLIPConfig(**CLIP_KW), **kw)


def port_server(weights, **kw):
    model, vae, clip = weights[1]
    return SRV.InferenceServer(model, vae, clip=clip, device="cpu", **kw)


# -- HTTP -------------------------------------------------------------------

class Http:
    """An HTTP front end over ``srv`` on an ephemeral port."""

    def __init__(self, mod, srv):
        self.httpd = mod.make_http_server(srv, "127.0.0.1", 0)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def call(self, method, path, body=None, token=None):
        """(status, raw bytes, content type)."""
        data = None
        if body is not None:
            data = body if isinstance(body, bytes) else \
                json.dumps(body).encode()
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=data,
            method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read(), r.headers.get("Content-Type")
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers.get("Content-Type")

    def json(self, method, path, body=None, token=None):
        code, raw, _ = self.call(method, path, body, token)
        return code, json.loads(raw)


def sse_events(raw: bytes) -> list:
    """The events of an SSE body, each as {"event": kind, **payload}."""
    out = []
    for frame in raw.decode().split("\n\n"):
        if not frame.strip():
            continue
        lines = dict(line.split(": ", 1) for line in frame.split("\n"))
        out.append({"event": lines["event"], **json.loads(lines["data"])})
    return out


def drive(mod, srv) -> dict:
    """Every request, error case and read of the module over HTTP."""
    http = Http(mod, srv)
    out = {}
    try:
        for name, body in REQUESTS:
            code, raw, ctype = http.call("POST", "/generate", body)
            out[name] = (code, sse_events(raw) if body.get("stream")
                         else json.loads(raw), ctype)
        for name, method, path, body, token in ERRORS:
            out[name] = http.json(method, path, body, token)
        out["stats"] = http.json("GET", "/stats")[1]
        out["metrics"] = http.call("GET", "/metrics")
        out["healthz"] = http.json("GET", "/healthz")
        out["debug"] = http.json("GET", "/debug/events")
    finally:
        http.close()
        srv.close()
    return out


@pytest.fixture(scope="module")
def runs(weights):
    return {"jax": drive(JSRV, jax_server(weights, **SERVER_KW).start()),
            "port": drive(SRV, port_server(weights, **SERVER_KW).start())}


def strip_times(body):
    """A result body without its timings: the time fields, and in the
    trace the ids and seconds (span names and counts kept)."""
    body = {k: v for k, v in body.items() if k not in TIMES}
    if "trace" in body:
        tr = body["trace"]
        body["trace"] = {
            "request_id": tr["request_id"], "attempts": tr["attempts"],
            "replays": tr["replays"],
            "spans": [(s["name"], s["n"]) for s in tr["spans"]]}
    if "clip_score" in body:
        body["clip_score"] = pytest.approx(body["clip_score"], rel=1e-5,
                                           abs=1e-5)
    if "samples" in body:
        body["samples"] = [strip_times(b) for b in body["samples"]]
    return body


def no_time(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "time"}


# -- results ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "guided", "group", "full",
                                  "short"])
def test_result_bodies_match_jax(runs, name):
    jcode, jbody, _ = runs["jax"][name]
    code, body, ctype = runs["port"][name]
    assert code == jcode == 200 and ctype == "application/json"
    assert body["status"] == "ok" and body["weights_version"] == "w1"
    assert body["image_shape"] == [16, 16, 3]
    assert strip_times(body) == strip_times(jbody)
    # a group's traces are its members'
    for b in body.get("samples") or [body]:
        assert "prefill_admit" in [s["name"] for s in b["trace"]["spans"]]


def test_group_short_grid_and_stream_tokens(runs):
    """Sample 0 of the group is the plain request (its seed is the
    user's); the samples are ranked by CLIP score; the short grid is the
    causal prefix of the full grid; the stream's token events cover each
    position once and end in the plain request's tokens."""
    port = runs["port"]
    plain = port["plain"][1]
    group = port["group"][1]
    scores = [s["clip_score"] for s in group["samples"]]
    assert scores == sorted(scores, reverse=True)
    assert plain["tokens"] in [s["tokens"] for s in group["samples"]]
    best = group["samples"][0]
    assert group["tokens"] == best["tokens"]
    assert group["clip_score"] == best["clip_score"]
    assert port["short"][1]["tokens"] == port["full"][1]["tokens"][:4]
    events = port["stream"][1]
    covered = []
    for ev in events:
        if ev["event"] == "tokens":
            assert ev["pos"] == len(covered) + 3
            covered += ev["tokens"]
    assert covered[-TCFG.image_seq_len:] == plain["tokens"]
    assert events[-1]["event"] == "result"


def test_stream_events_match_jax(runs):
    """The same SSE events in the same order: token events equal, the
    preview frames at the same prefixes (pixels to 1e-5), one
    ``sample_done`` and the result frame last."""
    jev = runs["jax"]["stream"][1]
    ev = runs["port"]["stream"][1]
    assert runs["port"]["stream"][2] == runs["jax"]["stream"][2] \
        == "text/event-stream"

    def tokens(evs):
        return [e for e in evs if e["event"] == "tokens"]

    assert tokens(ev) == tokens(jev)
    frames = [e for e in ev if e["event"] == "preview"]
    jframes = [e for e in jev if e["event"] == "preview"]
    assert frames[-1]["final"] and jframes[-1]["final"]
    np.testing.assert_allclose(ST.unpack_image(frames[-1]["image"]),
                               ST.unpack_image(jframes[-1]["image"]),
                               rtol=1e-5, atol=1e-5)
    done = [e for e in ev if e["event"] == "sample_done"]
    jdone = [e for e in jev if e["event"] == "sample_done"]
    assert len(done) == 1 and done[0].keys() == jdone[0].keys()
    assert done[0]["n_tokens"] == jdone[0]["n_tokens"] == 16
    assert strip_times({k: v for k, v in ev[-1].items() if k != "event"}) \
        == strip_times({k: v for k, v in jev[-1].items() if k != "event"})


# -- error answers ------------------------------------------------------------

@pytest.mark.parametrize("name", [e[0] for e in ERRORS])
def test_error_codes_and_bodies_match_jax(runs, name):
    jcode, jbody = runs["jax"][name]
    code, body = runs["port"][name]
    assert code == jcode and code in (400, 401, 404, 409)
    assert no_time(body) == no_time(jbody)


def test_queue_full_and_closed_answer_like_jax(weights):
    """An unstarted server with a queue of one: the second submit is 429
    with the queue's record, and after close() the queued request is
    cancelled and a submit is 503."""
    got = {}
    for name, mod, make in (("jax", JSRV, jax_server),
                            ("port", SRV, port_server)):
        srv = make(weights, queue_depth=1, decode_images=False)
        http = Http(mod, srv)
        try:
            first = srv.submit([1, 2], seed=0)
            full = http.json("POST", "/generate", {"codes": [1, 2]})
            srv.close()
            closed = http.json("POST", "/generate", {"codes": [1, 2]})
            res = first.result(timeout=10)
        finally:
            http.close()
        got[name] = (full[0], no_time(full[1]), closed[0],
                     no_time(closed[1]), res.status, res.reason)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 429 and got["port"][2] == 503
    assert got["port"][1]["reason"] == "queue_full"
    assert got["port"][3]["reason"] == "queue_closed"
    assert got["port"][4] == S.CANCELLED


# -- the read-only routes -----------------------------------------------------

def help_lines(text: str) -> dict:
    return dict(line[len("# HELP "):].split(" ", 1)
                for line in text.splitlines() if line.startswith("# HELP "))


def test_metrics_match_jax(runs):
    jcode, jraw, jctype = runs["jax"]["metrics"]
    code, raw, ctype = runs["port"]["metrics"]
    assert code == jcode == 200 and ctype == jctype
    port, jax_ = help_lines(raw.decode()), help_lines(jraw.decode())
    assert set(port) == set(jax_) - JAX_ONLY_FAMILIES
    for name, text in port.items():
        if name not in OWN_HELP:
            assert text == jax_[name], name
    # the e2e histogram counts every delivered request: six requests, the
    # group's two members each
    for r in (raw, jraw):
        count = [ln for ln in r.decode().splitlines()
                 if ln.startswith("dalle_serve_e2e_latency_seconds_count")]
        assert count and int(count[0].split()[-1]) == len(REQUESTS) + 1


def test_stats_match_jax(runs):
    st, jst = runs["port"]["stats"], runs["jax"]["stats"]
    assert set(st) == set(jst) - JAX_ONLY_STATS
    for key in ("requests_submitted", "completed", "tokens_decoded",
                "prefix_hits", "cfg_pairs", "reaped", "rejected",
                "expired", "evicted", "groups_completed",
                "fanout_pages_saved", "streams_active", "groups_in_flight",
                "pages_free", "kv_hbm_bytes", "prefill_buckets"):
        assert st[key] == jst[key], key
    assert st["groups_completed"] == 1 and st["streams_active"] == 0
    assert st["rejected"] == 1          # the over-long prompt
    assert set(st["latency_ms"]["e2e"]) == {"p50", "p95", "p99"}
    assert st["p50_latency_s"] > 0 and st["preview_frames"] >= 1


def test_healthz_and_debug_events_match_jax(runs):
    assert runs["port"]["healthz"] == runs["jax"]["healthz"] \
        == (200, {"ok": True, "devices_per_replica": 1, "mesh_shape": None})
    code, body = runs["port"]["debug"]
    assert code == 200 and set(body) == {"server", "replicas", "fenced"}
    kinds = {e.get("kind") or e.get("span") for e in body["server"]}
    jkinds = {e.get("kind") or e.get("span")
              for e in runs["jax"]["debug"][1]["server"]}
    assert "serve_reject" in kinds and "serve_reject" in jkinds
    assert "decode_chunk" in kinds


# -- failures and shutdown ----------------------------------------------------

class EngineDeath(BaseException):
    """Not an ``Exception``: the run loop does not catch it."""


def inject(engine, exc):
    """The engine's next step with a slot live raises ``exc`` once."""
    step = engine.step_once
    fired = []

    def faulty():
        if not fired and engine.active_slots() > 0:
            fired.append(True)
            raise exc
        return step()

    engine.step_once = faulty
    return fired


def test_engine_failure_results_and_healthz_match_jax(weights):
    """A step that raises fails the in-slot request with a typed error
    and serving goes on (200); an engine thread that dies turns /healthz
    503."""
    got = {}
    for name, mod, make in (("jax", JSRV, jax_server),
                            ("port", SRV, port_server)):
        srv = make(weights, num_slots=2, chunk_steps=2,
                   decode_images=False).start()
        http = Http(mod, srv)
        try:
            inject(srv.engine, RuntimeError("injected"))
            bad = http.json("POST", "/generate", {"codes": [3, 7, 9]})
            alive = http.json("GET", "/healthz")
            good = http.json("POST", "/generate",
                             {"codes": [3, 7, 9], "seed": 11})
            fired = inject(srv.engine, EngineDeath())
            srv.submit([1, 2])
            srv._thread.join(30)
            dead = http.json("GET", "/healthz")
        finally:
            http.close()
            srv.close(timeout=5)
        assert fired
        got[name] = (bad[0], bad[1]["status"], bad[1]["reason"], alive,
                     good[0], good[1]["tokens"], dead)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (500, "error",
                               "engine step failed: "
                               "RuntimeError('injected')")
    assert got["port"][3][0] == 200 and got["port"][6][0] == 503


def test_close_cancels_queued_and_in_slot_requests_like_jax(weights):
    got = {}
    for name, make in (("jax", jax_server), ("port", port_server)):
        srv = make(weights, num_slots=1, chunk_steps=2, decode_images=False)
        slotted = srv.submit([3, 7, 9], seed=1)
        queued = srv.submit([6, 6], seed=2)
        srv.engine.step_once()             # admits one: one slot
        assert srv.engine.active_slots() == 1
        srv.close()
        got[name] = [(r.status, r.reason, r.request_id) for r in
                     (slotted.result(timeout=5), queued.result(timeout=5))]
    assert got["port"] == got["jax"] == [
        (S.CANCELLED, "server shutdown", 0),
        (S.CANCELLED, "server shutdown", 1)]


@pytest.mark.parametrize("kw", sorted(FLEET_KW))
def test_fleet_keywords_raise_type_error(weights, kw, monkeypatch):
    """(Named for its first version.) Each keyword alone is taken as
    JAX's server takes it: the same ``ValueError`` (process isolation
    needs replicas, a transport needs process isolation, ...) or a
    single-engine server that holds it, a mesh's over two devices (two
    CPU devices: ``serve_specs.visible_devices`` substituted, as JAX's
    conftest forces host devices). ``test_torch_process_replica.py``
    serves from process replicas, ``test_torch_mesh_engine.py`` from a
    mesh."""
    from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
    monkeypatch.setattr(SS, "visible_devices",
                        lambda: [torch.device("cpu")] * 2)
    got = {}
    for name, make in (("jax", jax_server), ("port", port_server)):
        try:
            srv = make(weights, num_slots=2, decode_images=False,
                       **{kw: FLEET_KW[kw]})
        except ValueError as e:
            got[name] = ("ValueError", str(e))
            continue
        try:
            got[name] = (srv._is_set, srv.isolation,
                         srv.health()["mesh_shape"])
        finally:
            srv.close()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kw", sorted(SET_KW))
def test_replica_set_keywords_are_taken_as_jax_takes_them(weights, kw):
    """Each replica-set keyword alone: a set (or a single engine) of the
    same shape as JAX's server builds, or JAX's ``ValueError``."""
    from dalle_pytorch_tpu.serve.autoscale import AutoscalePolicy as JAP
    from dalle_pytorch_tpu_torch.serve.autoscale import AutoscalePolicy
    got = {}
    for name, make, policy in (("jax", jax_server, JAP),
                               ("port", port_server, AutoscalePolicy)):
        value = policy(max_replicas=3) if kw == "autoscale" \
            else SET_KW[kw]
        try:
            srv = make(weights, num_slots=2, decode_images=False,
                       **{kw: value})
        except ValueError as e:
            got[name] = ("ValueError", str(e))
            continue
        try:
            got[name] = (srv._is_set,
                         getattr(srv.engine, "n_replicas", 1),
                         getattr(srv.engine, "max_replicas", 0),
                         srv.autoscaler is not None,
                         srv.load_weights is print,
                         getattr(srv.engine, "heartbeat_s", None))
        finally:
            srv.close()
    assert got["port"] == got["jax"]


def test_entry_point_runs_on_the_card_by_default(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, vae, _ = weights[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SRV.InferenceServer(model, vae)


# -- the queue's reject records -----------------------------------------------

@pytest.mark.parametrize("case", ["empty", "over_long", "full", "closed"])
def test_queue_reject_records_match_jax(case):
    """The records a rejected submit raises (the HTTP 400/429/503 bodies)
    and the ``rejected`` count: JAX's ``structured_event("serve_reject",
    ...)`` fields, ``time`` left out."""
    got = {}
    for name, mod in (("jax", JS), ("port", S)):
        events = []
        q = mod.RequestQueue(max_depth=1, max_prompt_len=8,
                             on_event=events.append)
        q.submit(mod.Request(codes=(1, 2), priority=3))
        codes = {"empty": (), "over_long": tuple(range(1, 10))}.get(
            case, (4, 5))
        if case == "closed":
            q.close()
        with pytest.raises(mod.ServeRejected) as ei:
            q.submit(mod.Request(codes=codes, priority=2))
        got[name] = (type(ei.value).__name__, no_time(ei.value.record),
                     q.rejected, [no_time(e) for e in events])
    assert got["port"] == got["jax"]
    assert got["port"][1]["kind"] == "serve_reject"
    assert got["port"][2] == 1


def test_torn_stream_is_reaped_and_leaves_no_stream_open(weights):
    """A client that hangs up after the first token event: the request is
    cancelled and its slot reaped in both servers; the port drops the
    stream's undelivered events, so ``streams_active`` returns to 0,
    where the JAX server keeps counting the torn stream."""
    import socket
    import struct
    import time
    got = {}
    for name, mod, make in (("jax", JSRV, jax_server),
                            ("port", SRV, port_server)):
        srv = make(weights, num_slots=2, chunk_steps=2,
                   decode_images=False)
        step = srv.engine.step_once

        def slow_step(step=step):
            time.sleep(0.02)        # the stream outlives the first event
            return step()

        srv.engine.step_once = slow_step
        srv.start()
        http = Http(mod, srv)
        try:
            sock = socket.create_connection(("127.0.0.1", http.port))
            body = json.dumps({"codes": [3, 7, 9], "seed": 11,
                               "stream": True}).encode()
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            seen = b""
            while b"event: tokens" not in seen:
                seen += sock.recv(4096)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            sock.close()
            deadline = time.perf_counter() + 30
            while srv.stats()["reaped"] < 1:
                assert time.perf_counter() < deadline
                time.sleep(0.01)
            while name == "port" and srv.stats()["streams_active"]:
                assert time.perf_counter() < deadline
                time.sleep(0.01)
            st = srv.stats()
            got[name] = (st["reaped"], st["streams_active"],
                         st["active_slots"])
        finally:
            http.close()
            srv.close()
    assert got["port"] == (1, 0, 0)
    assert got["jax"] == (1, 1, 0)
