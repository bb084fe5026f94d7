"""The port's gateway (``serve/gateway.py``) on the CPU, against JAX's.

Two-cell gateways over the tiny bundle of ``tests/test_gateway.py``
(dim 16, depth 2, text 8 + image 16 tokens; cells of 2 slots, paged at
page 4 with the prefix cache), built in JAX and carried to the port
through ``compat/from_jax.py``, float32. The gateways are not started:
a wave loop routes (``_dispatch``), waits for every cell-side arm and
sweeps (``_sweep_flights``), so each routing decision sees the same
cell loads in both packages. One scenario a module runs on both:
affinity (a prompt twice, then warm), a spill (four of one prompt over
two cells of two slots), a hedge (a ``gold`` tenant with ``hedge_s``
0), a streamed best-of-2 through the replayable sinks, and a cell down
(``gateway_cell_down_at_request``) replayed on the survivor.

Held equal: every request's tokens; the route, spill, hedge, cell-down
and replay events (timings left out); the gateway's counters, tenants'
ledgers and virtual time; the cells' federated counters; the streamed
samples' tokens and ``sample_done`` frames. Then the port alone: its
``/metrics`` fleet samples against the cells' stats, and the started
gateway (pump thread) over HTTP: 401, 429 with ``Retry-After`` from an
injected tenant clock, the admin reload. Every wait is bounded."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.resilience import faults as JF
from dalle_pytorch_tpu.serve import gateway as JG
from dalle_pytorch_tpu.serve import prefix_cache as JPC
from dalle_pytorch_tpu.serve import server as JSRV
from dalle_pytorch_tpu.serve import tenancy as JT
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.resilience import faults as TF
from dalle_pytorch_tpu_torch.serve import Gateway, TenantTable
from dalle_pytorch_tpu_torch.serve import gateway as TG
from dalle_pytorch_tpu_torch.serve import prefix_cache as TPC
from dalle_pytorch_tpu_torch.serve import server as TSRV
from dalle_pytorch_tpu_torch.serve import tenancy as TT

WAIT_S = 60.0
JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=16,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=16, depth=2, vae=JVCFG, num_text_tokens=50,
                      text_seq_len=8, heads=2, dim_head=8)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=16,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=16, depth=2, vae=TVCFG, num_text_tokens=50,
                      text_seq_len=8, heads=2, dim_head=8)
CELL_KW = dict(num_slots=2, queue_depth=16, kv="paged", page_size=4,
               prefix_cache=True, decode_images=False, weights_version="v0")
TENANTS = [{"name": "acme", "key": "ka", "weight": 2.0, "max_pages": 64},
           {"name": "gold", "key": "kg", "tier": "gold", "hedge_s": 0.0}]
# (wave, api key, prompt, submit keywords); a wave is routed, settled
# and swept before the next starts
WAVES = [
    ("affinity", [("ka", (3, 4, 5), dict(seed=7))] * 2),
    ("warm", [("ka", (3, 4, 5), dict(seed=7)),
              ("ka", (3, 4, 5), dict(seed=8))]),
    ("spill", [("ka", (6, 7), dict(seed=1))] * 4),
    ("hedge", [("kg", (8, 1, 2), dict(seed=5))]),
    ("stream", [("ka", (2, 3, 4), dict(seed=9, stream=True,
                                        n_samples=2))]),
    ("cell_down", [("ka", (5, 5, 5), dict(seed=11))] * 3),
]
COUNTERS = ("routed", "spills", "hedges", "hedge_wins", "replays",
            "cell_downs", "completed", "expired", "hedge_stream_rejects")
# event fields that are wall-clock readings
TIMED = ("time", "after_s")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    port = (from_jax.dalle_from_jax(dal_p, TCFG, device="cpu"),
            from_jax.vae_from_jax(vae_p, TVCFG, device="cpu"))
    return (dal_p, vae_p), port


def jax_cell(bundle, **kw):
    dal_p, vae_p = bundle[0]
    return JSRV.InferenceServer(dal_p, vae_p, JCFG,
                                **{**CELL_KW, **kw}).start()


def port_cell(bundle, **kw):
    model, vae = bundle[1]
    return TSRV.InferenceServer(model, vae, device="cpu",
                                **{**CELL_KW, **kw}).start()


def gateway(side, bundle, n_cells=2, **kw):
    """A gateway of ``side`` ("jax" or "port") over fresh cells, not
    started (the wave loop routes)."""
    mod, cell, cfg = (JG, jax_cell, JCFG) if side == "jax" \
        else (TG, port_cell, TCFG)
    cells = [cell(bundle) for _ in range(n_cells)]
    kw.setdefault("cfg", cfg)
    kw.setdefault("model_version", "v0")
    kw.setdefault("queue_depth", 64)
    kw.setdefault("pages_per_request", 6)
    return mod.Gateway(cells, **kw)


def settle(gw) -> None:
    """Wait for every routed arm, then sweep once."""
    with gw._lock:
        flights = list(gw._flights.values())
    for fl in flights:
        for h in (fl.cell_handle, fl.hedge_handle):
            if h is not None:
                h.result(WAIT_S)
    gw._sweep_flights(gw.clock())


def drive(gw, handles, hedge=False) -> None:
    """Route, (hedge,) settle and sweep until every handle is done."""
    t_end = time.monotonic() + WAIT_S
    while not all(h.done() for h in handles):
        assert time.monotonic() < t_end, "gateway wave did not finish"
        gw._sweep_dead_cells()
        gw._dispatch(gw.clock())
        if hedge:
            gw._sweep_hedges(gw.clock())
        settle(gw)


def strip(events):
    return [{k: v for k, v in e.items() if k not in TIMED}
            for e in events]


def run_scenario(side, bundle) -> dict:
    tmod, fmod = (JT, JF) if side == "jax" else (TT, TF)
    tbl = tmod.TenantTable.from_json(TENANTS)
    gw = gateway(side, bundle, tenants=tbl)
    out = {"tokens": {}, "stream": None}
    try:
        for wave, reqs in WAVES:
            plan = {}
            if wave == "cell_down":
                plan = dict(gateway_cell_down_at_request=gw.routed + 1)
            with fmod.injected(**plan):
                hs = [gw.submit(codes, api_key=key, **kw)
                      for key, codes, kw in reqs]
                sink = None
                if wave == "stream":
                    sink = gw._flights[hs[0].request.request_id].sinks[0]
                    assert sink.replayable
                drive(gw, hs, hedge=wave == "hedge")
            results = [h.result(WAIT_S) for h in hs]
            out["tokens"][wave] = [
                (r.status, [int(t) for t in r.tokens]) for r in results]
            if sink is not None:
                evs = []
                while True:
                    ev = sink.get(timeout=WAIT_S)
                    if ev is None:
                        break
                    evs.append(ev)
                out["stream"] = evs
                out["samples"] = [[int(t) for t in s.tokens]
                                  for s in results[0].samples]
        out["events"] = {k: strip(gw.events(k)) for k in (
            "gateway_route", "gateway_spill", "gateway_hedge",
            "gateway_cell_down", "gateway_replay")}
        out["counters"] = {k: getattr(gw, k) for k in COUNTERS}
        st = gw.stats()
        out["stats"] = {k: st[k] for k in (
            "alive_cells", "queue_depth", "fleet", "fleet_prefix_hit_rate",
            "virtual_time", "tenants", "streams_active", "rejected")}
        out["cells"] = [{k: v for k, v in c.items()} for c in st["cells"]]
        out["alive"] = [c.alive() for c in gw.cells]
        if side == "port":
            out["metrics"] = gw.metrics_text()
            out["cell_stats"] = [c.server.stats() for c in gw.cells
                                 if c.alive()]
    finally:
        gw.close(timeout=10.0)
    return out


@pytest.fixture(scope="module")
def runs(bundle):
    return {side: run_scenario(side, bundle) for side in ("jax", "port")}


# -- held against JAX ---------------------------------------------------------

@pytest.mark.parametrize("wave", [w for w, _ in WAVES])
def test_tokens_match_jax_per_wave(runs, wave):
    got, want = runs["port"]["tokens"][wave], runs["jax"]["tokens"][wave]
    assert [s for s, _ in got] == ["ok"] * len(got)
    assert got == want


def test_repeated_prompts_give_one_token_stream(runs):
    toks = runs["port"]["tokens"]
    assert toks["affinity"][0] == toks["affinity"][1] == toks["warm"][0]
    # the cell down replays byte for byte
    assert len({tuple(t) for _, t in toks["cell_down"]}) == 1


@pytest.mark.parametrize("kind", ["gateway_route", "gateway_spill",
                                  "gateway_hedge", "gateway_cell_down",
                                  "gateway_replay"])
def test_events_match_jax(runs, kind):
    got = runs["port"]["events"][kind]
    assert got == runs["jax"]["events"][kind]
    assert got, kind      # every kind fired in the scenario


def test_counters_match_jax(runs):
    got = runs["port"]["counters"]
    assert got == runs["jax"]["counters"]
    assert got["spills"] >= 1 and got["hedges"] >= 1
    assert got["cell_downs"] == 1 and got["replays"] >= 1
    assert got["completed"] == sum(len(r) for _, r in WAVES)


def test_stats_and_cells_match_jax(runs):
    got, want = runs["port"], runs["jax"]
    assert got["stats"] == want["stats"]
    assert got["cells"] == want["cells"]
    assert got["alive"] == want["alive"]
    assert sorted(got["alive"]) == [False, True]
    assert got["stats"]["fleet"]["prefix_hits"] >= 2


def test_affinity_lands_repeats_on_one_cell(runs):
    routes = runs["port"]["events"]["gateway_route"]
    first = routes[:4]               # the affinity and warm waves
    assert len({e["cell"] for e in first}) == 1
    assert all(e["affine"] for e in first)


def test_streamed_best_of_two_matches_jax(runs):
    got, want = runs["port"], runs["jax"]
    assert got["samples"] == want["samples"]
    kinds = [e["event"] for e in got["stream"]]
    assert kinds.count("sample_done") == 2
    assert [e for e in got["stream"] if e["event"] == "sample_done"] == \
        [e for e in want["stream"] if e["event"] == "sample_done"]
    for s in (0, 1):
        toks = [t for e in got["stream"]
                if e["event"] == "tokens" and e["sample"] == s
                for t in e["tokens"]]
        jtoks = [t for e in want["stream"]
                 if e["event"] == "tokens" and e["sample"] == s
                 for t in e["tokens"]]
        assert toks == jtoks and len(toks) >= TCFG.image_seq_len


def test_metrics_fleet_samples_sum_to_cells_stats(runs):
    """The unlabeled fleet sample of each federated counter equals the
    sum of its ``cell`` samples and of the live cells' own stats."""
    text, cells = runs["port"]["metrics"], runs["port"]["cell_stats"]
    for key, family in TG._FEDERATED_COUNTERS:
        per_cell, fleet = [], None
        for line in text.splitlines():
            if not line.startswith(family + " ") and \
                    not line.startswith(family + "{"):
                continue
            name, value = line.rsplit(" ", 1)
            (per_cell.append(float(value)) if "cell=" in name
             else None)
            if "cell=" not in name:
                fleet = float(value)
        assert fleet == sum(per_cell) == sum(c[key] for c in cells), key
    assert 'dalle_gateway_tenant_admitted_total{tenant="acme"}' in text
    assert "dalle_gateway_e2e_latency_seconds" in text


# -- routing plumbing ---------------------------------------------------------

class FakeServer:
    def __init__(self, slots=2):
        self.slots = slots

    def stats(self):
        return {"num_slots": self.slots}

    def engine_alive(self):
        return True


def test_content_key_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        codes = tuple(int(c) for c in rng.integers(1, 50, rng.integers(1, 9)))
        for version in ("v0", "v1"):
            want = JPC.content_key(codes, cfg=JCFG, model_version=version)
            assert TPC.content_key(codes, cfg=TCFG,
                                   model_version=version) == want


def test_rank_matches_jax():
    rng = np.random.default_rng(1)
    for n_cells in (1, 2, 3, 5):
        jg = JG.Gateway([FakeServer() for _ in range(n_cells)])
        tg = Gateway([FakeServer() for _ in range(n_cells)])
        try:
            for _ in range(16):
                key = "%064x" % int(rng.integers(0, 2 ** 62))
                assert tg._rank(key) == jg._rank(key)
                assert sorted(tg._rank(key)) == list(range(n_cells))
        finally:
            jg.close(close_cells=False)
            tg.close(close_cells=False)


@pytest.mark.parametrize("n,override", [(1, 0), (4, 0), (4, 8), (1, 8),
                                        (3, 5), (2, 16)])
def test_flight_pages_and_wfq_cost_match_jax(n, override):
    """The COW-aware page charge and the image-token WFQ cost."""
    jg = JG.Gateway([FakeServer()], cfg=JCFG, pages_per_request=6)
    tg = Gateway([FakeServer()], cfg=TCFG, pages_per_request=6)
    try:
        assert tg._flight_pages(n, override) == \
            jg._flight_pages(n, override)
        jh = jg.submit((1, 2), n_samples=n,
                       image_seq_len_override=override)
        th = tg.submit((1, 2), n_samples=n,
                       image_seq_len_override=override)
        assert (th.vstart, th.vfinish) == (jh.vstart, jh.vfinish)
        assert th.vfinish - th.vstart == n * (override or
                                              TCFG.image_seq_len)
        tg.cfg = jg.cfg = None
        assert tg._flight_pages(n, override) == \
            jg._flight_pages(n, override)
    finally:
        jg.close(close_cells=False)
        tg.close(close_cells=False)


class StreamRefusingServer(FakeServer):
    """A cell that refuses streams typed, as a process-isolated
    ``InferenceServer`` does (``stream_process_isolation``)."""

    def __init__(self, sched):
        super().__init__()
        self.sched = sched

    def submit(self, codes, **kw):
        record = {"event": "resilience", "kind": "serve_reject",
                  "reason": "stream_process_isolation"}
        raise self.sched.InvalidRequest(record)


def test_a_cell_that_refuses_the_stream_ends_it_typed_as_jax_does():
    from dalle_pytorch_tpu.serve import scheduler as JS
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    out = []
    for mod, sched in ((JG, JS), (TG, S)):
        gw = mod.Gateway([StreamRefusingServer(sched) for _ in range(2)])
        try:
            h = gw.submit((1, 2, 3), stream=True)
            sink = gw._flights[h.request.request_id].sinks[0]
            gw._dispatch(gw.clock())
            res = h.result(timeout=WAIT_S)
            evs = [e for e in iter(lambda: sink.get(timeout=WAIT_S), None)]
            out.append((res.status, res.reason, gw.routed,
                        [e["event"] for e in evs], len(gw._flights)))
        finally:
            gw.close(close_cells=False)
    assert out[1] == out[0]
    assert out[1][:3] == ("error", "stream_process_isolation", 0)


def test_hedge_loser_on_a_thread_cell_is_reaped(bundle):
    """The started gateway hedges a ``gold`` request (``hedge_s`` 0) onto
    the second cell; the first result wins, the loser's cell handle is
    cancelled from outside, and its engine frees the slot: both cells
    go back to no active slot."""
    tbl = TenantTable.from_json([{"name": "gold", "key": "kg",
                                  "tier": "gold", "hedge_s": 0.0}])
    gw = gateway("port", bundle, tenants=tbl, hedge_check_s=0.0).start()
    try:
        res = gw.generate((8, 1, 2), api_key="kg", seed=5, timeout=WAIT_S)
        assert res.ok and gw.hedges == 1
        t_end = time.monotonic() + WAIT_S
        while any(c.server.stats()["active_slots"] for c in gw.cells):
            assert time.monotonic() < t_end, "a hedge arm was not reaped"
            time.sleep(0.01)
        assert all(c.inflight == 0 for c in gw.cells)
        assert gw.events("gateway_hedge")[0]["cell"] != \
            gw.events("gateway_route")[0]["cell"]
    finally:
        gw.close(timeout=10.0)


# -- the started gateway over HTTP -------------------------------------------

def test_gateway_http_surface(bundle):
    """POST /generate with an API key; 401 for a bad key; 429 with
    Retry-After and a ``tenant_throttled`` body once the tenant's rps
    bucket is empty (the tenant clock is frozen, so no refill can hide
    it); the admin reload (401 without the token); /tenants, /stats,
    /healthz, /metrics."""
    frozen = [100.0]
    tbl = TenantTable.from_json([{"name": "acme", "key": "k1", "rps": 2.0}],
                                clock=lambda: frozen[0])
    gw = gateway("port", bundle, tenants=tbl, admin_token="admintok")
    gw.start()
    httpd = TG.make_gateway_http_server(gw, port=0)
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def call(path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://{host}:{port}{path}",
                                     data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)

    try:
        code, body, _ = call("/generate", {"codes": [1, 2], "seed": 3},
                             {"X-API-Key": "k1"})
        assert code == 200 and body["status"] == "ok"
        assert len(body["tokens"]) == TCFG.image_seq_len
        code, body, _ = call("/generate", {"codes": [1, 2]},
                             {"X-API-Key": "bad"})
        assert code == 401 and body["kind"] == "gateway_auth_failed"
        code, body, _ = call("/generate", {"codes": [3, 3]},
                             {"Authorization": "Bearer k1"})
        assert code == 200                 # the bucket's second token
        code, body, headers = call("/generate", {"codes": [3, 3]},
                                   {"X-API-Key": "k1"})
        assert code == 429 and body["kind"] == "tenant_throttled"
        assert body["quota"] == "rps" and body["retry_after_s"] == 0.5
        assert headers["Retry-After"] == "1"
        code, _, _ = call("/admin/tenants", [{"name": "acme", "key": "k2"}])
        assert code == 401
        code, body, _ = call("/admin/tenants",
                             [{"name": "acme", "key": "k2", "rps": 0.0}],
                             {"Authorization": "Bearer admintok"})
        assert code == 200 and body["tenants"] == ["acme"]
        code, body, _ = call("/generate", {"codes": [1, 2], "seed": 3},
                             {"X-API-Key": "k2"})
        assert code == 200 and body["status"] == "ok"
        code, body, _ = call("/generate", {"codes": [1, 2]},
                             {"X-API-Key": "k1"})
        assert code == 401                 # the old key went with reload
        code, body, _ = call("/generate", {"codes": []},
                             {"X-API-Key": "k2"})
        assert code == 400
        code, body, _ = call("/tenants")
        assert code == 200 and body["tenants"]["acme"]["admitted"] == 3
        assert body["tenants"]["acme"]["throttled"] == 1
        code, body, _ = call("/stats")
        assert code == 200 and body["completed"] == 3
        code, body, _ = call("/healthz")
        assert code == 200 and body["alive_cells"] == ["cell0", "cell1"]
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=WAIT_S) as r:
            assert b"dalle_gateway_routed_total 3" in r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        gw.close(timeout=10.0)
