"""The port's replica set (``serve/replica.py``, thread isolation) and
autoscaler (``serve/autoscale.py``) on the CPU, against the JAX package.

The thread cases of JAX's ``tests/test_replica.py``: crash and hang
failover, the circuit breaker, failover composed with paged eviction,
drain, routing and stats, scale out and in, rolling upgrades with
canaries, version-pinned replay, the autoscaler, the head-of-line
reservation handed back at a drain, and ``POST /admin/scale``. Every
request's tokens equal JAX's ``generate_images`` at batch 1 on the same
weights (the replicas replay deterministically), and under the sync
driver with the same fault plan the set's counters and its
``serve_replica_crash``, ``serve_scale_reject`` and
``autoscale_decision`` records equal the JAX ``ReplicaSet``'s (``time``
and the embedded flight-ring tails left out). The hang tests run the
threaded loops with a short ``replica_hang_s``. Also: the process
options reach a process set (``test_torch_process_*.py`` hold it to
JAX), a mesh builds a set of mesh slices, the replicas up at
construction get the preview hook, the split-counter buffer of K4
survives threads racing to grow it, and the chip smoke's sync schedule
gives, on the CPU, the counters and events it holds the card to
(``chip_smoke.py::REPLICA_EXPECT``).
"""

import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.resilience import faults as JF
from dalle_pytorch_tpu.resilience.retry import RetryPolicy as JRetry
from dalle_pytorch_tpu.serve import replica as JR
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.autoscale import (AutoscalePolicy,
                                                     Autoscaler)
from dalle_pytorch_tpu_torch.serve.replica import (BROKEN, DRAINED,
                                                   RETIRED, RUNNING,
                                                   ReplayVersionMismatch,
                                                   ReplicaSet, ScaleError,
                                                   UpgradeAborted)

VK = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
          hidden_dim=8)
DK = dict(dim=16, depth=2, num_text_tokens=50, text_seq_len=8, heads=2,
          dim_head=8)
JCFG = JD.DALLEConfig(vae=JV.VAEConfig(**VK), **DK)
TCFG = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **DK)

# short first-retry backoff so the circuit breaker runs in milliseconds
FAST = dict(max_attempts=1, deadline_s=None, base_backoff_s=0.01,
            backoff_multiplier=2.0, max_backoff_s=0.1, jitter=0.0)

REQS = [
    dict(codes=(3, 7, 9), seed=11),
    dict(codes=(5, 2, 8, 1, 4), seed=23, temperature=0.7, filter_thres=0.8),
    dict(codes=(6, 6), seed=5, temperature=1.3, top_p=0.9),
    dict(codes=(2, 4, 4), seed=7),
    dict(codes=(1, 5), seed=13),
    dict(codes=(4, 4, 4, 4), seed=17),
]


def req(mod, r):
    return mod.Request(codes=r["codes"], seed=r["seed"],
                       sampling=mod.SamplingParams(
                           temperature=r.get("temperature", 1.0),
                           filter_thres=r.get("filter_thres", 0.5),
                           top_p=r.get("top_p", 0.0)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_leaked_plan():
    faults.deactivate()
    JF.deactivate()
    yield
    faults.deactivate()
    JF.deactivate()


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1),
                                       JCFG.vae))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, vae_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


@pytest.fixture(scope="module")
def bundle_v2(bundle):
    """A second weights generation (another init key): same-seed tokens
    differ between generations."""
    dal_p = jax.device_get(JD.dalle_init(jax.random.PRNGKey(42), JCFG,
                                         bundle[1]))
    return dal_p, bundle[1], from_jax.dalle_from_jax(dal_p, TCFG,
                                                     device="cpu")


_REF: dict = {}


def reference(b, r) -> list:
    """JAX ``generate_images`` at batch 1 on ``b``'s weights."""
    dal_p, vae_p, _ = b
    key = (id(dal_p), r["codes"], r["seed"], r.get("temperature", 1.0),
           r.get("filter_thres", 0.5), r.get("top_p", 0.0))
    if key not in _REF:
        _, seq = JD.generate_images(
            dal_p, vae_p, jnp.asarray([r["codes"]], jnp.int32), cfg=JCFG,
            rng=jax.random.PRNGKey(r["seed"]),
            filter_thres=r.get("filter_thres", 0.5),
            top_p=r.get("top_p", 0.0),
            temperature=r.get("temperature", 1.0), return_img_seq=True)
        _REF[key] = [int(t) for t in np.asarray(seq)[0]]
    return _REF[key]


def assert_token_exact(b, handles, reqs, timeout=30):
    for h, r in zip(handles, reqs):
        res = h.result(timeout=timeout)
        assert res.status == S.OK, (r, res.status, res.reason)
        assert [int(t) for t in res.tokens] == reference(b, r)


class Sink:
    def __init__(self):
        self.events = []

    def event(self, **rec):
        self.events.append(rec)

    def of(self, kind, drop=("time", "flight")):
        return [{k: v for k, v in e.items() if k not in drop}
                for e in self.events if e.get("kind") == kind]


def port_set(b, queue=None, **kw):
    queue = queue or S.RequestQueue(max_depth=kw.pop("max_depth", 16))
    kw.setdefault("bringup_policy", RetryPolicy(**FAST))
    return ReplicaSet(b[2], queue, device="cpu", **kw), queue


def jax_set(b, queue=None, **kw):
    queue = queue or JS.RequestQueue(max_depth=kw.pop("max_depth", 16))
    kw.setdefault("bringup_policy", JRetry(**FAST))
    return JR.ReplicaSet(b[0], JCFG, queue, **kw), queue


SET_COUNTERS = ("completed", "tokens_decoded", "failovers", "reclaimed",
                "bringup_failures", "evicted", "requeued", "migrations",
                "migrate_fallbacks", "migrated_tokens_saved", "scale_outs",
                "scale_ins", "upgrades", "hol_handoffs", "expired",
                "alive_replicas", "replicas")


def counters(stats) -> dict:
    return {k: stats[k] for k in SET_COUNTERS}


# -- crash and hang failover --------------------------------------------------


class TestCrashFailover:
    pytestmark = pytest.mark.faults

    def test_kill_replica_1_of_2_mid_decode_zero_loss_token_exact(
            self, bundle):
        """Replica 1 of 2 crashes after its 2nd chunk: every request gives
        the undisturbed run's tokens, and the counters and the crash
        record equal JAX's set's under the same plan."""
        got = {}
        for name, make, fmod, smod in (("port", port_set, faults, S),
                                       ("jax", jax_set, JF, JS)):
            sink = Sink()
            rs, q = make(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         metrics=sink)
            handles = [q.submit(req(smod, r)) for r in REQS]
            with fmod.injected(fault_replica=1, replica_crash_at_chunk=2):
                rs.run_until_idle()
            if name == "port":
                assert_token_exact(bundle, handles, REQS)
            got[name] = (counters(rs.stats()),
                         sink.of("serve_replica_crash"))
        assert got["port"] == got["jax"]
        stats, crash = got["port"]
        assert stats["failovers"] == 1 and stats["reclaimed"] >= 1
        assert stats["tokens_decoded"] == sum(
            TCFG.seq_len - len(r["codes"]) for r in REQS)
        assert crash[0]["replica"] == 1

    def test_crash_with_single_replica_recovers_via_restart(self, bundle):
        rs, q = port_set(bundle, replicas=1, num_slots=2, chunk_steps=4)
        handles = [q.submit(req(S, r)) for r in REQS[:2]]
        with faults.injected(fault_replica=0, replica_crash_at_chunk=1):
            rs.run_until_idle()
        assert rs.failovers == 1
        assert_token_exact(bundle, handles, REQS[:2])


class TestHangFailover:
    pytestmark = pytest.mark.faults

    def test_hang_is_fenced_within_heartbeat_deadline(self, bundle):
        """A replica whose loop stalls is fenced off its heartbeat with no
        help from the stuck thread, and its requests replay to their
        tokens while that thread still sleeps."""
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         heartbeat_s=0.25, metrics=sink)
        rs.start()
        try:
            hang_s = 3.0
            with faults.injected(fault_replica=0, replica_hang_at_chunk=1,
                                 replica_hang_s=hang_s):
                handles = [q.submit(req(S, r)) for r in REQS[:4]]
                t0 = time.perf_counter()
                while rs.failovers < 1 \
                        and time.perf_counter() - t0 < hang_s:
                    time.sleep(0.005)
                assert rs.failovers >= 1, "hang never detected"
                assert time.perf_counter() - t0 < hang_s / 2
                fenced = sink.of("serve_replica_fenced")
                assert fenced and "heartbeat" in fenced[0]["reason"]
                for h in handles:
                    assert h.result(timeout=30).status == S.OK
                assert time.perf_counter() - t0 < hang_s
            assert_token_exact(bundle, handles, REQS[:4])
        finally:
            rs.close()

    @pytest.mark.parametrize("slow", ["first_prefill", "first_dispatch",
                                      "late_loop"])
    def test_slow_first_calls_are_not_fenced(self, bundle, monkeypatch,
                                             slow):
        """A replica whose first prefill or first dispatch outlasts the
        hang deadline (not the compile grace), or whose loop starts a
        deadline after its engine was built (``start`` builds K4 in
        between), is not fenced: the engine marks its first calls
        ``compiling`` and stamps a heartbeat after them, and the
        deadline runs from the loop's start."""
        from dalle_pytorch_tpu_torch.serve.engine import Engine
        stall_s, firsts = 1.0, set()

        def stalling(cls_method, key):
            def run(self, *args, **kwargs):
                if (id(self), key) not in firsts:
                    firsts.add((id(self), key))
                    time.sleep(stall_s)
                return cls_method(self, *args, **kwargs)
            return run

        if slow == "first_prefill":
            monkeypatch.setattr(Engine, "_prefill_group", stalling(
                Engine._prefill_group, "prefill"))
        elif slow == "first_dispatch":
            monkeypatch.setattr(Engine, "_dispatch_chunk", stalling(
                Engine._dispatch_chunk, "dispatch"))
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         heartbeat_s=0.25, compile_grace_s=30.0,
                         metrics=sink)
        if slow == "late_loop":
            # the set built a deadline ago, and each loop slow to reach
            # its first step
            time.sleep(stall_s)
            first_chunk = faults.on_replica_chunk

            def late(index, chunk):
                if (index, "loop") not in firsts:
                    firsts.add((index, "loop"))
                    time.sleep(0.1)
                return first_chunk(index, chunk)

            monkeypatch.setattr(faults, "on_replica_chunk", late)
        rs.start()
        try:
            handles = [q.submit(req(S, r)) for r in REQS[:4]]
            assert_token_exact(bundle, handles, REQS[:4])
        finally:
            rs.close()
        assert rs.failovers == 0, sink.of("serve_replica_fenced")
        assert not sink.of("serve_replica_fenced")
        assert len(firsts) >= 2

    def test_close_with_hung_replica_never_strands_callers(self, bundle):
        from dalle_pytorch_tpu_torch.serve.server import InferenceServer
        server = InferenceServer(bundle[2], None, num_slots=2,
                                 queue_depth=16, replicas=2,
                                 heartbeat_s=30.0, decode_images=False,
                                 device="cpu")
        server.start()
        with faults.injected(fault_replica=0, replica_hang_at_chunk=1,
                             replica_hang_s=2.0):
            handles = [server.submit(r["codes"], seed=r["seed"])
                       for r in REQS]
            time.sleep(0.3)
            t0 = time.perf_counter()
            server.close(timeout=0.5)
            assert time.perf_counter() - t0 < 2.0
            for h in handles:
                assert h.result(timeout=1).status in (S.OK, S.CANCELLED)


class TestCircuitBreaker:
    pytestmark = pytest.mark.faults

    def test_flaky_bringup_circuit_breaks_then_rejoins_routing(
            self, bundle):
        with faults.injected(fault_replica=1, replica_flaky_bringup=2):
            rs, q = port_set(bundle, replicas=2, num_slots=2,
                             chunk_steps=4)
            r1 = rs.replicas[1]
            assert r1.state == BROKEN and rs.bringup_failures == 1
            assert rs.replicas[0].state == RUNNING
            h = q.submit(req(S, REQS[0]))
            rs.run_until_idle()
            assert h.result(timeout=10).status == S.OK
            deadline = time.perf_counter() + 10
            while r1.state != RUNNING and time.perf_counter() < deadline:
                time.sleep(0.02)
                rs.step_once()
            assert r1.state == RUNNING
            assert rs.bringup_failures == 2 and r1.bringups == 3
            handles = [q.submit(req(S, r)) for r in REQS[:4]]
            rs.run_until_idle()
            assert_token_exact(bundle, handles, REQS[:4])
            assert r1.engine.completed >= 1

    def test_all_replicas_down_degrades_to_typed_backpressure(self,
                                                              bundle):
        q = S.RequestQueue(max_depth=2)
        with faults.injected(fault_replica=0, replica_flaky_bringup=99):
            rs, _ = port_set(bundle, q, replicas=1, num_slots=2)
            assert rs.replicas[0].state == BROKEN and not rs.alive()
            h_dead = q.submit(S.Request(codes=(1, 2), seed=0,
                                        deadline_s=0.0))
            q.submit(S.Request(codes=(2, 2), seed=1))
            with pytest.raises(S.QueueFull):
                q.submit(S.Request(codes=(3, 3), seed=2))
            time.sleep(0.01)
            rs.step_once()
            assert h_dead.result(timeout=1).status == S.DEADLINE_EXCEEDED


class TestPagedMigration:
    pytestmark = pytest.mark.faults

    def test_migration_composes_with_paged_eviction(self, bundle):
        """A pool of one full sequence evicts mid-decode; a crash then
        reclaims the evicted and the decoding requests; every request
        lands on its tokens, and the counters (evictions included) equal
        JAX's."""
        got = {}
        for name, make, fmod, smod in (("port", port_set, faults, S),
                                       ("jax", jax_set, JF, JS)):
            rs, q = make(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         kv="paged", page_size=4, num_pages=7)
            handles = [q.submit(req(smod, r)) for r in REQS]
            with fmod.injected(fault_replica=0, replica_crash_at_chunk=4):
                rs.run_until_idle()
            if name == "port":
                assert_token_exact(bundle, handles, REQS)
                assert all(r.engine.alloc.in_use == 0
                           for r in rs.replicas if r.engine is not None)
            got[name] = counters(rs.stats())
        assert got["port"] == got["jax"]
        assert got["port"]["failovers"] == 1 and got["port"]["evicted"] >= 1


class TestDrain:
    def test_operator_drain_migrates_inflight_and_undrain_rejoins(
            self, bundle):
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4)
        handles = [q.submit(req(S, r)) for r in REQS[:4]]
        for _ in range(2):
            rs.step_once()
        assert rs.replicas[0].engine.active_slots() > 0
        assert rs.drain_replica(0) >= 1
        assert rs.replicas[0].state == DRAINED
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS[:4])
        assert rs.replicas[0].state == DRAINED
        assert rs.undrain_replica(0)
        assert rs.replicas[0].state == RUNNING
        h = q.submit(req(S, REQS[4]))
        rs.run_until_idle()
        assert h.result(timeout=10).status == S.OK


# -- routing and stats --------------------------------------------------------


class TestRoutingAndStats:
    def test_burst_routes_least_loaded_across_replicas(self, bundle):
        got = {}
        for name, make, smod in (("port", port_set, S), ("jax", jax_set,
                                                          JS)):
            rs, q = make(bundle, replicas=2, num_slots=2, chunk_steps=4)
            handles = [q.submit(req(smod, r)) for r in REQS[:4]]
            rs.step_once()
            assert all(r.engine.active_slots() == 2 for r in rs.replicas)
            rs.run_until_idle()
            if name == "port":
                assert_token_exact(bundle, handles, REQS[:4])
            st = rs.stats()
            got[name] = (counters(st), [p["completed"]
                                        for p in st["per_replica"]],
                         st)
        assert got["port"][:2] == got["jax"][:2] and got["port"][1] == [2, 2]
        # JAX's keys, less its compile counters (the port traces nothing)
        port, jx = got["port"][2], got["jax"][2]
        assert set(port) == set(jx) - {"decode_compiles",
                                       "prefill_compiles"}
        assert set(port["per_replica"][0]) == set(jx["per_replica"][0]) \
            - {"decode_compiles", "prefill_compiles"}

    def test_page_aware_routing_prefers_replica_with_free_pages(
            self, bundle):
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=24,
                         kv="paged", page_size=4, num_pages=7)
        q.submit(req(S, REQS[0]))
        rs.step_once()
        full = [r for r in rs.replicas if r.engine.alloc.free == 0]
        assert len(full) == 1
        q.submit(req(S, REQS[1]))
        rs.step_once()
        empty = [r for r in rs.replicas if r is not full[0]][0]
        assert empty.engine.active_slots() == 1
        rs.run_until_idle()

    def test_replica_server_end_to_end_stats_and_health(self, bundle):
        from dalle_pytorch_tpu_torch.serve.server import InferenceServer
        server = InferenceServer(bundle[2], None, num_slots=2,
                                 queue_depth=16, replicas=2,
                                 decode_images=False, device="cpu").start()
        try:
            r = REQS[0]
            res = server.generate(r["codes"], seed=r["seed"], timeout=60)
            assert res.status == S.OK
            assert [int(t) for t in res.tokens] == reference(bundle, r)
            stats = server.stats()
            assert stats["completed"] == 1 and stats["replicas"] == 2
            assert stats["requests_submitted"] == 1
            health = server.health()
            assert health["ok"] is True and len(health["replicas"]) == 2
            assert all(x["alive"] for x in health["replicas"])
            assert "dalle_serve_replica_up" in server.metrics_text()
        finally:
            server.close()


# -- the elastic fleet --------------------------------------------------------


class TestElasticScale:
    def test_add_replica_joins_routing_and_caps_are_typed(self, bundle):
        """Scale-out under load serves token-exact; the cap, the retired
        slot and the last-replica floor are typed ScaleErrors whose
        records equal JAX's."""
        got = {}
        for name, make, smod in (("port", port_set, S), ("jax", jax_set,
                                                          JS)):
            sink = Sink()
            rs, q = make(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         weights_version="v1", max_replicas=3,
                         metrics=sink, max_depth=32)
            handles = [q.submit(req(smod, r)) for r in REQS[:4]]
            for _ in range(2):
                rs.step_once()
            assert rs.add_replica() == 2 and rs.n_replicas == 3
            rs.run_until_idle()
            more = [q.submit(req(smod, r)) for r in REQS]
            rs.run_until_idle()
            if name == "port":
                assert_token_exact(bundle, handles + more, REQS[:4] + REQS)
            rejects = []
            for op in (lambda: rs.add_replica(),
                       lambda: (rs.remove_replica(2), rs.remove_replica(2)),
                       lambda: rs.drain_replica(2),
                       lambda: (rs.remove_replica(1),
                                rs.remove_replica(0))):
                with pytest.raises(JR.ScaleError if name == "jax"
                                   else ScaleError) as e:
                    op()
                rejects.append({k: v for k, v in e.value.record.items()
                                if k not in ("time", "flight")})
            assert rs.replicas[2].state == RETIRED
            h = q.submit(req(smod, REQS[0]))
            rs.run_until_idle()
            assert h.result(timeout=10).status == S.OK
            got[name] = (rejects, sink.of("serve_scale_out"),
                         counters(rs.stats()))
        assert got["port"] == got["jax"]
        assert [r["reason"] for r in got["port"][0]] == [
            "scale_out_past_cap", "replica_retired", "replica_retired",
            "remove_last_replica"]

    def test_remove_replica_drains_inflight_zero_loss(self, bundle):
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4)
        handles = [q.submit(req(S, r)) for r in REQS[:4]]
        for _ in range(2):
            rs.step_once()
        assert rs.replicas[0].engine.active_slots() > 0
        assert rs.remove_replica(0, reason="test scale-in") >= 1
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS[:4])
        assert rs.stats()["scale_ins"] == 1

    @pytest.mark.faults
    def test_scale_out_bringup_kill_circuit_breaks_zero_loss(self, bundle):
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         max_replicas=3, max_depth=32)
        handles = [q.submit(req(S, r)) for r in REQS]
        rs.step_once()
        with faults.injected(scale_add_bringup_crash=1):
            index = rs.add_replica()
            assert rs.replicas[index].state == BROKEN
            assert rs.bringup_failures >= 1
            rs.run_until_idle()
            deadline = time.perf_counter() + 30
            while rs.replicas[index].state != RUNNING \
                    and time.perf_counter() < deadline:
                rs.step_once()
                time.sleep(0.005)
        assert rs.replicas[index].state == RUNNING
        assert rs.failovers == 0
        assert_token_exact(bundle, handles, REQS)


class TestRollingUpgrade:
    def test_rolling_upgrade_zero_loss_byte_identical_per_version(
            self, bundle, bundle_v2):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         weights_version="v1", metrics=sink, max_depth=32)
        pre = [q.submit(req(S, r)) for r in REQS[:2]]
        rs.run_until_idle()
        for h in pre:
            res = h.result(timeout=10)
            assert res.status == S.OK and res.weights_version == "v1"
        mid = [q.submit(req(S, r)) for r in REQS]
        record = rs.rolling_upgrade(version="v2", params=bundle_v2[2],
                                    canary_codes=[(1, 2)], canaries=2,
                                    replica_timeout_s=120)
        assert len(record["replicas"]) == 2
        rs.run_until_idle()
        for h, r in zip(mid, REQS):
            res = h.result(timeout=10)
            assert res.status == S.OK and res.weights_version in ("v1",
                                                                  "v2")
            b = bundle if res.weights_version == "v1" else bundle_v2
            assert [int(t) for t in res.tokens] == reference(b, r)
        post = q.submit(req(S, REQS[0]))
        rs.run_until_idle()
        res = post.result(timeout=10)
        assert res.weights_version == "v2"
        assert [int(t) for t in res.tokens] == reference(bundle_v2, REQS[0])
        stats = rs.stats()
        assert stats["weights_version"] == "v2" and stats["upgrades"] == 1
        assert all(p["weights_version"] == "v2"
                   for p in stats["per_replica"])
        assert sink.of("serve_upgrade_begin")
        assert len(sink.of("serve_upgrade_replica")) == 2
        assert sink.of("serve_upgrade_done")
        rs._upgrading = True
        try:
            with pytest.raises(ScaleError) as e:
                rs.add_replica()
            assert e.value.record["reason"] == "upgrade_in_progress"
        finally:
            rs._upgrading = False

    def test_upgrade_skips_operator_drained_replica(self, bundle,
                                                    bundle_v2):
        sink = Sink()
        rs, q = port_set(bundle, replicas=3, num_slots=2, chunk_steps=4,
                         weights_version="v1", metrics=sink)
        rs.drain_replica(2)
        record = rs.rolling_upgrade(version="v2", params=bundle_v2[2],
                                    canary_codes=[(1, 2)], canaries=1,
                                    replica_timeout_s=120)
        assert rs.replicas[2].state == DRAINED
        assert {"replica": 2, "skipped": "drained"} in record["replicas"]
        assert sink.of("serve_upgrade_skip_drained")
        assert rs.replicas[2].version == "v2"
        assert rs.undrain_replica(2)
        h = q.submit(req(S, REQS[0]))
        rs.run_until_idle()
        res = h.result(timeout=10)
        assert res.weights_version == "v2"
        assert [int(t) for t in res.tokens] == reference(bundle_v2, REQS[0])

    @pytest.mark.faults
    def test_canary_failure_aborts_and_rolls_back_whole_fleet(
            self, bundle, bundle_v2):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         weights_version="v1", metrics=sink, max_depth=32)
        handles = [q.submit(req(S, r)) for r in REQS[:4]]
        with faults.injected(upgrade_canary_fail_replica=1):
            with pytest.raises(UpgradeAborted) as e:
                rs.rolling_upgrade(version="v2", params=bundle_v2[2],
                                   canary_codes=[(1, 2)], canaries=1,
                                   replica_timeout_s=120)
        assert e.value.record["fleet_version"] == "v1"
        assert sorted(e.value.record["rolled_back"]) == [0, 1]
        assert all(r.version == "v1" and not r.canary
                   for r in rs.replicas)
        assert rs.weights_version == "v1" and rs.upgrades == 0
        rs.run_until_idle()
        for h in handles:
            assert h.result(timeout=10).status == S.OK
        h = q.submit(req(S, REQS[0]))
        rs.run_until_idle()
        res = h.result(timeout=10)
        assert res.weights_version == "v1"
        assert [int(t) for t in res.tokens] == reference(bundle, REQS[0])
        assert sink.of("serve_upgrade_abort")
        assert not sink.of("serve_upgrade_done")
        record = rs.rolling_upgrade(version="v2", params=bundle_v2[2],
                                    canary_codes=[(1, 2)], canaries=1,
                                    replica_timeout_s=120)
        assert len(record["replicas"]) == 2
        assert rs.weights_version == "v2" and rs.upgrades == 1


class TestVersionPinnedReplay:
    def test_pick_refuses_cross_version_replay_typed(self, bundle):
        rs, q = port_set(bundle, replicas=1, num_slots=2, chunk_steps=4,
                         weights_version="v1", max_depth=8)
        h = q.submit(req(S, REQS[0]))
        ready, _ = q.pop_ready(1)
        assert ready == [h]
        h.replay_version = "v0-archaic"
        with pytest.raises(ReplayVersionMismatch):
            rs._pick([rs.replicas[0]], {0: 1}, h)

    @pytest.mark.faults
    def test_failover_replay_holds_for_same_version_replica(
            self, bundle, bundle_v2):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         weights_version="v1", metrics=sink, max_depth=32)
        rs.drain_replica(1)
        handles = [q.submit(req(S, r)) for r in REQS[:2]]
        for _ in range(2):
            rs.step_once()
        r1 = rs.replicas[1]
        r1.params_override = bundle_v2[2]
        r1.version = "v2"
        assert rs.undrain_replica(1)
        with faults.injected(fault_replica=0, replica_crash_at_chunk=1,
                             replica_flaky_bringup=3):
            rs.run_until_idle()
        assert rs.failovers == 1
        assert sink.of("serve_replay_version_hold")
        for h, r in zip(handles, REQS[:2]):
            res = h.result(timeout=10)
            assert res.status == S.OK and res.weights_version == "v1"
            assert [int(t) for t in res.tokens] == reference(bundle, r)

    def test_pin_released_when_generation_leaves_fleet(self, bundle,
                                                       bundle_v2):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         weights_version="v1", metrics=sink, max_depth=32)
        rs.drain_replica(1)
        r1 = rs.replicas[1]
        r1.params_override = bundle_v2[2]
        r1.version = "v2"
        assert rs.undrain_replica(1)
        handles = [q.submit(req(S, r)) for r in REQS[:2]]
        for _ in range(2):
            rs.step_once()
        rs.remove_replica(0, reason="retire the whole v1 generation")
        rs.run_until_idle()
        assert sink.of("serve_replay_version_released")
        for h, r in zip(handles, REQS[:2]):
            res = h.result(timeout=10)
            assert res.status == S.OK and res.weights_version == "v2"
            assert [int(t) for t in res.tokens] == reference(bundle_v2, r)


class TestAutoscaler:
    def test_policy_validation_is_typed(self):
        with pytest.raises(ValueError, match="min_replicas"):
            AutoscalePolicy(min_replicas=0)
        with pytest.raises(ValueError, match="max_replicas"):
            AutoscalePolicy(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="occupancy"):
            AutoscalePolicy(low_occupancy=0.9, high_occupancy=0.8)
        with pytest.raises(TypeError, match="ReplicaSet"):
            Autoscaler(object(), AutoscalePolicy())

    def test_scale_out_in_with_hysteresis_cooldown_and_caps(self, bundle):
        """Idle ticks hold, a sustained burst scales out once, saturation
        at the cap is a typed at_max, sustained idleness scales in to the
        floor; the decision records equal the JAX autoscaler's."""
        from dalle_pytorch_tpu.serve.autoscale import (
            AutoscalePolicy as JAP, Autoscaler as JAS)
        got = {}
        for name, make, smod, pol, scl in (
                ("port", port_set, S, AutoscalePolicy, Autoscaler),
                ("jax", jax_set, JS, JAP, JAS)):
            sink = Sink()
            rs, q = make(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         max_replicas=3, metrics=sink, max_depth=64)
            clock = [0.0]
            scaler = scl(rs, pol(min_replicas=2, max_replicas=3,
                                 high_occupancy=0.75, low_occupancy=0.10,
                                 queue_high=1, breach_ticks=2,
                                 cooldown_s=1.0),
                         metrics=sink, clock=lambda: clock[0])
            quiet = []
            for _ in range(5):
                clock[0] += 10
                quiet.append(scaler.tick())
            handles = [q.submit(smod.Request(codes=(1 + i % 7, 2), seed=i))
                       for i in range(16)]
            ticks = []
            for dt in (10, 0.1, 0.1, 2.0, 0.1):
                clock[0] += dt
                ticks.append(scaler.tick())
            assert rs.n_replicas == 3
            rs.run_until_idle()
            assert all(h.result(timeout=30).status == S.OK
                       for h in handles)
            for dt in (2.0, 0.1):
                clock[0] += dt
                ticks.append(scaler.tick())
            clock[0] += 10
            for _ in range(4):
                clock[0] += 0.1
                quiet.append(scaler.tick())
            assert rs.n_replicas == 2 and rs.replicas[2].state == RETIRED
            assert quiet == [None] * 9
            got[name] = ([None if t is None else t["action"]
                          for t in ticks],
                         sink.of("autoscale_decision"))
        assert got["port"] == got["jax"]
        assert got["port"][0] == [None, "scale_out", None, None, "at_max",
                                  None, "scale_in"]


class TestDrainHolHandoff:
    def test_drain_hands_hol_reservation_back_to_shared_queue(
            self, bundle):
        """Draining a replica whose queue holds a page-deferred request
        hands its head-of-line reservation to the set (the event names
        the exact need) and the request still lands on its tokens."""
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, num_slots=2, chunk_steps=4,
                         kv="paged", page_size=4, num_pages=7,
                         metrics=sink, max_depth=32)
        first = [dict(codes=(1,) * 8, seed=0), dict(codes=(2,) * 8, seed=1)]
        h1 = [q.submit(req(S, r)) for r in first]
        for _ in range(300):
            rs.step_once()
            e0 = rs.replicas[0].engine
            if e0.alloc.free < 2 and e0.active_slots() > 0:
                break
        else:
            raise AssertionError("replica 0 never got page-tight")
        second = [dict(codes=(3,) * 8, seed=2), dict(codes=(4,) * 8,
                                                      seed=3)]
        h2 = [q.submit(req(S, r)) for r in second]
        hol = None
        for _ in range(300):
            rs.step_once()
            e0 = rs.replicas[0].engine
            if e0._hol_rid is not None:
                hol = (e0._hol_rid, e0._hol_need)
                break
        assert hol is not None, "the defer window never produced a HOL"
        rs.drain_replica(0)
        events = sink.of("serve_hol_handoff")
        assert events and events[0]["request_id"] == hol[0] \
            and events[0]["pages_needed"] == hol[1]
        assert rs.hol_handoffs == 1
        rs.run_until_idle()
        assert not rs._hol_handoff
        assert_token_exact(bundle, h1 + h2, first + second)


class TestAdminScaleEndpoint:
    def test_admin_scale_http_auth_ops_and_typed_rejects(self, bundle):
        """``POST /admin/scale``: 401 without the token, 200 for status,
        add, drain, undrain and remove, 409 with the typed record for an
        illegal one, 400 for a body that is no object; the answers equal
        the JAX server's, and the reshaped fleet serves its tokens."""
        import http.client
        import json
        from dalle_pytorch_tpu.serve import server as JSRV
        from dalle_pytorch_tpu_torch.serve import server as SRV
        got = {}
        for name, mod in (("port", SRV), ("jax", JSRV)):
            kw = dict(num_slots=2, queue_depth=16, replicas=2,
                      max_replicas=3, weights_version="v1",
                      admin_token="tok-test", decode_images=False)
            server = (SRV.InferenceServer(bundle[2], None, device="cpu",
                                          **kw) if name == "port" else
                      JSRV.InferenceServer(bundle[0], bundle[1], JCFG,
                                           **kw)).start()
            httpd = mod.make_http_server(server, port=0)
            port = httpd.server_address[1]
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()

            def post(path, body, token=None):
                c = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=60)
                hdrs = {"Content-Type": "application/json"}
                if token:
                    hdrs["Authorization"] = f"Bearer {token}"
                c.request("POST", path, json.dumps(body), hdrs)
                r = c.getresponse()
                return r.status, json.loads(r.read())

            def strip(body):
                body = {k: v for k, v in body.items()
                        if k not in ("time", "flight")}
                for rec in body.get("replicas", []) \
                        if isinstance(body.get("replicas"), list) else []:
                    rec.pop("heartbeat_age_s", None)
                return body

            try:
                answers = [
                    post("/admin/scale", {"op": "status"}),
                    post("/admin/scale", {"op": "status"}, "wrong-token"),
                    post("/admin/scale", {"op": "status"}, "tok-test"),
                    post("/admin/scale", {"op": "add"}, "tok-test"),
                    post("/admin/scale", {"op": "add"}, "tok-test"),
                    post("/admin/scale", {"op": "drain", "replica": 1},
                         "tok-test"),
                    post("/admin/scale", {"op": "undrain", "replica": 1},
                         "tok-test"),
                    post("/admin/scale", {"op": "remove", "replica": 2},
                         "tok-test"),
                    post("/admin/scale", {"op": "sideways"}, "tok-test"),
                    post("/admin/scale", "not-an-object", "tok-test")]
                code, body = post("/generate", {"codes": [3, 7, 9],
                                                "seed": 11})
                assert code == 200 and body["weights_version"] == "v1"
                assert body["tokens"] == reference(bundle, REQS[0])
                assert server.health()["weights_version"] == "v1"
            finally:
                httpd.shutdown()
                server.close()
            got[name] = [(c, strip(b)) for c, b in answers]
        assert [c for c, _ in got["port"]] == [401, 401, 200, 200, 409,
                                                200, 200, 200, 409, 400]
        # the same answers, but for the 400's error text (each names its
        # own exception)
        assert got["port"][:-1] == got["jax"][:-1]
        assert got["port"][-1][0] == got["jax"][-1][0]


# -- what the port adds or refuses --------------------------------------------


# what each process option needs beside it, and how it shows on the set
PROCESS_OPTIONS = {
    "isolation": ({}, lambda rs: all(r.engine.pid > 0
                                     for r in rs.replicas)),
    "transport": ({"isolation": "process"},
                  lambda rs: rs.stats()["transport"] == "socket"
                  and rs.listener is not None),
    "worker_cmd": ({"isolation": "process", "transport": "socket"},
                   lambda rs: all(r.engine.awaiting_operator
                                  for r in rs.replicas)),
    "attach_token": ({"isolation": "process", "transport": "socket"},
                     lambda rs: rs.listener.token == "t"),
    "child_rss_limit_mb": ({"isolation": "process"},
                           lambda rs: rs.child_rss_limit_mb == 64),
}


@pytest.mark.parametrize("kw,item", [
    ({"isolation": "process"}, "item 2b"),
    ({"transport": "socket"}, "item 2b"),
    ({"worker_cmd": ""}, "item 2b"),
    ({"attach_token": "t"}, "item 2b"),
    ({"child_rss_limit_mb": 64}, "item 2b"),
    ({"devices_per_replica": 2}, "item 3c")],
    ids=lambda x: next(iter(x)) if isinstance(x, dict) else "")
def test_unported_options_are_refused_naming_their_item(bundle, kw, item,
                                                         monkeypatch):
    """(Named for its first version, when process isolation was still to
    come.) The options of ROADMAP.md queue 1 item 2b now reach a process
    set, built on the CPU and closed at once; a mesh (item 3c) builds a
    thread set of mesh slices (over four CPU devices: ``serve_specs
    .visible_devices`` substituted), and an unknown keyword is a
    TypeError."""
    if item == "item 2b":
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        extra, shows = PROCESS_OPTIONS[next(iter(kw))]
        rs, _ = port_set(bundle, replicas=2, num_slots=2, **extra, **kw)
        try:
            assert rs.isolation == "process"
            assert shows(rs)
        finally:
            rs.close(timeout=5.0)
    else:
        from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
        from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
        monkeypatch.setattr(SS, "visible_devices",
                            lambda: [torch.device("cpu")] * 4)
        rs, _ = port_set(bundle, replicas=2, num_slots=2, **kw)
        try:
            assert all(isinstance(r.engine, MeshEngine)
                       and len(r.device) == 2 for r in rs.replicas)
            assert rs.stats()["mesh_shape"] == {"mp": 2}
        finally:
            rs.close(timeout=5.0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        port_set(bundle, replicas=2, num_slot=2)


def test_replicas_up_at_construction_get_the_preview_hook(bundle):
    """The JAX set hands the hook only to engines brought up after it is
    set; the port hands it to the live ones too."""
    rs, _ = port_set(bundle, replicas=2, num_slots=2)
    hook = object()
    rs.on_preview = hook
    assert all(r.engine.on_preview is hook for r in rs.replicas)
    rs.drain_replica(1)
    rs.undrain_replica(1)
    assert rs.replicas[1].engine.on_preview is hook


def test_split_counters_survive_threads_racing_to_grow_them():
    """Replica threads ask K4's split-counter buffer for sizes at once;
    each gets a zeroed buffer at least as large as it asked, and the
    buffer kept is the largest asked for (more threads than cores, a
    short switch interval)."""
    dev = torch.device("cpu")
    PA._COUNTERS.pop(dev, None)
    sizes = list(range(1, 400, 7))
    errors = []
    start = threading.Barrier(16)

    def run(k):
        try:
            start.wait(timeout=30)
            for n in sizes[k % 3::3]:
                buf = PA._counters(dev, n)
                if buf.numel() < n or int(buf.abs().sum()) != 0:
                    errors.append((n, buf.numel()))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and all(not t.is_alive() for t in threads)
    assert PA._COUNTERS[dev].numel() == max(sizes)
    PA._COUNTERS.pop(dev, None)


def test_chip_smoke_schedule_gives_its_prediction_on_the_cpu():
    """``chip_smoke.py``'s replica schedule (crash, drain with live
    migration, rolling upgrade, the promoted version) at a tiny width on
    the CPU: every request the single engine's tokens, and the counters
    and events the smoke holds the card to."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS
    vcfg = TV.VAEConfig(image_size=256, num_tokens=64, codebook_dim=16,
                        num_layers=3, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=16, depth=1, vae=vcfg, num_text_tokens=100,
                         text_seq_len=256, heads=2, dim_head=8)
    v1 = TD.dalle_init(cfg, seed=4, device="cpu")
    v2 = TD.dalle_init(cfg, seed=5, device="cpu")
    run = CS.replica_schedule(v1, v2, "cpu")
    want = {"v1": {w: CS.replica_reference(v1, run["waves"][w], "cpu")
                   for w in ("crash", "drain", "upgrade")},
            "v2": {"v2": CS.replica_reference(v2, run["waves"]["v2"],
                                              "cpu")}}
    CS.check_replica_schedule(run, want)
    assert run["counters"] == CS.REPLICA_EXPECT
