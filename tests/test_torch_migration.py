"""Live slot migration (``Engine.export_slot`` / ``import_slot``) and the
replica set's use of it, on the CPU, against the JAX package.

The thread cases of JAX's ``tests/test_migration.py``: a request moved
MID-STREAM between engines keeps the tokens it decoded, and the tokens
it emits on the target equal the undisturbed run's (JAX's
``generate_images`` at batch 1, same weights): across K in {1, 8}, the
gather and kernel reads and float32 and int8 KV, and for a guided pair,
whose two slots move in one payload. The payload has JAX's keys, and its
decode state (position, current token, key, knobs, emitted tokens, the
page contents) equals the JAX engine's export at the same point. Every
typed ``MigrationError`` leaves both engines as they were, and a torn
snapshot is discarded whole. Then the set: a drain and a scale-in
migrate in flight (counters, events, the flight ring's span), a
replay-only scale-in migrates nothing, replica roles (validation, the
prefill -> decode handoff), a rolling upgrade migrating to same-version
survivors, and the two fault rows falling back to replay with zero loss
(a target that refuses, a source that dies at the transfer — a thread
replica cannot be killed, so the hook raises and the supervisor takes
the same fallback).
"""

import copy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import engine as JE
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine, MigrationError
from dalle_pytorch_tpu_torch.serve.replica import (DRAINED, ReplicaSet,
                                                   ScaleError)

# 64 image tokens (total_len 72): an export at >= 8 emitted tokens never
# races the pipeline's chunks in flight past completion
VK = dict(image_size=32, num_tokens=32, codebook_dim=16, num_layers=2,
          hidden_dim=8)
DK = dict(dim=16, depth=2, num_text_tokens=50, text_seq_len=8, heads=2,
          dim_head=8)
JCFG = JD.DALLEConfig(vae=JV.VAEConfig(**VK), **DK)
TCFG = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **DK)
FAST = RetryPolicy(max_attempts=1, deadline_s=None, base_backoff_s=0.01,
                   backoff_multiplier=2.0, max_backoff_s=0.1, jitter=0.0)

REQS = [
    S.Request(codes=(3, 7, 9), seed=11),
    S.Request(codes=(5, 2, 8, 1, 4), seed=23,
              sampling=S.SamplingParams(temperature=0.7, filter_thres=0.8)),
]
# the payload's keys (JAX ``serve/engine.py:2197-2214``)
PAYLOAD_KEYS = {"format", "request_id", "handle", "emitted", "t0",
                "weights_version", "page_size", "quantized", "cond",
                "uncond"}
ROW_KEYS = {"pos", "cur_tok", "rng", "temp", "topk_k", "top_p", "pages"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_leaked_plan():
    faults.deactivate()
    yield
    faults.deactivate()


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1),
                                       JCFG.vae))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, vae_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


_REF: dict = {}


def reference(b, r, quantize_cache=False) -> list:
    dal_p, vae_p, _ = b
    key = (id(dal_p), r.codes, r.seed, r.sampling, r.cfg_scale,
           quantize_cache)
    if key not in _REF:
        _, seq = JD.generate_images(
            dal_p, vae_p, jnp.asarray([r.codes], jnp.int32), cfg=JCFG,
            rng=jax.random.PRNGKey(r.seed),
            filter_thres=r.sampling.filter_thres, top_p=r.sampling.top_p,
            temperature=r.sampling.temperature, guidance=r.cfg_scale,
            quantize_cache=quantize_cache, return_img_seq=True)
        _REF[key] = [int(t) for t in np.asarray(seq)[0]]
    return _REF[key]


def assert_token_exact(b, handles, reqs):
    for h, r in zip(handles, reqs):
        res = h.result(timeout=30)
        assert res.status == S.OK, (res.status, res.reason)
        assert [int(t) for t in res.tokens] == reference(b, r)


class Sink:
    def __init__(self):
        self.events = []

    def event(self, **rec):
        self.events.append(rec)

    def of(self, kind):
        return [e for e in self.events if e.get("kind") == kind]


def engine(b, model=None, **kw):
    return Engine(model or b[2], S.RequestQueue(max_depth=4), device="cpu",
                  **kw)


def decode_to(eng, rid, min_tokens, handle):
    """Step until ``rid`` has emitted ``min_tokens`` and is still
    mid-stream."""
    for _ in range(10_000):
        eng.step_once()
        assert not handle.done(), "finished before the export window"
        if eng.progress_snapshot().get(rid, 0) >= min_tokens:
            return
    raise AssertionError("never reached the export window")


def pump_until(stepper, pred, what, limit=10_000):
    for _ in range(limit):
        stepper.step_once()
        if pred():
            return
    raise AssertionError(f"timed out waiting for {what}")


def mid_stream_on(rs, index, tokens=2):
    return any(v >= tokens for v in
               rs.replicas[index].engine.progress_snapshot().values())


# -- engine-level export / import ---------------------------------------------


class TestExportImportByteIdentity:
    @pytest.mark.parametrize("quantize_cache", [False, True],
                             ids=["fp32", "int8kv"])
    @pytest.mark.parametrize("paged_attn,page_size",
                             [("gather", 4), ("kernel", 8)],
                             ids=["gather", "kernel"])
    @pytest.mark.parametrize("chunk_steps", [1, 8], ids=["K1", "K8"])
    def test_matrix_token_exact(self, bundle, chunk_steps, paged_attn,
                                page_size, quantize_cache):
        kw = dict(num_slots=2, chunk_steps=chunk_steps, kv="paged",
                  page_size=page_size, paged_attn=paged_attn,
                  quantize_cache=quantize_cache)
        src, dst = engine(bundle, **kw), engine(bundle, **kw)
        h = src.queue.submit(REQS[0])
        rid = h.request.request_id
        decode_to(src, rid, 8, h)
        payload, handle = src.export_request(rid)
        assert handle is h and len(payload["emitted"]) >= 8
        assert src.find_slot(rid) is None and src.active_slots() == 0
        dst.import_slot(payload, handle)
        dst.run_until_idle()
        res = h.result(timeout=30)
        assert res.status == S.OK
        assert [int(t) for t in res.tokens] == reference(
            bundle, REQS[0], quantize_cache)
        assert src.alloc.in_use == 0 and dst.alloc.in_use == 0

    def test_cfg_pair_migrates_atomically(self, bundle):
        req = S.Request(codes=(3, 7, 9), seed=11, cfg_scale=2.0)
        kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
        src, dst = engine(bundle, **kw), engine(bundle, **kw)
        h = src.queue.submit(req)
        rid = h.request.request_id
        decode_to(src, rid, 8, h)
        payload, handle = src.export_request(rid)
        assert payload["uncond"] is not None
        assert payload["uncond"]["cfg_scale"] == pytest.approx(2.0)
        assert src.active_slots() == 0
        dst.import_slot(payload, handle)
        dst.run_until_idle()
        assert [int(t) for t in h.result(timeout=30).tokens] == \
            reference(bundle, req)

    def test_payload_equals_the_jax_engines_export(self, bundle):
        """Both engines decode the same request the same number of steps
        and export: the same keys, decode state and emitted tokens, the
        same page contents (float32, to 1e-5)."""
        kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
        port = engine(bundle, **kw)
        jeng = JE.Engine(bundle[0], JCFG, JS.RequestQueue(max_depth=4),
                         **kw)
        jreq = JS.Request(codes=REQS[0].codes, seed=REQS[0].seed)
        hp = port.queue.submit(REQS[0])
        hj = jeng.queue.submit(jreq)
        for _ in range(4):
            port.step_once()
            jeng.step_once()
        got, _ = port.export_request(hp.request.request_id)
        want, _ = jeng.export_request(hj.request.request_id)
        assert set(got) == set(want) == PAYLOAD_KEYS
        assert set(got["cond"]) == set(want["cond"]) == ROW_KEYS
        assert set(got["handle"]) == set(want["handle"])
        for k in ("format", "request_id", "emitted", "t0",
                  "weights_version", "page_size", "quantized", "uncond"):
            assert got[k] == want[k], k
        for k in ("pos", "cur_tok", "rng", "topk_k"):
            assert got["cond"][k] == want["cond"][k], k
        for k in ("temp", "top_p"):
            assert got["cond"][k] == pytest.approx(want["cond"][k])
        from dalle_pytorch_tpu_torch.serve.engine import _unpack_array
        assert len(got["cond"]["pages"]) == len(want["cond"]["pages"])
        for gp, wp in zip(got["cond"]["pages"], want["cond"]["pages"]):
            assert set(gp) == set(wp)
            for k in gp:
                assert gp[k]["dtype"] == wp[k]["dtype"]
                np.testing.assert_allclose(
                    _unpack_array(gp[k]).numpy(),
                    np.frombuffer(__import__("base64").b64decode(
                        wp[k]["data"]), np.dtype(wp[k]["dtype"])).reshape(
                        wp[k]["shape"]), rtol=1e-5, atol=1e-5)


class TestMigrationPreconditions:
    def test_dense_kv_export_is_typed(self, bundle):
        eng = engine(bundle, num_slots=2, chunk_steps=4)
        h = eng.queue.submit(REQS[0])
        rid = h.request.request_id
        pump_until(eng, lambda: eng.find_slot(rid) is not None, "admit")
        with pytest.raises(MigrationError) as ei:
            eng.export_request(rid)
        assert ei.value.reason == "kv_dense"

    def test_unknown_request_is_typed(self, bundle):
        eng = engine(bundle, num_slots=2, chunk_steps=4, kv="paged",
                     page_size=4)
        with pytest.raises(MigrationError) as ei:
            eng.export_request(999_999)
        assert ei.value.reason == "not_found"

    def test_import_mismatches_are_typed_and_leave_target_idle(
            self, bundle):
        src = engine(bundle, num_slots=2, chunk_steps=4, kv="paged",
                     page_size=4, weights_version="v1")
        h = src.queue.submit(REQS[0])
        decode_to(src, h.request.request_id, 4, h)
        payload, _ = src.export_request(h.request.request_id)
        for reason, kw in [
                ("page_size", dict(page_size=8)),
                ("layout", dict(page_size=4, quantize_cache=True)),
                ("weights_version", dict(page_size=4,
                                         weights_version="v2"))]:
            dst = engine(bundle, num_slots=2, chunk_steps=4, kv="paged",
                         weights_version=kw.pop("weights_version", "v1"),
                         **kw)
            free0 = dst.alloc.free
            with pytest.raises(MigrationError) as ei:
                dst.import_slot(copy.deepcopy(payload))
            assert ei.value.reason == reason
            assert dst.active_slots() == 0 and dst.alloc.free == free0

    def test_full_target_is_typed(self, bundle):
        src = engine(bundle, num_slots=2, chunk_steps=4, kv="paged",
                     page_size=4)
        h = src.queue.submit(REQS[0])
        decode_to(src, h.request.request_id, 4, h)
        payload, _ = src.export_request(h.request.request_id)
        dst = engine(bundle, num_slots=1, chunk_steps=4, kv="paged",
                     page_size=4)
        own = dst.queue.submit(REQS[1])
        pump_until(dst, lambda: dst.find_slot(own.request.request_id)
                   is not None, "target admission")
        with pytest.raises(MigrationError) as ei:
            dst.import_slot(copy.deepcopy(payload))
        assert ei.value.reason == "target_slots"

    def test_fenced_engines_refuse_both_ways(self, bundle):
        kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
        src, dst = engine(bundle, **kw), engine(bundle, **kw)
        h = src.queue.submit(REQS[0])
        decode_to(src, h.request.request_id, 4, h)
        payload, _ = src.export_request(h.request.request_id)
        dst.fence()
        with pytest.raises(MigrationError) as ei:
            dst.import_slot(payload)
        assert ei.value.reason == "fenced"
        src.fence()
        with pytest.raises(MigrationError) as ei:
            src.export_slot(0)
        assert ei.value.reason == "fenced"

    def test_corrupt_snapshot_discarded_whole_then_intact_lands(
            self, bundle):
        kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
        src, dst = engine(bundle, **kw), engine(bundle, **kw)
        h = src.queue.submit(REQS[0])
        rid = h.request.request_id
        decode_to(src, rid, 8, h)
        payload, handle = src.export_request(rid)
        torn = copy.deepcopy(payload)
        page0 = torn["cond"]["pages"][0]
        first = next(iter(page0))
        page0[first]["data"] = page0[first]["data"][
            :len(page0[first]["data"]) // 2]
        free0 = dst.alloc.free
        with pytest.raises(MigrationError) as ei:
            dst.import_slot(torn, handle)
        assert ei.value.reason == "transfer"
        assert dst.active_slots() == 0 and dst.alloc.free == free0
        dst.import_slot(payload, handle)
        dst.run_until_idle()
        assert [int(t) for t in h.result(timeout=30).tokens] == \
            reference(bundle, REQS[0])

    def test_wire_form_round_trips_a_handle(self):
        """The payload's ``handle``: a request's wire form and back, the
        arrival position and the trace identity kept."""
        q = S.RequestQueue(max_depth=4)
        req = S.Request(codes=(1, 2, 3), seed=9, cfg_scale=1.5,
                        deadline_s=10.0, image_seq_len_override=5,
                        sampling=S.SamplingParams(temperature=0.5,
                                                  top_p=0.3))
        h = q.submit(req)
        wire = h.to_wire(h.request.submit_t + 4.0)
        back = S.RequestHandle.from_wire(wire, 100.0)
        assert back.queue_seq == h.queue_seq
        assert back.trace.trace_id == h.trace.trace_id
        r = back.request
        assert (r.codes, r.seed, r.cfg_scale, r.image_seq_len_override,
                r.sampling, r.request_id) == (
            req.codes, 9, 1.5, 5, req.sampling, h.request.request_id)
        assert r.deadline_s == pytest.approx(6.0) and r.submit_t == 100.0
        jreq = JS.Request(codes=(1, 2, 3), seed=9, cfg_scale=1.5,
                          deadline_s=10.0, image_seq_len_override=5,
                          sampling=JS.SamplingParams(temperature=0.5,
                                                     top_p=0.3),
                          request_id=h.request.request_id,
                          submit_t=h.request.submit_t)
        assert h.request.to_wire(h.request.submit_t + 4.0) == \
            jreq.to_wire(jreq.submit_t + 4.0)


# -- the replica set ----------------------------------------------------------


def port_set(b, **kw):
    queue = S.RequestQueue(max_depth=16)
    kw.setdefault("bringup_policy", FAST)
    return ReplicaSet(b[2], queue, device="cpu", num_slots=2,
                      chunk_steps=4, **kw), queue


class TestSetMigration:
    def test_drain_migrates_in_flight_mid_stream(self, bundle):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         metrics=sink)
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        assert rs.drain_replica(0) >= 1
        assert rs.replicas[0].state == DRAINED
        assert rs.migrations >= 1 and rs.migrated_tokens_saved >= 2
        assert rs.migrate_fallbacks == 0
        migrated = sink.of("serve_migrated")
        assert migrated and migrated[0]["src"] == 0
        assert migrated[0]["tokens_saved"] >= 2
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)
        stats = rs.stats()
        assert stats["migrations"] >= 1
        assert all("role" in rec for rec in stats["per_replica"])
        assert stats["tokens_decoded"] == sum(
            TCFG.seq_len - len(r.codes) for r in REQS)

    def test_scale_in_migrates_and_records_flight_span(self, bundle):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         metrics=sink)
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        rs.remove_replica(0, drain=True)
        scale_in = sink.of("serve_scale_in")
        assert scale_in and scale_in[0]["migrated"] >= 1
        assert any(e.get("kind") == "serve_migrated"
                   for e in rs.flight.tail(64))
        assert any(e.get("span") == "migrate" for e in rs.flight.dump())
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)

    def test_replay_only_scale_in_skips_migration(self, bundle):
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4)
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        rs.remove_replica(0, drain=False)
        assert rs.migrations == 0
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)


class TestReplicaRoles:
    def test_role_validation_is_typed(self, bundle):
        with pytest.raises(ValueError, match="role"):
            port_set(bundle, replicas=2, kv="paged", page_size=4,
                     roles=("prefill", "bogus"))
        with pytest.raises(ValueError, match="roles names"):
            port_set(bundle, replicas=2, kv="paged", page_size=4,
                     roles=("prefill",))
        with pytest.raises(ValueError, match="paged"):
            port_set(bundle, replicas=2, roles=("prefill", "decode"))

    def test_add_replica_role_rejections_are_typed(self, bundle):
        rs, _ = port_set(bundle, replicas=1)
        with pytest.raises(ScaleError) as ei:
            rs.add_replica(role="bogus")
        assert ei.value.record["reason"] == "unknown_role"
        with pytest.raises(ScaleError) as ei:
            rs.add_replica(role="decode")
        assert ei.value.record["reason"] == "roles_need_paged_kv"

    def test_prefill_to_decode_handoff(self, bundle):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         roles=("prefill", "decode"), metrics=sink)
        handles = [q.submit(r) for r in REQS]
        deadline = time.perf_counter() + 120
        while rs.migrations < 1:
            assert time.perf_counter() < deadline, "no handoff"
            rs.step_once()
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)
        moved = sink.of("serve_migrated")
        assert moved and all(e["reason"] == "prefill_handoff"
                             and e["dst"] == 1 for e in moved)
        assert rs.replicas[1].engine.completed >= 1
        assert [rec["role"] for rec in rs.stats()["per_replica"]] == [
            "prefill", "decode"]


class TestUpgradeMigration:
    def test_rolling_upgrade_drain_migrates_version_pinned(self, bundle):
        dal2 = jax.device_get(JD.dalle_init(jax.random.PRNGKey(42), JCFG,
                                            bundle[1]))
        b2 = (dal2, bundle[1], from_jax.dalle_from_jax(dal2, TCFG,
                                                       device="cpu"))
        by_version = {"v1": bundle, "v2": b2}
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         weights_version="v1")
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        record = rs.rolling_upgrade(version="v2", params=b2[2],
                                    canary_codes=[(1, 2)], canaries=1,
                                    replica_timeout_s=120.0)
        assert sum(int(e.get("migrated", 0))
                   for e in record["replicas"]) >= 1
        assert rs.migrations >= 1
        rs.run_until_idle()
        for h, r in zip(handles, REQS):
            res = h.result(timeout=30)
            assert res.status == S.OK
            assert [int(t) for t in res.tokens] == reference(
                by_version[res.weights_version], r)


class TestMigrationFaults:
    pytestmark = pytest.mark.faults

    def test_target_reject_falls_back_to_replay(self, bundle):
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         metrics=sink)
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        with faults.injected(migrate_reject_target=1):
            rs.drain_replica(0)
        assert rs.migrations == 0 and rs.migrate_fallbacks >= 1
        fb = sink.of("serve_migrate_fallback")
        assert fb and fb[0]["reason"] == "target_pages"
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)
        stats = rs.stats()
        assert stats["completed"] == 2
        assert stats["tokens_decoded"] == sum(
            TCFG.seq_len - len(r.codes) for r in REQS)

    def test_crash_source_mid_transfer_falls_back(self, bundle):
        """The source 'dies' at the transfer point (on a thread replica
        the hook raises): the fallback is the fence's replay, zero loss,
        the same tokens."""
        sink = Sink()
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         metrics=sink)
        handles = [q.submit(r) for r in REQS]
        pump_until(rs, lambda: mid_stream_on(rs, 0), "work on replica 0")
        with faults.injected(migrate_crash_source_at_transfer=0):
            rs.remove_replica(0, drain=True)
        assert rs.migrations == 0 and rs.migrate_fallbacks >= 1
        fb = sink.of("serve_migrate_fallback")
        assert fb and fb[0]["reason"] == "source_dead"
        rs.run_until_idle()
        assert_token_exact(bundle, handles, REQS)
        assert rs.stats()["completed"] == len(REQS)

    def test_upgrade_drain_sigkill_needs_a_process(self, bundle):
        """The SIGKILL-at-drain row needs a child process: on a thread
        set it raises rather than pass vacuously (as JAX's hook does),
        and the fleet is left whole."""
        dal2 = jax.device_get(JD.dalle_init(jax.random.PRNGKey(42), JCFG,
                                            bundle[1]))
        rs, q = port_set(bundle, replicas=2, kv="paged", page_size=4,
                         weights_version="v1")
        with faults.injected(upgrade_drain_sigkill_replica=0):
            with pytest.raises(faults.FaultInjected, match="process"):
                rs.rolling_upgrade(
                    version="v2",
                    params=from_jax.dalle_from_jax(dal2, TCFG,
                                                   device="cpu"),
                    canaries=1, replica_timeout_s=60.0)
        assert not rs._upgrading and rs.weights_version == "v1"
        h = q.submit(REQS[0])
        rs.run_until_idle()
        assert [int(t) for t in h.result(timeout=30).tokens] == \
            reference(bundle, REQS[0])
