"""The port's process replicas (``serve/replica.py`` with
``isolation='process'``, ``serve/ipc.py``, ``serve/worker.py``) on the
CPU, against the JAX package.

* a set of two child workers serves JAX ``generate_images``' tokens and
  the port's single engine's on the same requests, and its counters, and
  its ``/healthz`` fields, are the JAX process set's on the same
  schedule; drain and undrain give a fresh process;
* checkpoint-path workers (``worker_ckpt``, ``transport='socket'``) load
  a checkpoint written by the JAX package, through the port's
  ``checkpoint.py`` and ``compat/from_jax.py``, and serve JAX's tokens; a
  rolling upgrade with ``ckpt=`` moves the fleet to a second JAX
  checkpoint, canary-gated, and the new requests get its tokens;
* a drain live-migrates a request mid-stream from one child to the other
  (MIGRATE_OUT, MIGRATE_IN, MIGRATE_ACK), and it finishes with the single
  engine's tokens, the saved tokens counted;
* the server over process replicas: ``/healthz`` and ``/stats`` carry each
  child's pid, RSS, restarts, transport block and K4 launches; a stream
  and an in-server profile are typed refusals; one replica is refused;
* the worker's exit codes: 3 when its parent's end closes, 4 when the
  HELLO is refused, 5 for a checkpoint that is not there (a bring-up
  failure the set reports), and 1 with a CRASH frame when its spec asks
  for the card where none is visible (it never serves from the CPU).

Children run on the CPU with one thread each; every wait has a deadline;
a fixture kills any child a test leaves.
"""

import json
import multiprocessing as mp
import pickle
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import checkpoint as JCK
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.resilience.retry import RetryPolicy as JRetry
from dalle_pytorch_tpu.serve import replica as JR
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import ipc
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T
from dalle_pytorch_tpu_torch.serve import worker as W
from dalle_pytorch_tpu_torch.serve.autoscale import (AutoscalePolicy,
                                                     Autoscaler)
from dalle_pytorch_tpu_torch.serve.engine import Engine, ProfileError
from dalle_pytorch_tpu_torch.serve.replica import (DRAINED, RUNNING,
                                                   ReplicaSet)

VK = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
          hidden_dim=8)
DK = dict(dim=16, depth=2, num_text_tokens=50, text_seq_len=8, heads=2,
          dim_head=8)
JCFG = JD.DALLEConfig(vae=JV.VAEConfig(**VK), **DK)
TCFG = TD.DALLEConfig(vae=TV.VAEConfig(**VK), **DK)
FAST = dict(max_attempts=1, deadline_s=None, base_backoff_s=0.01,
            backoff_multiplier=2.0, max_backoff_s=0.1, jitter=0.0)
REQS = [dict(codes=(3, 7, 9), seed=11),
        dict(codes=(5, 2, 8, 1, 4), seed=23, temperature=0.7,
             filter_thres=0.8),
        dict(codes=(6, 6), seed=5, temperature=1.3, top_p=0.9),
        dict(codes=(2, 4, 4), seed=7)]
WAIT_S = 120.0
SET_COUNTERS = ("completed", "tokens_decoded", "failovers", "reclaimed",
                "bringup_failures", "evicted", "requeued", "migrations",
                "migrate_fallbacks", "scale_outs", "scale_ins", "upgrades",
                "expired", "alive_replicas", "replicas", "isolation",
                "transport")


def req(mod, r):
    return mod.Request(codes=r["codes"], seed=r["seed"],
                       sampling=mod.SamplingParams(
                           temperature=r.get("temperature", 1.0),
                           filter_thres=r.get("filter_thres", 0.5),
                           top_p=r.get("top_p", 0.0)))


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1),
                                       JCFG.vae))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, vae_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


_REF: dict = {}


def reference(dal_p, vae_p, r) -> list:
    """JAX ``generate_images`` at batch 1."""
    key = (id(dal_p), r["codes"], r["seed"])
    if key not in _REF:
        _, seq = JD.generate_images(
            dal_p, vae_p, jnp.asarray([r["codes"]], jnp.int32), cfg=JCFG,
            rng=jax.random.PRNGKey(r["seed"]),
            filter_thres=r.get("filter_thres", 0.5),
            top_p=r.get("top_p", 0.0),
            temperature=r.get("temperature", 1.0), return_img_seq=True)
        _REF[key] = [int(t) for t in np.asarray(seq)[0]]
    return _REF[key]


@pytest.fixture(autouse=True)
def children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.deactivate()
    yield
    faults.deactivate()
    torch.set_num_threads(n)
    for p in mp.active_children():
        p.kill()
        p.join(5)


def drive(rs, pred, what, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        rs.step_once()
        if pred():
            return
    raise AssertionError(f"timed out waiting for {what}")


def all_ready(rs):
    return all(r.state == RUNNING and r.engine is not None
               and getattr(r.engine, "ready", True) for r in rs.replicas
               if r.state != DRAINED)


def run_until_idle(rs, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if not rs.step_once() and rs.idle():
            return
    raise AssertionError("the set did not go idle")


def engine_tokens(model, reqs, **kw) -> list:
    q = S.RequestQueue(max_depth=16)
    eng = Engine(model, q, device="cpu", **kw)
    hs = [q.submit(req(S, r)) for r in reqs]
    eng.run_until_idle()
    return [[int(t) for t in h.result(0).tokens] for h in hs]


# -- tokens and counters against JAX's process set ----------------------------


def test_process_set_equals_jax_process_set_and_single_engine(bundle):
    dal_p, vae_p, model = bundle
    want_engine = engine_tokens(model, REQS, num_slots=2, chunk_steps=4)
    got = {}
    for name in ("port", "jax"):
        if name == "port":
            q = S.RequestQueue(max_depth=16)
            rs = ReplicaSet(model, q, replicas=2, num_slots=2,
                            chunk_steps=4, isolation="process",
                            device="cpu",
                            bringup_policy=RetryPolicy(**FAST))
            smod = S
        else:
            q = JS.RequestQueue(max_depth=16)
            rs = JR.ReplicaSet(dal_p, JCFG, q, replicas=2, num_slots=2,
                               chunk_steps=4, isolation="process",
                               bringup_policy=JRetry(**FAST))
            smod = JS
        try:
            drive(rs, lambda: all_ready(rs), "both children READY")
            handles = [q.submit(req(smod, r)) for r in REQS]
            run_until_idle(rs)
            tokens = [[int(t) for t in h.result(0).tokens]
                      for h in handles]
            stats = rs.stats()
            states = rs.replica_states()
            if name == "port":
                assert tokens == want_engine
                assert stats["paged_decode_launches"] == 0   # no K4 here
                pids = [p["pid"] for p in stats["per_replica"]]
                assert len(set(pids)) == 2 and all(p > 0 for p in pids)
                for p in stats["per_replica"]:
                    assert p["transport"] == "pipe"
                    assert p["peer"] == f"pipe:pid={p['pid']}"
                    assert p["rss_mb"] > 0 and p["reconnects"] == 0
                # drain kills the child; undrain spawns a fresh one
                rs.drain_replica(0)
                assert rs.replicas[0].state == DRAINED
                assert "hard-killed by supervisor (operator drain)" in \
                    rs.replicas[0].last_exit
                assert rs.undrain_replica(0)
                assert rs.replicas[0].engine.pid not in pids
            got[name] = (tokens, {k: stats[k] for k in SET_COUNTERS},
                         [set(s) for s in states])
        finally:
            rs.close()
    (pt, pc, pkeys), (jt, jc, jkeys) = got["port"], got["jax"]
    assert pt == jt == [reference(dal_p, vae_p, r) for r in REQS]
    assert pc == jc
    assert pc["completed"] == 4 and pc["tokens_decoded"] == sum(
        TCFG.seq_len - len(r["codes"]) for r in REQS)
    for p, j in zip(pkeys, jkeys):
        assert j <= p, j - p


# -- checkpoint-path workers and a ckpt= upgrade ------------------------------


def test_worker_ckpt_from_a_jax_checkpoint_and_a_ckpt_upgrade(
        bundle, tmp_path):
    """Workers given a path load the JAX package's checkpoint themselves
    (``latest:`` form) and serve its tokens; ``rolling_upgrade(ckpt=)``
    hands them the second checkpoint, canary-gated."""
    dal_p, vae_p, model = bundle
    dal2 = jax.device_get(JD.dalle_init(jax.random.PRNGKey(42), JCFG,
                                        vae_p))
    JCK.save(str(tmp_path / "toy_dalle-0"), dal_p, config=JCFG,
             kind="dalle")
    v2_path = JCK.save(str(tmp_path / "next_dalle-0"), dal2, config=JCFG,
                       kind="dalle")
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(model, q, replicas=2, num_slots=2, chunk_steps=4,
                    isolation="process", transport="socket", device="cpu",
                    worker_ckpt=f"latest:{tmp_path}:toy_dalle",
                    weights_version="v1",
                    bringup_policy=RetryPolicy(**FAST))
    try:
        with pytest.raises(Exception, match="params_upgrade_on_worker"):
            rs.rolling_upgrade(version="v2", params=model)
        drive(rs, lambda: all_ready(rs), "both workers READY")
        handles = [q.submit(req(S, r)) for r in REQS[:2]]
        run_until_idle(rs)
        for h, r in zip(handles, REQS[:2]):
            res = h.result(0)
            assert res.weights_version == "v1"
            assert [int(t) for t in res.tokens] == \
                reference(dal_p, vae_p, r)
        record = rs.rolling_upgrade(version="v2", ckpt=v2_path,
                                    canaries=1, replica_timeout_s=WAIT_S)
        assert [x["replica"] for x in record["replicas"]] == [0, 1]
        assert rs.worker_ckpt == v2_path and rs.weights_version == "v2"
        handles = [q.submit(req(S, r)) for r in REQS[2:]]
        run_until_idle(rs)
        for h, r in zip(handles, REQS[2:]):
            res = h.result(0)
            assert res.weights_version == "v2"
            assert [int(t) for t in res.tokens] == \
                reference(dal2, vae_p, r)
        assert rs.stats()["upgrades"] == 1
    finally:
        rs.close()


# -- live migration between processes -----------------------------------------

DEEP_VK = dict(VK, image_size=64)       # 256 image tokens a request
DEEP = TD.DALLEConfig(vae=TV.VAEConfig(**DEEP_VK), **DK)


def test_drain_live_migrates_between_processes():
    """A request decoding on child 0 moves to child 1 mid-stream (its
    pages as base64 through the frames) and finishes with the single
    engine's tokens; the tokens it had are counted as saved."""
    model = TD.dalle_init(DEEP, seed=3, device="cpu")
    reqs = [dict(codes=(3, 7, 9), seed=11), dict(codes=(5, 2), seed=23)]
    kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
    want = engine_tokens(model, reqs, **kw)
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(model, q, replicas=2, isolation="process",
                    device="cpu", heartbeat_s=1.0,
                    bringup_policy=RetryPolicy(**FAST), **kw)
    try:
        drive(rs, lambda: all_ready(rs), "both children READY")
        handles = [q.submit(req(S, r)) for r in reqs]
        drive(rs, lambda: any(v >= 32 for v in
                              rs.replicas[0].engine.progress.values()),
              "a request 32 tokens into decode on child 0")
        moved = rs.drain_replica(0)
        assert moved >= 1 and rs.migrations >= 1
        assert rs.migrated_tokens_saved >= 32
        assert rs.migration_seconds and rs.migrate_fallbacks == 0
        run_until_idle(rs)
        assert [[int(t) for t in h.result(0).tokens]
                for h in handles] == want
        stats = rs.stats()
        assert stats["completed"] == 2
        assert stats["tokens_decoded"] == sum(
            DEEP.seq_len - len(r["codes"]) for r in reqs)
    finally:
        rs.close()


def test_autoscaler_reads_a_child_pool_as_it_reads_an_engine_pool():
    """A process replica shows its child's pool through the surface an
    ``Engine`` shows: ``num_pages`` (the pool the child's engine holds)
    and ``pages_free`` (its last frame's); the autoscaler's free-page
    fraction reads it with no branch on isolation."""
    model = TD.dalle_init(DEEP, seed=3, device="cpu")
    kw = dict(num_slots=2, chunk_steps=4, kv="paged", page_size=4)
    pool = Engine(model, S.RequestQueue(max_depth=4), device="cpu", **kw)
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(model, q, replicas=1, isolation="process",
                    device="cpu", heartbeat_s=1.0,
                    bringup_policy=RetryPolicy(**FAST), **kw)
    try:
        drive(rs, lambda: all_ready(rs)
              and rs.replicas[0].engine.pages_free >= 0,
              "the child's first frame")
        e = rs.replicas[0].engine
        assert (e.num_pages, e.pages_free) == (pool.num_pages,
                                               pool.pages_free)
        auto = Autoscaler(rs, AutoscalePolicy())
        assert auto.signals()["page_free_frac"] == round(
            pool.pages_free / pool.num_pages, 4)
        h = q.submit(req(S, REQS[0]))
        drive(rs, lambda: any(v >= 8 for v in e.progress.values()),
              "a request decoding in the child")
        assert 0 <= e.pages_free < pool.pages_free
        assert auto.signals()["page_free_frac"] == round(
            e.pages_free / e.num_pages, 4)
        run_until_idle(rs)
        assert h.result(0).status == "ok"
    finally:
        rs.close()


# -- the server over process replicas -----------------------------------------


def test_server_healthz_and_stats_carry_the_child_fields(bundle):
    from dalle_pytorch_tpu_torch.serve.server import (InferenceServer,
                                                      make_http_server)
    dal_p, vae_p, model = bundle
    vae = from_jax.vae_from_jax(vae_p, TCFG.vae, device="cpu")
    with pytest.raises(ValueError, match="replicas >= 2"):
        InferenceServer(model, vae, replicas=1, isolation="process",
                        decode_images=False, device="cpu")
    with pytest.raises(ValueError, match="requires isolation='process'"):
        InferenceServer(model, vae, replicas=2, transport="socket",
                        decode_images=False, device="cpu")
    srv = InferenceServer(model, vae, num_slots=2, queue_depth=16,
                          replicas=2, isolation="process",
                          decode_images=False, device="cpu",
                          profile_dir="/nonexistent").start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        deadline = time.perf_counter() + WAIT_S
        while not all_ready(srv.engine) and time.perf_counter() < deadline:
            time.sleep(0.05)        # the control thread pumps the READYs
        res = srv.generate(REQS[0]["codes"], seed=REQS[0]["seed"],
                           timeout=WAIT_S)
        assert res.status == S.OK
        assert [int(t) for t in res.tokens] == \
            reference(dal_p, vae_p, REQS[0])
        with pytest.raises(S.InvalidRequest):
            srv.submit((1, 2), stream=True)
        with pytest.raises(ProfileError, match="process_isolation"):
            srv.profile()
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and len(health["replicas"]) == 2
        for rep in health["replicas"]:
            assert rep["alive"] and rep["ready"] and rep["pid"] > 0
            assert rep["restarts"] == 0 and rep["rss_mb"] > 0
            assert rep["transport"] == "pipe"
            assert rep["paged_decode_launches"] == 0
        stats = srv.stats()
        assert stats["isolation"] == "process" and stats["completed"] == 1
        assert {"pid", "rss_mb", "restarts", "peer", "last_frame_age_s",
                "paged_decode_launches"} <= set(stats["per_replica"][0])
        assert 'isolation="process"' in srv.metrics_text()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


# -- the worker's exit codes --------------------------------------------------


def spec_for(model, **kw):
    spec = {"index": 0, "model": ipc.host_model(model), "ckpt_path": None,
            "engine_kwargs": {"num_slots": 2, "chunk_steps": 4},
            "device": "cpu", "heartbeat_interval_s": 0.05,
            "rss_limit_mb": 0, "faults": None, "idle_sleep_s": 0.002}
    spec.update(kw)
    return spec


def frames_until(conn, kind, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if conn.poll(0.1):
            k, payload, _ = ipc.decode_frame(conn.recv_bytes())
            if k == kind:
                return payload
    raise AssertionError(f"no {kind} frame")


def start_pipe_worker(spec):
    """A child on the pipe as ``ChildEngineClient`` starts one: spawned
    with its end of the pipe alone, then the spec down the pipe."""
    ctx = mp.get_context("spawn")
    parent_end, child_end = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=W.worker_main, args=(child_end,), daemon=True)
    proc.start()
    child_end.close()
    if spec is not None:
        ipc._send_spec(parent_end, pickle.dumps(spec))
    return proc, parent_end


@pytest.mark.parametrize("when", ["after_ready", "before_the_spec"])
def test_worker_exits_3_when_its_parent_goes(bundle, when):
    spec = spec_for(bundle[2]) if when == "after_ready" else None
    proc, parent_end = start_pipe_worker(spec)
    if spec is not None:
        assert frames_until(parent_end, ipc.READY)["device"] == "cpu"
    parent_end.close()              # the parent "dies"
    proc.join(30)
    assert proc.exitcode == W.PARENT_GONE_EXIT


def test_worker_asked_for_the_card_without_one_crashes_typed(bundle):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the worker would serve on it")
    proc, parent_end = start_pipe_worker(spec_for(bundle[2], device="cuda"))
    crash = frames_until(parent_end, ipc.CRASH)
    assert "no CUDA device is visible" in crash["error"]
    proc.join(30)
    assert proc.exitcode == 1


def test_worker_with_a_bad_token_exits_4():
    listener = T.WorkerListener("127.0.0.1", 0, handshake_timeout_s=5.0)
    ctx = mp.get_context("spawn")
    proc = ctx.Process(target=W.worker_main_dial,
                       args=("127.0.0.1", listener.port, "not-the-token",
                             0), daemon=True)
    try:
        proc.start()
        proc.join(60)
        assert proc.exitcode == W.REJECTED_EXIT
        assert listener.rejected == 1
    finally:
        listener.close()


def test_missing_worker_checkpoint_is_a_bring_up_failure_exit_5(bundle):
    q = S.RequestQueue(max_depth=4)
    rs = ReplicaSet(bundle[2], q, replicas=1, num_slots=2,
                    isolation="process", transport="socket", device="cpu",
                    worker_ckpt="/nonexistent/toy_dalle-0",
                    bringup_policy=RetryPolicy(**dict(FAST,
                                                      base_backoff_s=30)))
    try:
        drive(rs, lambda: rs.bringup_failures >= 1, "a failed bring-up")
        r = rs.replicas[0]
        assert "invalid checkpoint (exit 5" in r.last_exit, r.last_exit
        assert "worker checkpoint rejected" in r.last_error
    finally:
        rs.close()
