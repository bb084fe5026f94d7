"""The port's process replicas over the socket transport, on the CPU,
against the JAX package's reference tokens.

The network rows of the fault catalog (an RST after half a frame, half a
frame then a FIN, an open socket gone silent) each fence child 1 typed
and replay its work on the survivor with JAX ``generate_images``' tokens,
every token counted once. The set's own SIGKILL rows kill a real child:
the source of a live migration at the transfer (the fallback replays
from the shadow) and a replica as a rolling upgrade drains it. Remote
attach: workers launched by ``worker_cmd`` serve token-exact, and workers
started by hand (``worker_cmd=''``, ``python -m
dalle_pytorch_tpu_torch.serve.worker --connect``) attach, one dies by its
plan's SIGKILL (declared dead off its socket, no PID to ask), and a
replacement started by hand rejoins. Every wait has a deadline; a fixture
kills any child a test leaves.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import transport as T
from dalle_pytorch_tpu_torch.serve.replica import RUNNING, ReplicaSet

pytestmark = pytest.mark.faults

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


def req(r):
    return S.Request(codes=r["codes"], seed=r["seed"],
                     sampling=S.SamplingParams(
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


def reference(b, r) -> list:
    """JAX ``generate_images`` at batch 1 on ``b``'s weights."""
    key = (id(b[0]), r["codes"], r["seed"])
    if key not in _REF:
        _, seq = JD.generate_images(
            b[0], b[1], jnp.asarray([r["codes"]], jnp.int32), cfg=JCFG,
            rng=jax.random.PRNGKey(r["seed"]),
            filter_thres=r.get("filter_thres", 0.5),
            top_p=r.get("top_p", 0.0),
            temperature=r.get("temperature", 1.0), return_img_seq=True)
        _REF[key] = [int(t) for t in np.asarray(seq)[0]]
    return _REF[key]


@pytest.fixture(autouse=True)
def children(monkeypatch):
    """One thread a child, no plan leaking between tests, and no child
    outliving its test."""
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


class Sink:
    def __init__(self):
        self.events = []

    def event(self, **rec):
        self.events.append(rec)

    def of(self, kind):
        return [e for e in self.events if e.get("kind") == kind]


def wait_all_ready(rs, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        rs.step_once()
        if all(r.state == RUNNING and r.engine is not None
               and r.engine.ready for r in rs.replicas):
            return
    raise AssertionError("the children never all reached READY")


def run_until_idle(rs, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if not rs.step_once() and rs.idle():
            return
    raise AssertionError("the set did not go idle")


def run_row(bundle, plan, reqs=REQS, transport="pipe", **set_kw):
    """Construct the set inside ``plan`` (a plan crosses at spawn), serve
    ``reqs``, and hold the row to the zero-loss contract."""
    sink = Sink()
    q = S.RequestQueue(max_depth=16)
    with faults.injected(fault_replica=1, **plan):
        rs = ReplicaSet(bundle[2], q, replicas=2, num_slots=2,
                        chunk_steps=4, isolation="process",
                        transport=transport, device="cpu", metrics=sink,
                        bringup_policy=RetryPolicy(**FAST), **set_kw)
        try:
            wait_all_ready(rs)
            handles = [q.submit(req(r)) for r in reqs]
            t0 = time.perf_counter()
            run_until_idle(rs)
            wall = time.perf_counter() - t0
            assert rs.failovers == 1, sink.of("serve_replica_fenced")
            assert rs.reclaimed >= 1, "the fault stranded no work?"
            for h, r in zip(handles, reqs):
                res = h.result(timeout=0)
                assert res.status == S.OK, (res.status, res.reason)
                assert [int(t) for t in res.tokens] == reference(bundle, r)
            stats = rs.stats()
            assert stats["completed"] == len(reqs)
            assert stats["tokens_decoded"] == sum(
                TCFG.seq_len - len(r["codes"]) for r in reqs), \
                "a replayed request was counted twice (or not at all)"
            # the replica comes back through the circuit breaker
            assert rs.replicas[1].bringups >= 2
            assert rs.replicas[1].state == RUNNING and rs.alive()
            fenced = sink.of("serve_replica_fenced")
            return rs.replicas[1].last_exit, fenced, wall
        finally:
            rs.close()


@pytest.mark.parametrize("plan,reason_has", [
    ({"replica_conn_reset_at_chunk": 2}, "mid-frame"),
    ({"replica_torn_frame_at_chunk": 2}, "protocol error"),
    ({"replica_stall_socket_at_chunk": 1, "replica_hang_s": 20.0},
     "heartbeat"),
], ids=["reset", "torn", "stall"])
def test_socket_rows_fence_typed(bundle, plan, reason_has):
    """The rows only a stream shows: an RST after half a frame, half a
    frame then a FIN (inside the ipc header), an open socket gone
    silent. Each is a typed fence and a replay, never a hang."""
    kw = {"heartbeat_s": 2.0} if "replica_stall_socket_at_chunk" in plan \
        else {}
    _, fenced, wall = run_row(bundle, plan, transport="socket", **kw)
    assert len(fenced) == 1
    assert reason_has in fenced[0]["reason"], fenced[0]["reason"]
    assert wall < 20.0




def wait_inflight(rs, index, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        rs.step_once()
        c = rs.replicas[index].engine
        if c is not None and any(not h.done() for h in c.shadow.values()):
            return
    raise AssertionError(f"no work in flight on replica {index}")


def test_source_killed_at_the_transfer_falls_back_to_replay(bundle):
    """The migration source's child is SIGKILLed as its snapshot is asked
    for: the export finds a corpse ('source_dead'), everything it held
    replays from the shadow with JAX's tokens."""
    sink = Sink()
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(bundle[2], q, replicas=2, num_slots=2, chunk_steps=4,
                    kv="paged", page_size=4, isolation="process",
                    device="cpu", metrics=sink,
                    bringup_policy=RetryPolicy(**FAST))
    try:
        wait_all_ready(rs)
        handles = [q.submit(req(r)) for r in REQS]
        wait_inflight(rs, 0)
        with faults.injected(migrate_crash_source_at_transfer=0):
            rs.remove_replica(0, drain=True)
        assert rs.migrations == 0 and rs.migrate_fallbacks >= 1
        assert sink.of("serve_migrate_fallback")[0]["reason"] == \
            "source_dead"
        assert "killed by SIGKILL" in rs.replicas[0].last_exit
        run_until_idle(rs)
        for h, r in zip(handles, REQS):
            assert [int(t) for t in h.result(0).tokens] == \
                reference(bundle, r)
        assert rs.stats()["completed"] == len(REQS)
    finally:
        rs.close()


def test_replica_killed_as_the_upgrade_drains_it(bundle):
    """A real SIGKILL of replica 0's child just as the rolling upgrade
    starts its drain: the upgrade reclaims from the shadow, loses
    nothing, and completes; the fleet serves the new version."""
    dal2 = jax.device_get(JD.dalle_init(jax.random.PRNGKey(42), JCFG,
                                        bundle[1]))
    v2 = from_jax.dalle_from_jax(dal2, TCFG, device="cpu")
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(bundle[2], q, replicas=2, num_slots=2, chunk_steps=4,
                    isolation="process", device="cpu",
                    weights_version="v1",
                    bringup_policy=RetryPolicy(**FAST))
    try:
        wait_all_ready(rs)
        handles = [q.submit(req(r)) for r in REQS]
        wait_inflight(rs, 0)
        with faults.injected(upgrade_drain_sigkill_replica=0):
            record = rs.rolling_upgrade(version="v2", params=v2,
                                        canaries=1, replica_timeout_s=60.0)
        assert [x["replica"] for x in record["replicas"]] == [0, 1]
        run_until_idle(rs)
        for h, r in zip(handles, REQS):
            res = h.result(0)
            assert res.status == S.OK
            want = reference(bundle, r) if res.weights_version == "v1" \
                else reference((dal2, bundle[1], v2), r)
            assert [int(t) for t in res.tokens] == want
        assert rs.weights_version == "v2" and rs.upgrades == 1
        assert rs.stats()["completed"] == len(REQS) + 2     # + canaries
    finally:
        rs.close()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve.worker"]


def worker_env(token=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    if token is not None:
        env[T.TOKEN_ENV] = token
    return env


def test_worker_cmd_launched_workers_serve_token_exact(bundle, monkeypatch):
    """``worker_cmd`` starts each replica's worker (the token through
    ``{token}``); the set serves JAX's tokens with the socket fields in
    ``stats()``."""
    monkeypatch.setenv("PYTHONPATH", worker_env()["PYTHONPATH"])
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(bundle[2], q, replicas=2, num_slots=2, chunk_steps=4,
                    isolation="process", transport="socket", device="cpu",
                    worker_cmd=" ".join(WORKER) + " --connect {endpoint} "
                                                  "--index {index} "
                                                  "--token {token}",
                    bringup_policy=RetryPolicy(**FAST))
    try:
        # both workers attach before any work (a loaded host may take
        # longer to start one than the other takes to serve all of it)
        wait_all_ready(rs)
        handles = [q.submit(req(r)) for r in REQS]
        run_until_idle(rs)
        for h, r in zip(handles, REQS):
            assert [int(t) for t in h.result(0).tokens] == \
                reference(bundle, r)
        stats = rs.stats()
        assert stats["transport"] == "socket"
        assert stats["attach_rejected"] == 0
        assert stats["attach_expected"] == []
        for p in stats["per_replica"]:
            assert p["transport"] == "socket" and ":" in p["peer"]
            assert p["pid"] > 0 and p["last_frame_age_s"] >= 0.0
    finally:
        rs.close()


def test_hand_started_workers_attach_die_and_are_replaced(bundle):
    """``worker_cmd=''``: the set spawns nothing; two workers started by
    hand attach and serve; the plan (riding the spec over the socket)
    SIGKILLs worker 1 mid-decode, the parent declares it dead off the
    socket and replays its work with JAX's tokens; a replacement started
    by hand attaches to the slot and serves."""
    q = S.RequestQueue(max_depth=16)
    procs = []
    with faults.injected(fault_replica=1, replica_sigkill_at_chunk=2):
        rs = ReplicaSet(bundle[2], q, replicas=2, num_slots=2,
                        chunk_steps=4, isolation="process",
                        transport="socket", worker_cmd="", device="cpu",
                        bringup_policy=RetryPolicy(**FAST))
        try:
            assert rs.stats()["attach_expected"] == [0, 1]

            def start(index):
                procs.append(subprocess.Popen(
                    WORKER + ["--connect", rs.listener.endpoint,
                              "--index", str(index)],
                    env=worker_env(rs.listener.token)))
            start(0)
            start(1)
            wait_all_ready(rs)      # both get work, the victim included
            handles = [q.submit(req(r)) for r in REQS]
            deadline = time.perf_counter() + WAIT_S
            while time.perf_counter() < deadline and not (
                    rs.failovers >= 1 and all(h.done() for h in handles)):
                rs.step_once()
            assert rs.failovers == 1, "the worker's death was never fenced"
            for h, r in zip(handles, REQS):
                assert [int(t) for t in h.result(0).tokens] == \
                    reference(bundle, r)
            assert "remote worker" in rs.replicas[1].last_exit
            assert procs[1].wait(30) == -9
            deadline = time.perf_counter() + WAIT_S
            while time.perf_counter() < deadline:
                rs.step_once()
                r1 = rs.replicas[1]
                if r1.state == RUNNING and r1.engine.awaiting_operator:
                    break
            assert rs.stats()["attach_expected"] == [1]
            start(1)
            h = q.submit(req(REQS[0]))
            deadline = time.perf_counter() + WAIT_S
            while time.perf_counter() < deadline and not (
                    h.done() and rs.replicas[1].engine.ready):
                rs.step_once()
            assert h.result(0).status == S.OK
            assert rs.replicas[1].engine.ready
            assert rs.replica_states()[1]["reconnects"] == 1
        finally:
            rs.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
