"""The port's process replicas through every child fault row, on the CPU,
against the JAX package's reference tokens.

A ``ReplicaSet(isolation='process')`` of two child workers (``device=
'cpu'``, one thread each) serves a burst while the fault plan kills or
corrupts child 1: a real SIGKILL and SIGSEGV, the RSS watchdog's exit 137,
a Python crash (CRASH frame), a wedge past the heartbeat deadline, a
garbage frame, a duplicated and a reordered frame (pipe), and on the
socket transport a reset mid-frame, a torn frame and a stalled socket.
Each row fences the child once, replays what it held on the survivor
with JAX ``generate_images``' tokens, counts every delivered token once
(``tokens_decoded`` is the distinct total), names the death in
``last_exit`` or the fence event, and brings the replica back. The two
SIGKILL rows of the set itself (the source of a migration killed at the
transfer, a replica killed as a rolling upgrade drains it) kill a real
child here. Every wait has a deadline; a fixture kills any child a test
leaves.
"""

import json
import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.resilience import faults as JF
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
from dalle_pytorch_tpu_torch.serve import scheduler as S
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


@pytest.mark.parametrize("plan,exit_has", [
    ({"replica_sigkill_at_chunk": 2}, "killed by SIGKILL"),
    ({"replica_segv_at_chunk": 2}, "killed by SIGSEGV"),
    ({"replica_crash_at_chunk": 2}, "hard-killed by supervisor (crash"),
], ids=["sigkill", "segv", "crash_frame"])
def test_child_death_fences_and_replays(bundle, plan, exit_has):
    last_exit, fenced, _ = run_row(bundle, plan)
    assert exit_has in last_exit, last_exit
    assert len(fenced) == 1 and fenced[0]["replica"] == 1


def test_rss_watchdog_kill_fences_and_replays(bundle):
    """The injected OOM allocates 64 MiB at a time until the child's RSS
    passes ``child_rss_limit_mb`` and its watchdog exits 137, with no
    goodbye frame."""
    last_exit, _, _ = run_row(bundle, {"replica_oom_at_chunk": 1},
                              child_rss_limit_mb=900)
    assert "oom-killed (exit 137" in last_exit, last_exit


def test_wedged_child_is_fenced_at_the_heartbeat_deadline(bundle):
    """A child alive but silent (a 20 s stall) is hard-killed off the
    heartbeat deadline, and its work replays long before the stall would
    clear."""
    last_exit, fenced, wall = run_row(
        bundle, {"replica_hang_at_chunk": 1, "replica_hang_s": 20.0},
        heartbeat_s=2.0)
    assert wall < 20.0, "completion waited out the stall"
    assert "hard-killed by supervisor" in last_exit
    assert "heartbeat" in last_exit


@pytest.mark.parametrize("plan,reason_has", [
    ({"replica_garbage_frame_at_chunk": 1}, "protocol error"),
    ({"replica_dup_frame_at_chunk": 2}, "duplicate or reordered"),
    ({"replica_reorder_frames_at_chunk": 2}, "gap"),
], ids=["garbage", "duplicate", "reorder"])
def test_lying_stream_is_fenced_not_trusted(bundle, plan, reason_has):
    _, fenced, _ = run_row(bundle, plan)
    assert len(fenced) == 1
    assert reason_has in fenced[0]["reason"], fenced[0]["reason"]


def test_network_row_on_a_pipe_refuses_to_pass_vacuously():
    """A socket-only row inside a pipe worker raises rather than fire
    nothing (the worker's CRASH frame carries the reason)."""
    class Pipe:
        kind = "pipe"

    class Sender:
        seq = 3

    with faults.injected(fault_replica=0, replica_torn_frame_at_chunk=0):
        with pytest.raises(faults.FaultInjected, match="socket"):
            faults.on_worker_chunk(0, 0, transport=Pipe(), sender=Sender())
    with faults.injected(fault_replica=0, replica_oom_at_chunk=0):
        with pytest.raises(faults.FaultInjected, match="RSS limit"):
            faults.on_worker_chunk(0, 0)


def test_child_plan_crosses_once_per_activation():
    with faults.injected(fault_replica=1, replica_sigkill_at_chunk=2):
        assert faults.child_plan_for(0) is None
        plan = faults.child_plan_for(1)
        assert plan["replica_sigkill_at_chunk"] == 2
        assert faults.FaultPlan(**plan).fault_replica == 1
        assert faults.child_plan_for(1) is None     # the restart is clean


def test_fault_plan_env_round_trip():
    """The gateway's rows ride the plan's JSON form (``DALLE_FAULTS``)
    as JAX's do."""
    plan = faults.FaultPlan(gateway_cell_down_at_request=3,
                            tenant_flood="t", tenant_flood_requests=5)
    blob = json.dumps({"gateway_cell_down_at_request": 3,
                       "tenant_flood": "t", "tenant_flood_requests": 5})
    assert faults.FaultPlan(**json.loads(blob)) == plan
    for name in ("gateway_cell_down_at_request", "tenant_flood",
                 "tenant_flood_requests"):
        assert getattr(faults.FaultPlan(), name) == \
            getattr(JF.FaultPlan(), name)


def test_gateway_fault_rows_fire_once():
    with faults.injected(gateway_cell_down_at_request=2):
        assert not faults.on_gateway_dispatch(1)
        assert faults.on_gateway_dispatch(2)
        assert not faults.on_gateway_dispatch(3)   # fire-once
    assert not faults.on_gateway_dispatch(99)      # no plan
    with faults.injected(tenant_flood="abuser", tenant_flood_requests=7):
        assert faults.gateway_flood() == {"tenant": "abuser",
                                          "requests": 7}
        assert faults.gateway_flood() is None      # fire-once
    assert faults.gateway_flood() is None
