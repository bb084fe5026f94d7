"""The port's tenants and weighted-fair queue (``serve/tenancy.py``,
``serve/scheduler.py::WeightedFairQueue``) on the CPU, against JAX's.

Seeded random streams (numpy) drive both packages the same way, every
clock injected: the WFQ's pop order, its virtual tags, ``virtual_time``
and ``finish_tag`` under tenants, weights, costs, priorities, requeues
and deadline reaping; the token buckets' grants and retry-afters; the
tenant table's admissions, throttle records, releases, reloads and
``stats()``. Then the port's own contracts, as JAX's tests state them
(a 2:1 share in image tokens, no debt and no banked credit, the base
queue's order unchanged)."""

import numpy as np
import pytest

from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve import tenancy as JT
from dalle_pytorch_tpu_torch.serve import (TIERS, AuthError, TenantSpec,
                                           TenantTable, TenantThrottled,
                                           TokenBucket, WeightedFairQueue)
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve import tenancy as T

TENANT_NAMES = ("a", "b", "c", "d")


def _strip(record: dict) -> dict:
    return {k: v for k, v in record.items() if k != "time"}


# -- the weighted-fair queue against JAX's --------------------------------------

def _queue_pair(rng, clock):
    weights = {t: float(rng.choice([0.5, 1.0, 2.0, 3.0]))
               for t in TENANT_NAMES}
    costs = {t: float(rng.choice([1.0, 16.0, 64.0, 256.0]))
             for t in TENANT_NAMES}

    def cost_fn(request):
        return costs[request.tenant] * request.n_samples

    kw = dict(max_depth=64, clock=lambda: clock[0],
              weight_of=lambda t: weights[t], cost_fn=cost_fn)
    return JS.WeightedFairQueue(**kw), WeightedFairQueue(**kw)


def _request(mod, rng):
    deadline = None if rng.random() < 0.8 else float(rng.uniform(0.5, 4.0))
    return mod.Request(codes=(int(rng.integers(1, 9)),),
                       tenant=str(rng.choice(TENANT_NAMES)),
                       priority=int(rng.integers(0, 3)),
                       n_samples=int(rng.integers(1, 4)),
                       deadline_s=deadline)


@pytest.mark.parametrize("seed", range(6))
def test_wfq_pops_in_jax_order(seed):
    """Submits, pops (with deadline reaping) and requeues, in a seeded
    random order: the same handles pop, with the same tags."""
    rng = np.random.default_rng(seed)
    clock = [0.0]
    jq, tq = _queue_pair(rng, clock)
    jout, tout = [], []           # popped handles, in pop order
    for _ in range(200):
        op = rng.random()
        clock[0] += float(rng.uniform(0.0, 0.3))
        if op < 0.5:
            req_seed = int(rng.integers(0, 2 ** 31))
            for mod, q in ((JS, jq), (S, tq)):
                try:
                    q.submit(_request(mod, np.random.default_rng(req_seed)))
                except mod.QueueFull:
                    pass
        elif op < 0.85:
            n = int(rng.integers(0, 4))
            jr, jd = jq.pop_ready(n)
            tr, td = tq.pop_ready(n)
            assert [h.request.request_id for h in tr] == \
                [h.request.request_id for h in jr]
            assert sorted(h.request.request_id for h in td) == \
                sorted(h.request.request_id for h in jd)
            jout += jr
            tout += tr
        elif jout:
            k = int(rng.integers(0, len(jout)))
            jq.requeue(jout.pop(k))
            tq.requeue(tout.pop(k))
        assert tq.virtual_time() == jq.virtual_time()
        for t in TENANT_NAMES:
            assert tq.finish_tag(t) == jq.finish_tag(t)
    for jh, th in zip(jout, tout):
        assert (th.vstart, th.vfinish, th.queue_seq) == \
            (jh.vstart, jh.vfinish, jh.queue_seq)
    assert tq.depth() == jq.depth()
    assert (tq.submitted, tq.rejected, tq.requeued) == \
        (jq.submitted, jq.rejected, jq.requeued)


# -- buckets and the tenant table against JAX's -------------------------------

@pytest.mark.parametrize("rate,burst", [(2.0, None), (0.5, None),
                                        (3.0, 7.0), (0.0, None)])
def test_token_bucket_matches_jax(rate, burst):
    rng = np.random.default_rng(int(rate * 10))
    clock = [0.0]
    jb = JT.TokenBucket(rate, burst, clock=lambda: clock[0])
    tb = TokenBucket(rate, burst, clock=lambda: clock[0])
    for _ in range(100):
        clock[0] += float(rng.choice([0.0, 0.05, 0.3, 1.0]))
        amount = float(rng.choice([1.0, 2.0, 0.5]))
        assert tb.take(amount) == jb.take(amount)
        assert tb.level == jb.level


def _tenant_specs(rng, n):
    return [{"name": TENANT_NAMES[i], "key": f"k{i}",
             "weight": float(rng.choice([1.0, 2.0])),
             "rps": float(rng.choice([0.0, 1.0, 2.0, 4.0])),
             "image_tokens_per_s": float(rng.choice([0.0, 512.0, 2048.0])),
             "max_pages": int(rng.choice([0, 8, 20])),
             "tier": str(rng.choice(sorted(TIERS)))} for i in range(n)]


@pytest.mark.parametrize("seed", range(5))
def test_tenant_table_matches_jax(seed):
    """Authenticate, admit, release and reload in a seeded order on one
    fake clock: the same grants, the same throttle records (quota,
    retry_after_s), the same events and ``stats()``."""
    rng = np.random.default_rng(100 + seed)
    clock = [0.0]
    jev, tev = [], []
    specs = _tenant_specs(rng, 3)
    jt = JT.TenantTable.from_json({"tenants": specs},
                                  clock=lambda: clock[0],
                                  on_event=jev.append)
    tt = TenantTable.from_json({"tenants": specs}, clock=lambda: clock[0],
                               on_event=tev.append)
    held = []                     # (tenant, pages) admitted, not released
    for _ in range(150):
        clock[0] += float(rng.choice([0.0, 0.1, 0.5, 2.0]))
        op = rng.random()
        if op < 0.6:
            key = f"k{int(rng.integers(0, 4))}"
            tokens = int(rng.choice([16, 256, 1024, 3000]))
            pages = int(rng.integers(1, 8))
            outs = []
            for mod, tbl in ((JT, jt), (T, tt)):
                try:
                    name = tbl.authenticate(key).name
                    tbl.admit(name, image_tokens=tokens, pages=pages)
                    outs.append(("ok", name))
                except mod.TenantThrottled as e:
                    outs.append(("429", _strip(e.record), e.retry_after_s))
                except mod.AuthError as e:
                    outs.append(("401", _strip(e.record)))
            assert outs[1] == outs[0]
            if outs[0][0] == "ok":
                held.append((outs[0][1], pages))
        elif op < 0.9 and held:
            name, pages = held.pop(int(rng.integers(0, len(held))))
            completed = bool(rng.random() < 0.7)
            jt.release(name, pages=pages, completed=completed)
            tt.release(name, pages=pages, completed=completed)
        else:
            specs = _tenant_specs(rng, int(rng.integers(1, 5)))
            assert _strip(tt.reload(specs)) == _strip(jt.reload(specs))
        assert tt.stats() == jt.stats()
    assert [_strip(e) for e in tev] == [_strip(e) for e in jev]
    assert tt.reloads == jt.reloads and tt.names() == jt.names()


def test_tenant_spec_and_tiers_match_jax():
    assert TIERS == JT.TIERS
    for d in ({"name": "a"}, {"name": "b", "key": "x", "weight": 3,
                              "rps": 2, "image_tokens_per_s": 100,
                              "max_pages": 5, "tier": "gold"},
              {"name": "c", "tier": "silver", "hedge_s": 0.25}):
        t, j = TenantSpec.from_dict(d), JT.TenantSpec.from_dict(d)
        assert dataclasses_equal(t, j)
        assert t.hedge_after_s == j.hedge_after_s
    for bad in ({"name": ""}, {"name": "a", "weight": 0},
                {"name": "a", "tier": "platinum"}):
        with pytest.raises(ValueError):
            TenantSpec.from_dict(bad)
        with pytest.raises(ValueError):
            JT.TenantSpec.from_dict(bad)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# -- the port's own contracts (JAX's tests, on the port) ----------------------

def _wfq(weights, **kw):
    return WeightedFairQueue(max_depth=kw.pop("max_depth", 512),
                             clock=lambda: 0.0,
                             weight_of=lambda t: weights.get(t, 1.0), **kw)


_TOKEN_COST = {"a": 256.0, "b": 64.0}


def test_two_to_one_share_in_image_tokens():
    for n in (15, 30, 60):
        q = _wfq({"a": 2.0, "b": 1.0},
                 cost_fn=lambda r: _TOKEN_COST[r.tenant])
        for _ in range(120):
            q.submit(S.Request(codes=(1,), tenant="a"))
            q.submit(S.Request(codes=(1,), tenant="b"))
        ready, _ = q.pop_ready(n)
        tok = {"a": 0.0, "b": 0.0}
        for h in ready:
            tok[h.request.tenant] += _TOKEN_COST[h.request.tenant]
        share = tok["a"] / (tok["a"] + tok["b"])
        assert abs(share - 2 / 3) <= 0.1 * (2 / 3) + 256.0 / sum(
            tok.values())
        assert sum(h.request.tenant == "a" for h in ready) / n < 0.5


def test_no_debt_and_no_banked_credit():
    q = _wfq({"a": 1.0, "b": 1.0})
    for _ in range(20):
        q.submit(S.Request(codes=(1,), tenant="a"))
    q.pop_ready(20)
    tag_a = q.finish_tag("a")
    assert tag_a > q.virtual_time()
    for _ in range(40):
        q.submit(S.Request(codes=(1,), tenant="b"))
    q.pop_ready(40)
    assert q.virtual_time() > tag_a
    h = q.submit(S.Request(codes=(1,), tenant="a"))
    assert h.vstart == q.virtual_time() and h.vfinish == h.vstart + 1.0
    q = _wfq({"a": 1.0, "b": 1.0})
    for _ in range(30):
        q.submit(S.Request(codes=(1,), tenant="b"))
    q.pop_ready(30)
    assert q.submit(S.Request(codes=(1,), tenant="a")).vstart == \
        q.virtual_time()


def test_priority_dominates_and_requeue_keeps_position():
    q = _wfq({"a": 1.0, "b": 100.0})
    q.submit(S.Request(codes=(1,), tenant="b", priority=1))
    h = q.submit(S.Request(codes=(1,), tenant="a", priority=0))
    assert q.pop_ready(1)[0] == [h]
    q = _wfq({"a": 1.0, "b": 1.0})
    h1 = q.submit(S.Request(codes=(1,), tenant="a"))
    tag = h1.vfinish
    for _ in range(10):
        q.submit(S.Request(codes=(1,), tenant="b"))
    assert q.pop_ready(1)[0] == [h1]
    q.requeue(h1)
    assert h1.vfinish == tag and q.pop_ready(1)[0] == [h1]


def test_base_queue_order_unchanged():
    q = S.RequestQueue(max_depth=16, clock=lambda: 0.0)
    h1 = q.submit(S.Request(codes=(1,), tenant="z", priority=1))
    h2 = q.submit(S.Request(codes=(1,), tenant="a", priority=0))
    h3 = q.submit(S.Request(codes=(1,), tenant="m", priority=0))
    q.requeue(h2)                 # already in line: not added twice
    assert q.pop_ready(3)[0] == [h2, h3, h1]
    assert (h1.vstart, h1.vfinish) == (None, None)


def test_throttle_is_typed_with_retry_after_and_no_partial_spend():
    clock = [0.0]
    tbl = TenantTable.from_json(
        [{"name": "a", "key": "k", "rps": 1.0, "image_tokens_per_s": 100.0,
          "max_pages": 4}], clock=lambda: clock[0])
    tbl.admit("a", image_tokens=1024, pages=4)
    with pytest.raises(TenantThrottled) as ei:
        tbl.admit("a", image_tokens=0, pages=0)
    assert ei.value.record["quota"] == "rps"
    assert ei.value.retry_after_s == 1.0
    clock[0] += 1.0
    with pytest.raises(TenantThrottled) as ei:
        tbl.admit("a", image_tokens=200, pages=0)
    assert ei.value.record["quota"] == "image_tokens"
    # the refund: the rps token the image-token refusal took is back
    clock[0] += 2.0
    with pytest.raises(TenantThrottled) as ei:
        tbl.admit("a", image_tokens=100, pages=1)
    assert ei.value.record["quota"] == "pages"
    assert ei.value.retry_after_s == 1.0
    tbl.release("a", pages=4)
    tbl.admit("a", image_tokens=100, pages=1)
    st = tbl.stats()["a"]
    assert (st["admitted"], st["throttled"], st["completed"],
            st["pages_in_flight"]) == (2, 3, 1, 1)


def test_authenticate_and_reload_keep_the_ledger():
    clock = [0.0]
    tbl = TenantTable.from_json([{"name": "a", "key": "k", "rps": 1.0,
                                  "max_pages": 8}, {"name": "dev"}],
                                clock=lambda: clock[0])
    assert tbl.authenticate("k").name == "a"
    assert tbl.authenticate("").name == "dev"
    with pytest.raises(AuthError) as ei:
        tbl.authenticate("guess")
    assert ei.value.record["kind"] == "gateway_auth_failed"
    tbl.admit("a", image_tokens=0, pages=3)
    rec = tbl.reload([{"name": "a", "key": "k2", "rps": 1.0,
                       "max_pages": 8}, {"name": "b", "key": "kb"}])
    assert (rec["added"], rec["removed"]) == (["b"], ["dev"])
    with pytest.raises(TenantThrottled):
        tbl.admit("a", image_tokens=0, pages=1)   # the spent bucket stays
    assert tbl.stats()["a"]["pages_in_flight"] == 3
    with pytest.raises(AuthError):
        tbl.authenticate("k")
    with pytest.raises(ValueError):
        tbl.reload([{"name": "x"}, {"name": "x"}])
    with pytest.raises(ValueError):
        TenantTable.from_json("nope")
