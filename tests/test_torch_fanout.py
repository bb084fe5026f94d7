"""The port's best-of-N groups and short grids on the CPU, against the
JAX package's.

``sample_seed``, ``group_pages_saved`` and ``rank_samples`` give JAX's
values and orders; ``submit_group`` admits members with JAX's seeds and
ids, all or none (a mid-group reject cancels the admitted members and
raises JAX's record), and a group's cancel reaches every member and ends
its stream. Through the engine (the tiny model of
``tests/test_torch_engine_features.py``): each member's tokens equal a
standalone request's at ``sample_seed(seed, i)`` and the JAX engine's,
in the dense and paged layouts (the kernel read with the prefix cache
sharing the group's prompt pages), and an ``image_seq_len_override``
request's tokens are the causal prefix of the full grid's, alone and in
a group, as in JAX."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import fanout as JF
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.serve import fanout as F
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine

PKGS = {"jax": (JS, JF), "port": (S, F)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 11, 2 ** 31 - 1, 2 ** 32 - 1,
                                  123456789])
def test_sample_seed_matches_jax(seed):
    got = [F.sample_seed(seed, i) for i in range(8)]
    assert got == [JF.sample_seed(seed, i) for i in range(8)]
    assert got[0] == seed and len(set(got)) == 8


@pytest.mark.parametrize("n,prompt,page", [(4, 32, 8), (4, 35, 8),
                                           (1, 32, 8), (4, 32, 0),
                                           (2, 17, 16), (3, 256, 16)])
def test_group_pages_saved_matches_jax(n, prompt, page):
    assert F.group_pages_saved(n, prompt, page) == \
        JF.group_pages_saved(n, prompt, page)


@pytest.mark.parametrize("case", ["mixed", "no_scores", "ties"])
def test_rank_samples_matches_jax(case):
    rows = {"mixed": [("ok", 0.1), ("error", 9.0), ("ok", 0.7),
                      ("ok", 0.1)],
            "no_scores": [("ok", None)] * 3,
            "ties": [("ok", 0.5), ("cancelled", None), ("ok", 0.5),
                     ("ok", 0.9), ("error", None)]}[case]
    got = {}
    for pkg, (S_, F_) in PKGS.items():
        rs = [S_.Result(status=st, request_id=i, clip_score=sc)
              for i, (st, sc) in enumerate(rows)]
        got[pkg] = [r.request_id for r in F_.rank_samples(rs)]
    assert got["port"] == got["jax"]
    if case == "mixed":
        assert got["port"] == [2, 0, 3, 1]


def test_members_are_ordinary_requests_like_jax():
    got = {}
    for pkg, (S_, F_) in PKGS.items():
        q = S_.RequestQueue(max_depth=16)
        q.submit(S_.Request(codes=(9,)))
        g = F_.submit_group(q, S_.Request(codes=(1, 2), seed=42,
                                          n_samples=3, stream=True))
        assert len(g.sinks) == 3 and g.sink is g.sinks[0]
        for i, m in enumerate(g.members):
            assert m.sink is g.sinks[i]
            assert g.sinks[i].request_id == m.request.request_id
        got[pkg] = (g.request.request_id, [
            (m.request.request_id, m.request.seed, m.request.n_samples,
             m.request.stream) for m in g.members])
        plain = F_.submit_group(q, S_.Request(codes=(1,), n_samples=2))
        assert plain.sinks == [] and plain.sink is None
    assert got["port"] == got["jax"]
    assert got["port"][1][0][1] == 42


def test_group_admission_is_atomic_like_jax():
    """Member 3 of 4 meets a full queue: the reject propagates with
    JAX's record and the two admitted members are cancelled."""
    got = {}
    for pkg, (S_, F_) in PKGS.items():
        q = S_.RequestQueue(max_depth=2)
        with pytest.raises(S_.QueueFull) as ei:
            F_.submit_group(q, S_.Request(codes=(1,), seed=7, n_samples=4,
                                          stream=True))
        rec = {k: v for k, v in ei.value.record.items() if k != "time"}
        got[pkg] = (rec, [(h.request.request_id, h.result(timeout=1).status,
                           h.result().reason) for h in q.drain()])
    assert got["port"] == got["jax"]
    assert [s for _, s, _ in got["port"][1]] == [S.CANCELLED] * 2


def test_group_cancel_reaches_every_member_like_jax():
    got = {}
    for pkg, (S_, F_) in PKGS.items():
        q = S_.RequestQueue(max_depth=8)
        g = F_.submit_group(q, S_.Request(codes=(1,), seed=0, n_samples=2,
                                          stream=True))
        assert g.fulfill(S_.Result(status=S_.CANCELLED,
                                   request_id=g.request.request_id,
                                   reason="client disconnected"))
        assert g.done()
        assert not g.fulfill(S_.Result(status=S_.OK, request_id=0))
        got[pkg] = ([(m.result(timeout=1).status, m.result().reason,
                      m.result().request_id) for m in g.members],
                    [e for e in g.sink.events()],
                    g.result(timeout=1).status)
    assert got["port"] == got["jax"]
    assert [e["event"] for e in got["port"][1]].count("sample_done") == 2


# -- through the engine ---------------------------------------------------------

JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
LAYOUTS = {"dense": dict(kv="dense"),
           "paged_kernel_prefix": dict(kv="paged", page_size=8,
                                       paged_attn="kernel",
                                       prefix_cache=True)}


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


def run(pkg, bundle, submit, slots=4, **kw):
    """An engine over what ``submit(S_, F_, queue)`` submits; returns its
    handles' results and the engine."""
    S_, F_ = PKGS[pkg]
    q = S_.RequestQueue(max_depth=16)
    if pkg == "jax":
        eng = JEngine(bundle[0], JCFG, q, num_slots=slots, chunk_steps=4,
                      **kw)
    else:
        eng = Engine(bundle[1], q, num_slots=slots, chunk_steps=4,
                     device="cpu", **kw)
    handles = submit(S_, F_, q)
    eng.run_until_idle()
    return [h.result(timeout=60) for h in handles], eng


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_members_equal_standalone_requests_and_jax(bundle, layout):
    def group(S_, F_, q):
        g = F_.submit_group(q, S_.Request(codes=(3, 7, 9), seed=11,
                                          n_samples=3))
        return [g] + g.members

    def standalone(S_, F_, q):
        return [q.submit(S_.Request(codes=(3, 7, 9),
                                    seed=F_.sample_seed(11, i)))
                for i in range(3)]

    got = {}
    for pkg in PKGS:
        (res, *members), eng = run(pkg, bundle, group, **LAYOUTS[layout])
        alone, _ = run(pkg, bundle, standalone, **LAYOUTS[layout])
        assert res.ok and len(res.samples) == 3
        for m, a in zip(members, alone):
            np.testing.assert_array_equal(m.tokens, a.tokens)
        # no CLIP: the rank is the sample order
        assert [s.request_id for s in res.samples] == \
            [m.request_id for m in members]
        np.testing.assert_array_equal(res.tokens, members[0].tokens)
        got[pkg] = ([np.asarray(m.tokens).tolist() for m in members],
                    eng.prefix_hits if layout != "dense" else 0)
    assert got["port"] == got["jax"]
    if layout != "dense":
        assert got["port"][1] == 2       # the siblings shared the prompt


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_short_grid_is_the_causal_prefix_like_jax(bundle, layout):
    L = TCFG.image_seq_len // 2

    def submit(S_, F_, q):
        short = q.submit(S_.Request(codes=(3, 7, 9), seed=11,
                                    image_seq_len_override=L))
        full = q.submit(S_.Request(codes=(3, 7, 9), seed=11))
        g = F_.submit_group(q, S_.Request(codes=(6, 6), seed=5,
                                          n_samples=2,
                                          image_seq_len_override=L))
        return [short, full, g]

    got = {}
    for pkg in PKGS:
        (short, full, grp), eng = run(pkg, bundle, submit, slots=2,
                                      **LAYOUTS[layout])
        assert short.ok and len(short.tokens) == L
        np.testing.assert_array_equal(short.tokens, full.tokens[:L])
        assert grp.ok and all(len(s.tokens) == L for s in grp.samples)
        assert eng.active_slots() == 0
        if layout != "dense":
            assert eng.alloc.in_use == eng.prefix.pages_held
        got[pkg] = ([np.asarray(r.tokens).tolist()
                     for r in (short, full, *grp.samples)],
                    eng.completed, eng.tokens_decoded)
    assert got["port"] == got["jax"]


def test_override_range_is_a_typed_error_like_jax(bundle):
    def submit(S_, F_, q):
        return [q.submit(S_.Request(codes=(3,),
                                    image_seq_len_override=17))]

    got = {pkg: run(pkg, bundle, submit)[0][0] for pkg in PKGS}
    assert (got["port"].status, got["port"].reason) == \
        (got["jax"].status, got["jax"].reason) == (
            S.ERROR, "image_seq_len_override 17 out of range (need 1..16)")
    with pytest.raises(ValueError, match="image_seq_len_override"):
        S.Request(codes=(1,), image_seq_len_override=-1)
    with pytest.raises(ValueError, match="n_samples"):
        S.Request(codes=(1,), n_samples=0)
    assert dataclasses.replace(S.Request(codes=(1,)), tenant="a").tenant \
        == "a"
