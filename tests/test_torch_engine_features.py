"""The port's single engine with its serving features on the CPU, against
the JAX engine: for the same weights and requests, the port's ``Engine``
and the JAX ``Engine`` give IDENTICAL tokens and EQUAL lifetime counters
(``serve/engine.py::COUNTERS``) under ``kv='dense'``, the paged gather
read at page size 4, eviction from a pool of one full sequence plus the
trash page plus a little, the prefix cache (hits, refcounts, the
copy-on-write fork, no leak, the index shrunk before a live request is
evicted) and guided pairs (also equal to the port's one-shot
``generate_images(guidance=)`` at batch 1). The postprocess worker's CLIP
scores equal the JAX ``PostProcessor``'s to 1e-5, and a failure comes
back as ``status='error'``.

Tiny model (dim 32, depth 2, text 8 + image 16 tokens); each JAX engine
runs once a module (``_jax_run`` memoizes)."""

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import postprocess as JP
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import COUNTERS, Engine
from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor


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

# (codes, seed, sampling kwargs, priority, cfg_scale)
PLAIN = [((3, 7, 9), 11, {}, 0, 0.0),
         ((5, 2, 8, 1, 4), 23, dict(temperature=0.7, filter_thres=0.8), 0,
          0.0),
         ((6, 6), 5, dict(temperature=1.3, top_p=0.9), 1, 0.0)]
# shared prompts: the second of each pair is a prefix hit (t0 = 5 and 2 at
# page size 4: a full page and a boundary page, and a boundary page alone)
SHARED = PLAIN + [((5, 2, 8, 1, 4), 31, {}, 0, 0.0),
                  ((6, 6), 41, dict(filter_thres=0.9), 1, 0.0),
                  ((3, 7, 9), 13, dict(top_p=0.9), 1, 0.0)]
GUIDED = [((3, 7, 9), 11, {}, 0, 1.5),
          ((3, 7, 9), 12, dict(top_p=0.9), 0, 0.0),
          ((5, 2, 8, 1, 4), 23, dict(temperature=0.7), 1, 3.0)]

CASES = {
    "dense": dict(kw=dict(kv="dense"), reqs=PLAIN, slots=2),
    "paged_gather": dict(kw=dict(kv="paged", page_size=4,
                                 paged_attn="gather"), reqs=PLAIN, slots=2),
    # one full sequence (6 pages of 4) + the trash page + 2
    "eviction": dict(kw=dict(kv="paged", page_size=4, paged_attn="gather",
                             num_pages=9), reqs=PLAIN, slots=3),
    # room beyond the slots' 12 pages, so the index's pages survive
    "prefix": dict(kw=dict(kv="paged", page_size=4, paged_attn="gather",
                           num_pages=20, prefix_cache=True), reqs=SHARED,
                   slots=2),
    "guided": dict(kw=dict(kv="paged", page_size=4, paged_attn="gather",
                           prefix_cache=True), reqs=GUIDED, slots=4),
}


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    model = from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")
    vae = from_jax.vae_from_jax(vae_p, TVCFG, device="cpu")
    return dal_p, vae_p, model, vae


def jax_requests(reqs):
    return [JS.Request(codes=c, seed=s, sampling=JS.SamplingParams(**sp),
                       priority=pr, cfg_scale=g)
            for c, s, sp, pr, g in reqs]


def port_requests(reqs):
    return [S.Request(codes=c, seed=s, sampling=S.SamplingParams(**sp),
                      priority=pr, cfg_scale=g)
            for c, s, sp, pr, g in reqs]


_JAX: dict = {}


def _jax_run(bundle, case):
    """The JAX engine on a case: (tokens per request, counters, stats)."""
    if case not in _JAX:
        dal_p = bundle[0]
        c = CASES[case]
        queue = JS.RequestQueue(max_depth=16)
        engine = JEngine(dal_p, JCFG, queue, num_slots=c["slots"],
                         chunk_steps=2, **c["kw"])
        handles = [queue.submit(r) for r in jax_requests(c["reqs"])]
        engine.run_until_idle()
        results = [h.result(timeout=5) for h in handles]
        assert all(r.status == "ok" for r in results), results
        _JAX[case] = ([np.asarray(r.tokens) for r in results],
                      engine.counters(), engine.stats())
    return _JAX[case]


def port_run(bundle, case, complete=None, **extra):
    model = bundle[2]
    c = CASES[case]
    queue = S.RequestQueue(max_depth=16, max_prompt_len=TCFG.text_seq_len)
    engine = Engine(model, queue, num_slots=c["slots"], chunk_steps=2,
                    device="cpu", complete=complete, **{**c["kw"], **extra})
    handles = [queue.submit(r) for r in port_requests(c["reqs"])]
    engine.run_until_idle()
    results = [h.result(timeout=5) for h in handles]
    assert all(r.status == S.OK for r in results), results
    return engine, results


def assert_matches_jax(bundle, case, engine, results):
    tokens, counters, _ = _jax_run(bundle, case)
    for got, want in zip(results, tokens):
        np.testing.assert_array_equal(got.tokens, want)
    assert engine.counters() == {k: counters[k] for k in COUNTERS}


@pytest.mark.parametrize("case", ["dense", "paged_gather"])
def test_layouts_match_the_jax_engine(bundle, case):
    engine, results = port_run(bundle, case)
    assert_matches_jax(bundle, case, engine, results)
    if case == "paged_gather":
        assert engine.page_size == 4 and engine.alloc.in_use == 0
    else:
        assert engine.pool["k"].shape[3] == TCFG.seq_len


@pytest.mark.parametrize("paged_attn", ["gather", "kernel"])
def test_eviction_matches_the_jax_engine(bundle, paged_attn):
    """Three slots on a pool of 8 allocatable pages: the growing slots
    run it dry, the lowest-priority request is evicted, requeued at its
    position and replayed to the same tokens. Under 'kernel' (K4's plain
    version here) the page size is 8, so the pool is 1 + 3 + 1."""
    extra = {} if paged_attn == "gather" else dict(
        paged_attn="kernel", page_size=8, num_pages=5)
    engine, results = port_run(bundle, "eviction", **extra)
    tokens, counters, _ = _jax_run(bundle, "eviction")
    assert counters["evicted"] >= 1 and engine.evicted >= 1
    for got, want in zip(results, tokens):
        np.testing.assert_array_equal(got.tokens, want)
    if paged_attn == "gather":
        assert engine.counters() == {k: counters[k] for k in COUNTERS}
    assert engine.alloc.in_use == 0
    st = engine.stats()
    assert st["requeued"] >= st["evicted"] >= 1
    # every request's delivered tokens counted once despite the replays
    assert st["tokens_decoded"] == sum(TCFG.seq_len - len(c[0])
                                       for c in PLAIN)


def test_pool_floor_and_page_size_gates(bundle):
    model = bundle[2]
    q = S.RequestQueue()
    with pytest.raises(ValueError, match="even one full sequence"):
        Engine(model, q, kv="paged", page_size=4, num_pages=6, device="cpu")
    Engine(model, q, kv="paged", page_size=4, num_pages=7, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Engine(model, q, kv="paged", page_size=4, paged_attn="kernel",
               device="cpu")
    with pytest.raises(ValueError, match="kv='paged'"):
        Engine(model, q, paged_attn="kernel", device="cpu")
    with pytest.raises(ValueError, match="prefix_cache requires"):
        Engine(model, q, prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="kv must be"):
        Engine(model, q, kv="ragged", device="cpu")
    with pytest.raises(TypeError):
        Engine(model, q, preview_every=2, device="cpu")


def test_prefix_cache_matches_jax_and_returns_every_page(bundle):
    engine, results = port_run(bundle, "prefix")
    assert_matches_jax(bundle, "prefix", engine, results)
    _, _, jstats = _jax_run(bundle, "prefix")
    st = engine.stats()
    assert st["prefix_hits"] == jstats["prefix_hits"] >= 2
    assert st["prefill_runs"] < len(SHARED)
    # only the index holds pages now: one reference each, and clear()
    # hands every one back
    assert engine.alloc.in_use == engine.prefix.pages_held \
        == jstats["prefix_pages_held"]
    for e in engine.prefix._entries.values():
        assert all(engine.alloc.refcount(p) == 1 for p in e.full_pages)
    engine.prefix.clear()
    assert engine.alloc.in_use == 0


def test_warm_hit_maps_shared_pages_and_forks_the_boundary(bundle):
    """Mid-decode view of a warm hit: the consumer's table maps the
    entry's full page (refcount 2: the index and the slot) and a private
    boundary page holding the cached copy's prompt rows; the cold
    request's own boundary page was never shared."""
    model = bundle[2]
    queue = S.RequestQueue(max_depth=8)
    engine = Engine(model, queue, num_slots=2, chunk_steps=1, kv="paged",
                    page_size=4, prefix_cache=True, device="cpu")
    codes = (5, 2, 8, 1, 4)
    cold = queue.submit(S.Request(codes=codes, seed=1))
    engine.step_once()
    (entry,) = engine.prefix._entries.values()
    assert entry.t0 == 5 and len(entry.full_pages) == 1
    assert entry.boundary_snap is not None
    warm = queue.submit(S.Request(codes=codes, seed=2))
    engine.step_once()
    i = next(i for i, s in enumerate(engine.slots)
             if s is not None and s.handle is warm)
    pages = engine._slot_pages[i]
    assert pages[0] == entry.full_pages[0]
    assert engine.alloc.refcount(pages[0]) == 3     # index, cold, warm
    assert pages[1] not in engine._slot_pages[1 - i]
    for name, buf in engine.pool.items():
        # the fork holds the prompt row of position 4 as the cache had it
        torch.testing.assert_close(buf[:, pages[1], :, 0],
                                   entry.boundary_snap[name][:, :, 0],
                                   rtol=0, atol=0)
    engine.run_until_idle()
    assert cold.result(0).ok and warm.result(0).ok
    assert engine.alloc.in_use == engine.prefix.pages_held


def test_index_shrinks_before_a_live_request_is_evicted(bundle):
    """A pool of exactly one sequence: the index's entry holds a page
    the next request needs to grow, and the index gives it back (LRU
    first) instead of evicting anything live."""
    model = bundle[2]
    queue = S.RequestQueue(max_depth=8)
    engine = Engine(model, queue, num_slots=1, chunk_steps=2, kv="paged",
                    page_size=4, num_pages=7, prefix_cache=True,
                    device="cpu")
    for codes in ((1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11, 12, 13)):
        queue.submit(S.Request(codes=codes, seed=3))
        engine.run_until_idle()
    assert engine.prefix.evicted >= 1 and engine.evicted == 0
    assert engine.alloc.in_use == engine.prefix.pages_held


def test_guided_pairs_match_jax_and_one_shot_guidance(bundle):
    engine, results = port_run(bundle, "guided")
    assert_matches_jax(bundle, "guided", engine, results)
    assert engine.cfg_pairs == 2
    model = bundle[2]
    for (codes, seed, sp, _, g), res in zip(GUIDED, results):
        if not g:
            continue
        want = TD.generate_images(
            model, bundle[3], torch.tensor([codes]),
            rng=prng.prng_key(seed), guidance=g, return_img_seq=True,
            **sp)[1]
        np.testing.assert_array_equal(res.tokens, want[0].numpy())
    # the null caption is one shared entry: the guided request and the
    # plain one with its prompt are hits, and nothing leaked
    assert engine.prefix_hits >= 1
    assert engine.alloc.in_use == engine.prefix.pages_held


def test_guidance_needs_two_slots(bundle):
    model = bundle[2]
    queue = S.RequestQueue()
    engine = Engine(model, queue, num_slots=1, device="cpu")
    h = queue.submit(S.Request(codes=(1, 2), cfg_scale=2.0))
    engine.run_until_idle()
    assert h.result(0).status == S.ERROR and "slot pair" in h.result(0).reason
    with pytest.raises(ValueError, match="cfg_scale"):
        S.Request(codes=(1,), cfg_scale=-1.0)


def test_requeue_keeps_arrival_order_and_counts():
    q = S.RequestQueue()
    a = q.submit(S.Request(codes=(1,)))
    b = q.submit(S.Request(codes=(1,)))
    ready, _ = q.pop_ready(2)
    q.requeue(b, count=False)
    q.requeue(a)
    assert q.requeued == 1
    assert q.pop_ready(2)[0] == [a, b]


# -- the postprocess worker ------------------------------------------------------

@pytest.fixture(scope="module")
def clips():
    jp = jax.device_get(JC.clip_init(jax.random.PRNGKey(7),
                                     JC.CLIPConfig(**CLIP_KW)))
    return jp, from_jax.clip_from_jax(jp, TC.CLIPConfig(**CLIP_KW),
                                      device="cpu")


def test_postprocess_worker_scores_like_jax(bundle, clips):
    dal_p, vae_p, model, vae = bundle
    jclip, tclip = clips
    post = PostProcessor(vae, model, clip=tclip).start()
    engine, results = port_run(bundle, "dense", complete=post.submit)
    post.close()
    assert post.decoded == len(results) and post.pending() == 0
    jpost = JP.PostProcessor(dal_p, vae_p, JCFG, clip_params=jclip,
                             clip_cfg=JC.CLIPConfig(**CLIP_KW)).start()
    jhandles = []
    for res in results:
        jh = JS.RequestHandle(JS.Request(codes=(1,)))
        jpost.submit(jh, JS.Result(status="ok", request_id=res.request_id,
                                   tokens=res.tokens,
                                   text_tokens=res.text_tokens))
        jhandles.append(jh)
    jpost.close()
    for res, jh in zip(results, jhandles):
        want = jh.result(timeout=30)
        assert res.ok and np.isfinite(res.clip_score)
        np.testing.assert_allclose(res.clip_score, want.clip_score,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.image, np.asarray(want.image),
                                   rtol=1e-5, atol=1e-5)


def test_postprocess_failure_is_an_error_result(bundle, clips):
    model, vae = bundle[2], bundle[3]
    post = PostProcessor(vae, model, clip=clips[1]).start()
    h = S.RequestHandle(S.Request(codes=(1,)))
    post.submit(h, S.Result(status=S.OK, request_id=7, tokens=None))
    good = S.RequestHandle(S.Request(codes=(1, 2)))
    post.submit(good, S.Result(status=S.OK, request_id=8,
                               tokens=np.zeros(16, np.int32)))
    post.close()
    res = h.result(timeout=5)
    assert res.status == S.ERROR and "postprocess" in res.reason
    assert res.request_id == 7
    # a result with no text span scores its prompt codes
    assert good.result(timeout=5).ok
    assert np.isfinite(good.result().clip_score)
