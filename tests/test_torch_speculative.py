"""Speculative decode in the port's engine on the CPU, against the JAX
package. Draft-and-verify changes how many full-depth passes a token
costs, never which token is emitted (sampling is a function of
``fold_in(key, position)``): over k in {1, 2, 4}, the dense, paged-gather
and paged-kernel (K4's plain version here) layouts and the int8 cache,
under a rejection-heavy 1-layer draft, every request's tokens equal the
JAX engine's and the port's eager engine's, and the k = 4 dense run's
speculative counters equal the JAX speculative engine's. Also: a
full-depth draft accepts every proposal; a guided pair speculates in
lockstep; rejection at each offset accepts exactly the matching prefix;
reversible and MoE models speculate; the JAX refusals (``sparse_reads``,
a bad ``draft_layers``); and ``_kernel_read_wide`` against
``_gather_read_wide`` and the JAX functions to 1e-5 in float32.

Tiny model (dim 32, depth 2, text 8 + image 16 tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import decode as JDEC
from dalle_pytorch_tpu.serve import scheduler as JS
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
BASE = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
            dim_head=16)
JCFG = JD.DALLEConfig(vae=JVCFG, **BASE)
TCFG = TD.DALLEConfig(vae=TVCFG, **BASE)

REQS = [((3, 7, 9), 11, {}),
        ((5, 2, 8, 1, 4), 23, dict(temperature=0.7, filter_thres=0.8)),
        ((6, 6), 5, dict(temperature=1.3, top_p=0.9))]

LAYOUTS = {"dense": dict(kv="dense"),
           "paged_gather": dict(kv="paged", page_size=4,
                                paged_attn="gather"),
           "paged_kernel": dict(kv="paged", page_size=8,
                                paged_attn="kernel")}


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    return dal_p, from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")


_JAX: dict = {}


def jax_engine(bundle, quantize_cache=False, speculative=0):
    """The JAX engine's tokens (dense, eager or k-speculative with a
    1-layer draft), and its stats; memoized."""
    key = (quantize_cache, speculative)
    if key not in _JAX:
        queue = JS.RequestQueue(max_depth=8)
        engine = JEngine(bundle[0], JCFG, queue, num_slots=2, chunk_steps=2,
                         quantize_cache=quantize_cache,
                         speculative=speculative,
                         draft_layers=1 if speculative else 0)
        hs = [queue.submit(JS.Request(codes=c, seed=s,
                                      sampling=JS.SamplingParams(**sp)))
              for c, s, sp in REQS]
        engine.run_until_idle()
        _JAX[key] = ([np.asarray(h.result(timeout=5).tokens) for h in hs],
                     engine.stats())
    return _JAX[key]


def port_run(model, reqs=REQS, num_slots=2, chunk_steps=2, cfg_scale=0.0,
             **kw):
    queue = S.RequestQueue(max_depth=8)
    engine = Engine(model, queue, num_slots=num_slots,
                    chunk_steps=chunk_steps, device="cpu", **kw)
    hs = [queue.submit(S.Request(codes=c, seed=s,
                                 sampling=S.SamplingParams(**sp),
                                 cfg_scale=cfg_scale))
          for c, s, sp in reqs]
    engine.run_until_idle()
    results = [h.result(timeout=5) for h in hs]
    assert all(r.status == S.OK for r in results), results
    if engine.kv == "paged":
        assert engine.alloc.in_use == 0
    return engine, [np.asarray(r.tokens) for r in results]


_EAGER: dict = {}


def port_eager(model, layout, quantize_cache):
    key = (id(model), layout, quantize_cache)
    if key not in _EAGER:
        _EAGER[key] = port_run(model, quantize_cache=quantize_cache,
                               **LAYOUTS[layout])[1]
    return _EAGER[key]


@pytest.mark.parametrize("quantize_cache", [False, True],
                         ids=["fp32", "int8kv"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_matrix_matches_jax_and_eager(bundle, k, layout, quantize_cache):
    model = bundle[1]
    engine, got = port_run(model, speculative=k, draft_layers=1,
                           quantize_cache=quantize_cache, **LAYOUTS[layout])
    want, _ = jax_engine(bundle, quantize_cache)
    eager = port_eager(model, layout, quantize_cache)
    for g, w, e in zip(got, want, eager):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, e)
    st = engine.stats()
    assert st["speculative"] == k and st["draft_layers"] == 1
    assert 1.0 / k <= st["spec_acceptance_rate"] <= 1.0
    exact = sum(TCFG.seq_len - len(c) for c, _, _ in REQS)
    assert st["tokens_decoded"] == engine.spec_delivered == exact
    if k == 4 and layout == "dense" and not quantize_cache:
        _, jst = jax_engine(bundle, speculative=4)
        for key in ("spec_rounds", "spec_acceptance_rate",
                    "spec_tokens_per_round", "decode_steps", "harvests"):
            assert st[key] == jst[key], key


def test_full_depth_draft_accepts_everything(bundle):
    model = bundle[1]
    engine, got = port_run(model, speculative=4, draft_layers=TCFG.depth,
                           **LAYOUTS["paged_kernel"])
    for g, w in zip(got, jax_engine(bundle)[0]):
        np.testing.assert_array_equal(g, w)
    st = engine.stats()
    assert st["spec_acceptance_rate"] == 1.0
    assert 3.5 <= st["spec_tokens_per_round"] <= 4.0


@pytest.mark.parametrize("layout", ["dense", "paged_kernel"])
def test_guided_pair_under_speculation(bundle, layout):
    """The shadow drafts and verifies partner copies of the cond stream,
    so the pair accepts the same lengths every round: the guided tokens
    equal the eager engine's and the one-shot ``generate_images``'."""
    model = bundle[1]
    (codes, seed, sp) = REQS[1]
    reqs = [REQS[1]]
    _, spec = port_run(model, reqs, num_slots=4, speculative=4,
                       draft_layers=1, cfg_scale=1.5, **LAYOUTS[layout])
    _, eager = port_run(model, reqs, num_slots=4, cfg_scale=1.5,
                        **LAYOUTS[layout])
    # the one-shot loop's conditional stream
    toks = torch.stack(list(TD.sample_tokens(
        model, torch.tensor([codes]), rng=prng.prng_key(seed),
        guidance=1.5, **sp)), dim=1)[0]
    np.testing.assert_array_equal(spec[0], eager[0])
    np.testing.assert_array_equal(spec[0],
                                  toks[-TCFG.image_seq_len:].numpy())


def _sampler(model, b):
    reqs = [(REQS[i % len(REQS)]) for i in range(b)]
    rng = torch.stack([prng.prng_key(s) for _, s, _ in reqs])
    temp = torch.tensor([sp.get("temperature", 1.0) for _, _, sp in reqs])
    topk = torch.tensor([max(1, int(TCFG.total_tokens
                                    * (1 - sp.get("filter_thres", 0.5))))
                         for _, _, sp in reqs], dtype=torch.int32)
    topp = torch.tensor([sp.get("top_p", 0.0) for _, _, sp in reqs])

    def embed_fn(tok, p):
        return TD.decode_token_embed(model, tok, p)

    def sample_fn(h, pred_pos):
        return TD.sample_per_slot(TD.to_logits(model, h), pred_pos, rng,
                                  temp, topk, topp, TCFG)

    return embed_fn, sample_fn


@torch.no_grad()
def test_rejection_at_every_offset(bundle):
    """``speculative_verify`` with drafts that match the eager stream for
    the first j offsets and are corrupted at offset j accepts exactly j+1
    tokens, all eager, and continues with the eager token after them."""
    model = bundle[1]
    tc = TCFG.transformer
    b, k, t0 = 3, 6, 4
    total_len = TCFG.seq_len
    key_mask = torch.ones((b, total_len), dtype=torch.bool)
    embed_fn, sample_fn = _sampler(model, b)
    cache = TDEC.init_cache(tc, b, total_len)
    pos = torch.zeros((b,), dtype=torch.int32)
    cur = torch.full((b,), 5, dtype=torch.int32)
    for _ in range(t0):
        h = TDEC.decode_step(model.transformer, embed_fn(cur, pos), pos,
                             cache, cfg=tc, key_mask=key_mask)
        cur = sample_fn(h, pos + 1).to(torch.int32)
        pos = pos + 1
    act = torch.ones((b,), dtype=torch.bool)
    copy = {n: t.clone() for n, t in cache.items()}
    _, _, _, ring = TDEC.decode_loop(
        model.transformer, cur, pos, act, copy, cfg=tc, key_mask=key_mask,
        steps=k + 1, embed_fn=embed_fn, sample_fn=sample_fn)
    eager = ring.numpy()                    # tokens at pos .. pos+k
    good = ring[:, 1:k].clone()
    for j in range(k):
        drafts = good.clone()
        if j < k - 1:
            drafts[:, j] += 1               # corrupt offset j
        emit, cur_new, pos_new, act_new, _, _ = TDEC.speculative_verify(
            model.transformer, cur, drafts, pos, act,
            {n: t.clone() for n, t in cache.items()}, cfg=tc,
            key_mask=key_mask, total_len=total_len, embed_fn=embed_fn,
            sample_fn=sample_fn)
        accepted = j + 1
        emit = emit.numpy()
        for i in range(b):
            assert (emit[i] >= 0).sum() == accepted
            np.testing.assert_array_equal(emit[i, :accepted],
                                          eager[i, :accepted])
            assert emit[i, accepted:].tolist() == [-1] * (k - accepted)
        np.testing.assert_array_equal(pos_new.numpy(), pos.numpy() + accepted)
        np.testing.assert_array_equal(cur_new.numpy(), eager[:, accepted])
        assert bool(act_new.all())


@pytest.mark.parametrize("kind", ["reversible", "moe"])
def test_reversible_and_moe_models_speculate(kind):
    """The chunk math runs ``_block``: a reversible (two-stream) or MoE
    stack, carried across from JAX, speculates on the dense layout and
    both paged reads to the JAX speculative engine's tokens, and to the
    port's own eager tokens."""
    extra = dict(reversible=True) if kind == "reversible" \
        else dict(moe_experts=4, moe_k=2)
    jcfg = JD.DALLEConfig(vae=JVCFG, **{**BASE, **extra})
    tcfg = TD.DALLEConfig(vae=TVCFG, **{**BASE, **extra})
    key = jax.random.PRNGKey(3)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    params = jax.device_get(JD.dalle_init(key, jcfg, vae_p))
    model = from_jax.dalle_from_jax(params, tcfg, device="cpu")
    queue = JS.RequestQueue(max_depth=8)
    jengine = JEngine(params, jcfg, queue, num_slots=2, chunk_steps=2,
                      speculative=4, draft_layers=1)
    hs = [queue.submit(JS.Request(codes=c, seed=s,
                                  sampling=JS.SamplingParams(**sp)))
          for c, s, sp in REQS]
    jengine.run_until_idle()
    want = [np.asarray(h.result(timeout=5).tokens) for h in hs]
    _, eager = port_run(model, **LAYOUTS["paged_kernel"])
    for g, w in zip(eager, want):
        np.testing.assert_array_equal(g, w)
    for layout in ("paged_kernel", "paged_gather", "dense"):
        _, spec = port_run(model, speculative=4, draft_layers=1,
                           **LAYOUTS[layout])
        for g, w in zip(spec, want):
            np.testing.assert_array_equal(g, w)


def test_jax_refusals(bundle):
    model = bundle[1]
    q = S.RequestQueue()
    sp_cfg = TD.DALLEConfig(vae=TVCFG, **{**BASE, "sparse_attn": (False, True),
                                          "sparse_block": 4})
    sp_model = TD.dalle_init(sp_cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="sparse_reads"):
        Engine(sp_model, q, kv="paged", page_size=8, sparse_reads=True,
               speculative=4, device="cpu")
    with pytest.raises(ValueError, match="draft_layers"):
        Engine(model, q, speculative=4, draft_layers=3, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        Engine(model, q, speculative=-1, device="cpu")
    dcfg = TD.draft_transformer_config(TCFG.transformer, 1)
    assert dcfg.depth == 1 and dcfg.sparse_pattern == (False,)
    draft = TD.draft_transformer_params(model.transformer, 1)
    assert len(draft.layers) == 1 and len(model.transformer.layers) == 2
    assert draft.layers[0] is model.transformer.layers[0]
    with pytest.raises(ValueError):
        TD.draft_transformer_config(TCFG.transformer, 0)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_kernel_read_wide_matches_gather_and_jax(quantized):
    """One layer's wide read, W = 4 offsets, 3 slots at ragged chunk
    starts (0, 5, 17) over a 24-row sequence in pages of 8, a sparse-ish
    row mask: K4's plain version per offset plus the intra merge against
    the gather over ``paged_view`` and against JAX's two functions, to
    1e-5 in float32."""
    rng = np.random.default_rng(0)
    b, h, W, dh, ps, L = 3, 2, 4, 16, 8, 24
    P = 1 + b * 3
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f32(b, h, W, dh), f32(b, h, W, dh), f32(b, h, W, dh)
    pool = {"k": f32(1, P, h, ps, dh), "v": f32(1, P, h, ps, dh)}
    bt = np.arange(1, 1 + b * 3, dtype=np.int32).reshape(b, 3)
    pos = np.array([0, 5, 17], np.int32)
    allowed = rng.uniform(size=(b, W, L)) < 0.8
    allowed &= np.arange(L)[None, None, :] < pos[:, None, None]
    intra = np.tril(np.ones((W, W), bool))[None].repeat(b, 0)
    intra &= (rng.uniform(size=(b, W, W)) < 0.7) | np.eye(W, dtype=bool)
    t = {n: torch.from_numpy(a) for n, a in dict(
        q=q, k=k, v=v, bt=bt, pos=pos, allowed=allowed, intra=intra).items()}
    tpool = {n: torch.from_numpy(a) for n, a in pool.items()}
    if quantized:
        tpool = TDEC._rows(tpool["k"], tpool["v"], True)
    jpool = {n: jnp.asarray(a.numpy()) for n, a in tpool.items()}
    ksc = tpool.get("k_scale")
    scale = dh ** -0.5
    got = TDEC._kernel_read_wide(
        t["q"], t["k"], t["v"], tpool["k"][0], tpool["v"][0], t["bt"],
        t["pos"], t["allowed"], t["intra"], scale=scale,
        ksc=None if ksc is None else ksc[0],
        vsc=None if ksc is None else tpool["v_scale"][0])
    view = TDEC.paged_view(tpool, t["bt"], L)
    gather = TDEC._gather_read_wide(
        t["q"], t["k"], t["v"], view["k"][0], view["v"][0], t["allowed"],
        t["intra"], scale=scale,
        ksc=view["k_scale"][0] if quantized else None,
        vsc=view["v_scale"][0] if quantized else None)
    torch.testing.assert_close(got, gather, rtol=1e-5, atol=1e-5)
    jview = JDEC.paged_view(jpool, jnp.asarray(bt), L)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgather = JDEC._gather_read_wide(
        *jargs, jview["k"][0], jview["v"][0], jnp.asarray(allowed),
        jnp.asarray(intra), scale=scale,
        ksc=jview["k_scale"][0] if quantized else None,
        vsc=jview["v_scale"][0] if quantized else None)
    np.testing.assert_allclose(gather.numpy(), np.asarray(jgather),
                               rtol=1e-5, atol=1e-5)
    jkernel = JDEC._kernel_read_wide(
        *jargs, jpool["k"][0], jpool["v"][0], jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(allowed), jnp.asarray(intra),
        scale=scale, ksc=jpool["k_scale"][0] if quantized else None,
        vsc=jpool["v_scale"][0] if quantized else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(jkernel), rtol=1e-5,
                               atol=1e-5)
