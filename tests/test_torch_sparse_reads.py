"""Serving a block-sparse DALLE in the port against the JAX package, on
the CPU: K4's visible walk (the plain version) against JAX
``paged_decode_attention(visible=...)`` in interpret mode, ``prefill``
and the decode step with sparse layers, the sparse-reads step in both
modes (``'kernel'``: K4's visible walk on sparse layers; ``'gather'``:
the trimmed ``visible_table_view`` read), the engine's tokens with
``sparse_reads`` on and off against the JAX sparse-reads engine, and
the typed rejections.

The model is tiny (dim 32, 2 heads of 16, text 8, sequence 24) with
``sparse_attn=(True, False)`` and ``sparse_block=4``, so the window (16
tokens) is narrower than the sequence: at block 16 a 24-token sequence
sees every page and would prove nothing. Pages hold 8 rows.

float32; tolerances: K4 partials and every step's h_out and K/V rows
rtol 1e-5, atol 2e-6 (softmax sums in another order); prefill atol
1e-5; tokens and integer tables equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import decode as JDEC
from dalle_pytorch_tpu.ops import paged_attention as JPA
from dalle_pytorch_tpu.serve import Request, RequestQueue, SamplingParams
from dalle_pytorch_tpu.serve import kv_pool as JKV
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import paged_attention as TPA
from dalle_pytorch_tpu_torch.ops import sparse as TS
from dalle_pytorch_tpu_torch.serve import kv_pool as KV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16, sparse_attn=(True, False),
                sparse_block=4)
PS = 8
STEP = dict(rtol=1e-5, atol=2e-6)


def cfgs(**kw):
    fields = {**DALLE_KW, **kw}
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **fields),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **fields))


JCFG, TCFG = cfgs()
L = TCFG.seq_len
MP = KV.pages_for(L, PS)

REQS = [((3, 7, 9), 11, dict()),
        ((5, 2, 8, 1, 4), 23, dict(temperature=0.7, filter_thres=0.8)),
        ((6, 6), 5, dict(temperature=1.3, top_p=0.9))]


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JCFG.vae))
    params = jax.device_get(JD.dalle_init(key, JCFG, vae))
    return params, from_jax.dalle_from_jax(params, TCFG, device="cpu")


def random_pool(seed, quantized, depth=2, num_pages=2 * MP + 1):
    rs = np.random.RandomState(seed)
    shape = (depth, num_pages, 2, PS, 16)
    if quantized:
        return {"k": rs.randint(-127, 128, shape).astype(np.int8),
                "v": rs.randint(-127, 128, shape).astype(np.int8),
                "k_scale": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                    np.float32),
                "v_scale": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                    np.float32)}
    return {"k": rs.randn(*shape).astype(np.float32),
            "v": rs.randn(*shape).astype(np.float32)}


def tables(n_slots=3):
    bt = np.zeros((n_slots, MP), np.int32)
    for i in range(min(n_slots, 2)):
        bt[i] = np.arange(i * MP + 1, (i + 1) * MP + 1)
    return bt


# -- K4's visible walk ------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_visible_walk_matches_jax_kernel_and_prefix_walk(quantized):
    """Slots at every interesting position (0, inside page 0, page
    boundaries, past the window, the last row): the plain visible walk
    against the JAX kernel's, and against the prefix walk over the same
    fully masked rows."""
    pool = random_pool(7, quantized, depth=1, num_pages=6 * MP + 1)
    pos = np.array([0, 1, 8, 9, 17, L - 1], np.int32)
    bt = np.stack([np.arange(i * MP + 1, (i + 1) * MP + 1)
                   for i in range(len(pos))]).astype(np.int32)
    vis, _, ccnt = TS.visible_pages_causal(L, PS, 4)
    layout = TS.token_layout_mask(L, 4)
    allowed = (np.arange(L)[None] < pos[:, None]) & layout[pos]
    allowed[3, 2] = False                         # a padded row
    q = np.random.RandomState(8).randn(len(pos), 2, 16).astype(np.float32)
    scales = ({} if not quantized else
              {"k_scales": pool["k_scale"][0], "v_scales": pool["v_scale"][0]})
    want = JPA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool["k"][0]), jnp.asarray(pool["v"][0]),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(allowed), scale=0.25,
        visible=jnp.asarray(vis[pos]), visible_cnt=jnp.asarray(ccnt[pos]),
        **{k: jnp.asarray(v) for k, v in scales.items()})
    targs = [torch.tensor(a) for a in (q, pool["k"][0], pool["v"][0], bt,
                                        pos, allowed)]
    tsc = {k: torch.tensor(v) for k, v in scales.items()}
    before = (TPA.paged_decode_attention.launches,
              TPA.paged_decode_attention.visible_launches)
    got = TPA.paged_decode_attention(
        *targs, scale=0.25, visible=torch.tensor(vis[pos]),
        visible_cnt=torch.tensor(ccnt[pos]), **tsc)
    assert (TPA.paged_decode_attention.launches,
            TPA.paged_decode_attention.visible_launches) == before
    prefix = TPA.paged_decode_attention(*targs, scale=0.25, **tsc)
    for g, w, p, what in zip(got, want, prefix, ("acc", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP,
                                   err_msg=what)
        np.testing.assert_allclose(g.numpy(), p.numpy(), **STEP,
                                   err_msg=what)
    assert float(got[1][0, 0]) == TPA.FILL and float(got[2][0].max()) == 0
    # visibility is not trivial here: the last row skips page 1
    assert ccnt[L - 1] < KV.pages_for(L - 1, PS)


def test_visible_walk_argument_checks():
    q = torch.zeros((1, 2, 16))
    pages = torch.zeros((3, 2, PS, 16))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    allowed = torch.zeros((1, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="come together"):
        TPA.paged_decode_attention(q, pages, pages, bt, pos, allowed,
                                   scale=1.0, visible=bt)
    with pytest.raises(ValueError, match="block tables"):
        TPA.paged_decode_attention(
            q, pages, pages, bt, pos, allowed, scale=1.0,
            visible=torch.zeros((1, 3), dtype=torch.int32),
            visible_cnt=pos)


def test_visible_table_view_and_read_model_match_jax():
    bt = np.random.RandomState(2).randint(1, 50, (4, 10)).astype(np.int32)
    vis = np.random.RandomState(3).randint(0, 10, (4, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        KV.visible_table_view(torch.tensor(bt), torch.tensor(vis)).numpy(),
        np.asarray(JKV.visible_table_view(jnp.asarray(bt),
                                          jnp.asarray(vis))))
    for kw in (dict(impl="kernel"), dict(impl="gather"),
               dict(impl="kernel", sparse_reads=True,
                    sparse_pattern=(True, False) * 6),
               dict(impl="gather", sparse_reads=True, quantized=True,
                    sparse_pattern=(True, False) * 6)):
        args = dict(depth=12, heads=8, dim_head=64, total_len=1280,
                    page_size=16, prompt_len=256, itemsize=2, **kw)
        assert TPA.modeled_kv_read_bytes_per_token(**args) \
            == JPA.modeled_kv_read_bytes_per_token(**args)


# -- prefill and the steps ----------------------------------------------------------

def test_sparse_prefill_matches_jax(bundle):
    params, model = bundle
    text = np.random.RandomState(1).randint(1, 64, (3, 8))
    # the prompt then image positions: long enough to cross a window
    jx = JD.embed_prompt(params, JCFG, jnp.asarray(text),
                         jnp.asarray(np.arange(30).reshape(3, 10) % 32))
    tx = TD.embed_prompt(model, torch.tensor(text),
                         torch.tensor(np.arange(30).reshape(3, 10) % 32))
    jh, jcache = JDEC.prefill(params["transformer"], jx,
                              cfg=JCFG.transformer, total_len=L)
    with torch.no_grad():
        th, rows = TDEC.prefill(model.transformer, tx, cfg=TCFG.transformer)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    for name, buf in rows.items():
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(jcache[name])[:, :, :, :18],
                                   rtol=1e-5, atol=1e-5)
    # the sparse layout changes the model: a dense prefill differs
    _, dense = cfgs(sparse_attn=False)
    with torch.no_grad():
        dh, _ = TDEC.prefill(model.transformer, tx, cfg=dense.transformer)
    assert float((dh - th).abs().max()) > 1e-3


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pattern", [(True, False), (True, True)])
def test_sparse_steps_match_jax(bundle, pattern, quantized):
    """One step at ragged positions (the last row; mid-sequence with a
    padded prompt row; parked at 0): the port's step with sparse layers
    (kernel and gather, sparse_reads off) and its sparse-reads step
    (kernel and gather) against JAX's sparse-reads gather step."""
    params, model = bundle
    jcfg, tcfg = cfgs(sparse_attn=pattern)
    jcfg, tcfg = jcfg.transformer, tcfg.transformer
    pool_np = random_pool(7, quantized)
    pool = {k: torch.tensor(v) for k, v in pool_np.items()}
    bt = tables()
    pos = np.array([L - 1, 17, 0], np.int32)
    key_mask = np.ones((3, L), bool)
    key_mask[1, 1] = False
    x = np.random.RandomState(9).randn(3, 32).astype(np.float32)
    jkw = dict(cfg=jcfg, key_mask=jnp.asarray(key_mask))
    jh, jks, jvs = JDEC._decode_step_math(
        params["transformer"], jnp.asarray(x), jnp.asarray(pos),
        {k: jnp.asarray(v) for k, v in pool_np.items()}, attn_impl="gather",
        block_tables=jnp.asarray(bt), sparse_reads=True, **jkw)
    tkw = dict(cfg=tcfg, key_mask=torch.tensor(key_mask))
    args = (model.transformer, torch.tensor(x), torch.tensor(pos))
    tbt = torch.tensor(bt)
    view = TDEC.paged_view(pool, tbt, L)
    with torch.no_grad():
        runs = {
            "kernel": TDEC._decode_step_math(*args, pool, block_tables=tbt,
                                             **tkw),
            "gather": TDEC._decode_step_math(*args, view,
                                             attn_impl="gather", **tkw),
            "sparse_reads kernel": TDEC._decode_step_math(
                *args, pool, block_tables=tbt, sparse_reads=True, **tkw),
            "sparse_reads gather": TDEC._decode_step_math(
                *args, pool, attn_impl="gather", block_tables=tbt,
                sparse_reads=True, **tkw)}
    for what, (h, ks, vs) in runs.items():
        for g, w, name in ((h, jh, "h"), (ks, jks, "k"), (vs, jvs, "v")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP,
                                       err_msg=f"{what} {name}")
    # and the port's two reads agree with each other
    np.testing.assert_allclose(runs["sparse_reads kernel"][0].numpy(),
                               runs["kernel"][0].numpy(), **STEP)
    # the layout matters at these positions: a dense step differs
    _, dense = cfgs(sparse_attn=False)
    with torch.no_grad():
        hd = TDEC._decode_step_math(*args, pool, block_tables=tbt,
                                    cfg=dense.transformer,
                                    key_mask=torch.tensor(key_mask))[0]
    assert float((hd - runs["kernel"][0]).abs().max()) > 1e-3


def test_sparse_reads_step_needs_sparse_periodic_layers(bundle):
    _, model = bundle
    pool = {k: torch.tensor(v) for k, v in random_pool(1, False).items()}
    kw = dict(key_mask=torch.ones((1, L), dtype=torch.bool),
              block_tables=torch.tensor(tables(1)), sparse_reads=True)
    args = (model.transformer, torch.zeros((1, 32)),
            torch.tensor([3], dtype=torch.int32), pool)
    _, dense = cfgs(sparse_attn=False)
    with pytest.raises(ValueError, match="no sparse layers"):
        TDEC.decode_step_paged(*args, cfg=dense.transformer,
                               active=torch.ones(1, dtype=torch.bool), **kw)
    with pytest.raises(ValueError, match="no sparse layers"):
        TDEC.decode_loop_paged(
            model.transformer, torch.zeros(1, dtype=torch.int32),
            torch.tensor([3], dtype=torch.int32),
            torch.ones(1, dtype=torch.bool), pool, cfg=dense.transformer,
            steps=1, embed_fn=None, sample_fn=None, **kw)
    with pytest.raises(ValueError, match="block_tables"):
        TDEC._decode_step_math(*args, cfg=TCFG.transformer,
                               key_mask=kw["key_mask"], sparse_reads=True)


# -- the engine ----------------------------------------------------------------------

_JAX_TOKENS: dict = {}


def jax_engine_tokens(params):
    """The JAX sparse-reads engine's tokens for REQS (paged, gather
    reads: the oracle; the JAX package's own tests hold its kernel
    reads to the same tokens)."""
    if "tokens" not in _JAX_TOKENS:
        queue = RequestQueue(max_depth=8)
        engine = JEngine(params, JCFG, queue, num_slots=2, chunk_steps=4,
                         kv="paged", page_size=PS, paged_attn="gather",
                         sparse_reads=True)
        handles = [queue.submit(Request(codes=c, seed=s,
                                        sampling=SamplingParams(**sp)))
                   for c, s, sp in REQS]
        engine.run_until_idle()
        _JAX_TOKENS["tokens"] = [np.asarray(h.result(timeout=5).tokens)
                                 for h in handles]
    return _JAX_TOKENS["tokens"]


def port_tokens(model, **kw):
    queue = S.RequestQueue(max_depth=8, max_prompt_len=TCFG.text_seq_len)
    engine = Engine(model, queue, num_slots=2, page_size=PS, device="cpu",
                    kv="paged", paged_attn="kernel", **kw)
    handles = [queue.submit(S.Request(codes=c, seed=s,
                                      sampling=S.SamplingParams(**sp)))
               for c, s, sp in REQS]
    engine.run_until_idle()
    results = [h.result(timeout=5) for h in handles]
    assert all(r.status == S.OK for r in results), results
    assert engine.alloc.in_use == 0
    return engine, [np.asarray(r.tokens) for r in results]


@pytest.mark.parametrize("chunk_steps", [1, 8])
def test_engine_tokens_match_jax_with_sparse_reads_on_and_off(bundle,
                                                             chunk_steps):
    params, model = bundle
    want = jax_engine_tokens(params)
    engine, on = port_tokens(model, chunk_steps=chunk_steps,
                             sparse_reads=True)
    stats = engine.stats()
    assert stats["sparse_reads"] is True
    assert stats["kv_read_bytes_per_token"] \
        < stats["kv_read_bytes_per_token_dense_reads"]
    _, off = port_tokens(model, chunk_steps=chunk_steps)
    for a, b, w in zip(on, off, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)


def test_engine_rejects_sparse_reads_it_cannot_serve(bundle):
    _, model = bundle
    _, dense_cfg = cfgs(sparse_attn=False)
    dense = TD.dalle_init(dense_cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no sparse layers"):
        Engine(dense, S.RequestQueue(), num_slots=1, page_size=PS,
               device="cpu", kv="paged", paged_attn="kernel",
               sparse_reads=True)
    _, cfg5 = cfgs(depth=5, sparse_attn=(True, False, False, False, True))
    model5 = TD.dalle_init(cfg5, seed=0, device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        Engine(model5, S.RequestQueue(), num_slots=1, page_size=PS,
               device="cpu", kv="paged", paged_attn="kernel",
               sparse_reads=True)
    engine = Engine(model, S.RequestQueue(), num_slots=1, page_size=PS,
                    device="cpu", kv="paged", paged_attn="kernel")
    stats = engine.stats()
    assert stats["sparse_reads"] is False
    assert stats["kv_read_bytes_per_token"] \
        == stats["kv_read_bytes_per_token_dense_reads"]
