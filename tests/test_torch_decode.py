"""Prefill, the paged decode step and the sampler of the port against the
JAX package on the CPU (float32, atol 1e-5): same weights through the
bridge, same numpy inputs. The JAX decode step runs its Pallas kernel
in interpret mode (``attn_impl='kernel'``); the port's runs the plain
K4 version, as every CPU tensor does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import decode as JDEC
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.serve import kv_pool as KV


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)


def cfgs(axial="grid"):
    kw = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
              heads=2, dim_head=16, axial_compat=axial)
    return JD.DALLEConfig(vae=JVCFG, **kw), TD.DALLEConfig(vae=TVCFG, **kw)


JCFG, TCFG = cfgs()
L = TCFG.seq_len


def close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae = JV.vae_init(jax.random.fold_in(key, 1), JVCFG)
    params = jax.device_get(JD.dalle_init(key, JCFG, vae))
    return params, from_jax.dalle_from_jax(params, TCFG, device="cpu")


def test_quantize_rows_matches_jax():
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32) * 4
    x[0, 0] = 0.0                                   # the 1e-12 floor
    q, s = TDEC._quantize_rows(torch.tensor(x))
    jq, js = JDEC._quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantize", [False, True])
def test_prefill_matches_jax(bundle, quantize):
    params, model = bundle
    text = np.random.RandomState(1).randint(1, 64, (3, 5))
    jx = JD.embed_prompt(params, JCFG, jnp.asarray(text))
    tx = TD.embed_prompt(model, torch.tensor(text))
    close(tx, jx)
    jh, jcache = JDEC.prefill(params["transformer"], jx,
                              cfg=JCFG.transformer, total_len=L,
                              quantize_cache=quantize)
    with torch.no_grad():
        th, rows = TDEC.prefill(model.transformer, tx, cfg=TCFG.transformer,
                                quantize_cache=quantize)
    close(th, jh)
    for name, buf in rows.items():
        want = np.asarray(jcache[name])[:, :, :, :5]
        if name in ("k", "v") and quantize:
            # int8 rows may round the other way on a last-ulp difference
            assert np.abs(buf.numpy().astype(int) - want).max() <= 1
        else:
            close(buf, want)


def _random_pool(seed, page_size, num_pages, quantized):
    rs = np.random.RandomState(seed)
    shape = (2, num_pages, 2, page_size, 16)
    if quantized:
        return {"k": rs.randint(-127, 128, shape).astype(np.int8),
                "v": rs.randint(-127, 128, shape).astype(np.int8),
                "k_scale": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                    np.float32),
                "v_scale": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                    np.float32)}
    return {"k": rs.randn(*shape).astype(np.float32),
            "v": rs.randn(*shape).astype(np.float32)}


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_steps_match_jax(bundle, page_size, quantized):
    """Three paged decode steps, kernel branch on both sides, ragged
    slots (last row, mid-sequence, parked dead at 0 writing the trash
    page), a padded row, random data in every page: h_out per step and
    the whole pool after each write."""
    params, model = bundle
    mp = KV.pages_for(L, page_size)
    jpool = _random_pool(7, page_size, 3 * mp + 1, quantized)
    tpool = {k: torch.tensor(v) for k, v in jpool.items()}
    jpool = {k: jnp.asarray(v) for k, v in jpool.items()}
    bt = np.zeros((3, mp), np.int32)
    bt[0] = np.arange(1, mp + 1)
    bt[1] = np.arange(mp + 1, 2 * mp + 1)
    pos = np.array([L - 3, 5, 0], np.int32)
    active = np.array([True, True, False])
    key_mask = np.ones((3, L), bool)
    key_mask[1, 1] = False
    tok = np.array([3, 9, 0], np.int32)
    for step in range(3):
        jx = JD.decode_token_embed(params, JCFG, jnp.asarray(tok),
                                   jnp.asarray(pos))
        tx = TD.decode_token_embed(model, torch.tensor(tok),
                                   torch.tensor(pos))
        close(tx, jx)
        jh, jpool = JDEC.decode_step_paged(
            params["transformer"], jx, jnp.asarray(pos), jpool,
            jnp.asarray(bt), cfg=JCFG.transformer,
            key_mask=jnp.asarray(key_mask), total_len=L,
            active=jnp.asarray(active), attn_impl="kernel")
        with torch.no_grad():
            th = TDEC.decode_step_paged(
                model.transformer, tx, torch.tensor(pos), tpool,
                torch.tensor(bt), cfg=TCFG.transformer,
                key_mask=torch.tensor(key_mask),
                active=torch.tensor(active))
        close(th, jh)
        for name in tpool:
            if tpool[name].dtype == torch.int8:
                assert np.abs(tpool[name].numpy().astype(int)
                              - np.asarray(jpool[name])).max() <= 1
            else:
                close(tpool[name], jpool[name])
        tok = (tok + 5) % 32
        pos = np.where(active, pos + 1, 0).astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_step_matches_gather_oracle(bundle, quantized):
    """Within the port: the kernel branch and the dense-view oracle
    (``paged_view`` + ``_gather_read``) agree, and the view is JAX's."""
    _, model = bundle
    page_size = 8
    mp = KV.pages_for(L, page_size)
    pool_np = _random_pool(9, page_size, 2 * mp + 1, quantized)
    pool = {k: torch.tensor(v) for k, v in pool_np.items()}
    bt = torch.tensor(np.stack([np.arange(1, mp + 1),
                                np.arange(mp + 1, 2 * mp + 1)]),
                      dtype=torch.int32)
    view = TDEC.paged_view(pool, bt, L)
    jview = JDEC.paged_view({k: jnp.asarray(v) for k, v in pool_np.items()},
                            jnp.asarray(bt.numpy()), L)
    for name in view:
        np.testing.assert_array_equal(view[name].numpy(),
                                      np.asarray(jview[name]))
    pos = torch.tensor([L - 1, 9], dtype=torch.int32)
    x = torch.tensor(np.random.RandomState(3).randn(2, 32),
                     dtype=torch.float32)
    key_mask = torch.ones((2, L), dtype=torch.bool)
    with torch.no_grad():
        hk, ksk, vsk = TDEC._decode_step_math(
            model.transformer, x, pos, pool, cfg=TCFG.transformer,
            key_mask=key_mask, block_tables=bt)
        hg, ksg, vsg = TDEC._decode_step_math(
            model.transformer, x, pos, view, cfg=TCFG.transformer,
            key_mask=key_mask, attn_impl="gather")
    np.testing.assert_allclose(hk.numpy(), hg.numpy(), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(ksk.numpy(), ksg.numpy(), rtol=1e-5,
                               atol=2e-6)
    with pytest.raises(ValueError, match="block_tables"):
        TDEC._decode_step_math(model.transformer, x, pos, pool,
                               cfg=TCFG.transformer, key_mask=key_mask)


# -- embeddings, masks and the sampler -------------------------------------------

@pytest.mark.parametrize("axial", ["grid", "full_image"])
def test_embeddings_and_logits_mask_match_jax(axial):
    jcfg, tcfg = cfgs(axial)
    key = jax.random.PRNGKey(2)
    params = jax.device_get(JD.dalle_init(key, jcfg))
    model = from_jax.dalle_from_jax(params, tcfg, device="cpu")
    positions = np.arange(tcfg.image_seq_len)
    close(TD.image_pos_emb(model, torch.tensor(positions)),
          JD.image_pos_emb(params, jcfg, jnp.asarray(positions)))
    pos = np.array([0, 3, 7, 8, 15, 23], np.int32)
    tok = np.array([5, 63, 2, 31, 0, 7], np.int32)
    close(TD.decode_token_embed(model, torch.tensor(tok), torch.tensor(pos)),
          JD.decode_token_embed(params, jcfg, jnp.asarray(tok),
                                jnp.asarray(pos)))
    np.testing.assert_array_equal(TD.logits_mask(tcfg).numpy(),
                                  np.asarray(JD.logits_mask(jcfg)))
    np.testing.assert_array_equal(
        TD.logits_mask(tcfg, torch.tensor([0, 7, 23])).numpy(),
        np.asarray(JD.logits_mask(jcfg))[[0, 7, 23]])
    h = np.random.RandomState(4).randn(3, 32).astype(np.float32)
    close(TD.to_logits(model, torch.tensor(h)),
          JD.to_logits(params, jnp.asarray(h)))


def test_filters_match_jax():
    lg = np.random.RandomState(5).randn(4, 97).astype(np.float32)
    for thres in (0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            TD.top_k_filter(torch.tensor(lg), thres).numpy(),
            np.asarray(JD.top_k_filter(jnp.asarray(lg), thres)))
    for p in (0.1, 0.9, 1.0):
        np.testing.assert_array_equal(
            TD.top_p_filter(torch.tensor(lg), p).numpy(),
            np.asarray(JD.top_p_filter(jnp.asarray(lg), p)))


def test_sample_per_slot_matches_jax():
    """Mixed knobs per slot (top-k, greedy, nucleus, temperatures) at
    text and image positions: identical tokens over many keys."""
    rs = np.random.RandomState(6)
    n = 64
    tt = TCFG.total_tokens
    logits = (rs.randn(n, tt) * 2).astype(np.float32)
    pred_pos = rs.randint(1, L, n).astype(np.int32)
    seeds = rs.randint(0, 2 ** 31 - 1, n)
    temp = rs.choice([0.7, 1.0, 1.3], n).astype(np.float32)
    topk = rs.choice([1, 10, 48], n).astype(np.int32)
    top_p = rs.choice([0.0, 0.0, 0.9], n).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.int32))
    want = JD.sample_per_slot(jnp.asarray(logits), jnp.asarray(pred_pos),
                              keys, jnp.asarray(temp), jnp.asarray(topk),
                              jnp.asarray(top_p), JCFG)
    from dalle_pytorch_tpu_torch.ops import prng
    got = TD.sample_per_slot(torch.tensor(logits), torch.tensor(pred_pos),
                             prng.prng_key(torch.tensor(seeds)),
                             torch.tensor(temp), torch.tensor(topk),
                             torch.tensor(top_p), TCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
