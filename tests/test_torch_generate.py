"""One-shot generation (``generate_images``) of the port against the JAX
package on the CPU, at ``bench.py::build_cfg(tiny=True)``'s widths (dim
32, depth 2, 2 heads of 16, text 8 + image 16 tokens): the same weights
through the bridge, the same prompt, the same key.

The sampled tokens must be IDENTICAL: in float32 for every option
(top-k, nucleus, temperature, a short prompt, a pad mask, guidance, an
int8 cache, int8 weights), in bfloat16 for top-k, guidance, nucleus and
temperature, where the sampler's dtype matters (bfloat16 Gumbel noise
over the whole batch, the temperature divided in bfloat16).
The images then differ only by the VAE decoder's summation order:
float32 rtol/atol 1e-5, bfloat16 2e-2 (a bf16 rounding of the output on
either side). The dense KV cache and its decode step are held to 1e-5
in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import decode as JDEC
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import prng


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
                heads=2, dim_head=16)
JCFG = JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **DALLE_KW)
TCFG = TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **DALLE_KW)
# a CLIP over the tiny DALLE's vocabulary and its 16 px images
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
               text_enc_depth=1, text_seq_len=8, text_heads=2,
               visual_enc_depth=1, visual_heads=2, visual_image_size=16,
               visual_patch_size=4)

RS = np.random.RandomState(0)
TEXT = RS.randint(1, 64, (2, 8))
MASK = np.ones((2, 8), bool)
MASK[0, :3] = False                     # a left-padded caption


def to_bf16(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16)
                        if np.asarray(a).dtype == np.float32 else a, tree)


def make_bundle(dtype):
    key = jax.random.PRNGKey(0)
    vp = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JCFG.vae))
    params = jax.device_get(JD.dalle_init(key, JCFG, vp))
    if dtype == "bfloat16":
        vp, params = to_bf16(vp), to_bf16(params)
    return {"params": params, "vae_params": vp,
            "model": from_jax.dalle_from_jax(params, TCFG, device="cpu"),
            "vae": from_jax.vae_from_jax(vp, TCFG.vae, device="cpu")}


@pytest.fixture(scope="module")
def f32():
    return make_bundle("float32")


@pytest.fixture(scope="module")
def bf16():
    return make_bundle("bfloat16")


def generate_both(bundle, text, *, quantized_weights=False, **kw):
    """(JAX images, JAX ids, port images, port ids) for one call."""
    params, model = bundle["params"], bundle["model"]
    if quantized_weights:
        params = JD.quantize_for_decode(params)
        model = TD.quantize_for_decode(model)
    jkw, tkw = dict(kw), dict(kw)
    if "mask" in kw:
        jkw["mask"] = jnp.asarray(kw["mask"])
        tkw["mask"] = torch.tensor(kw["mask"])
    ji, jseq = JD.generate_images(params, bundle["vae_params"],
                                  jnp.asarray(text), cfg=JCFG,
                                  rng=jax.random.PRNGKey(3),
                                  return_img_seq=True, **jkw)
    ti, tseq = TD.generate_images(model, bundle["vae"], torch.tensor(text),
                                  rng=prng.prng_key(3), return_img_seq=True,
                                  **tkw)
    return (np.asarray(ji).astype(np.float32), np.asarray(jseq),
            ti.float().numpy(), tseq.numpy())


CASES = {
    "top_k": dict(),
    "top_p": dict(top_p=0.9),
    "temperature": dict(temperature=1.3),
    "short_prompt": dict(text=TEXT[:, :3]),
    "mask": dict(mask=MASK),
    "guidance": dict(guidance=3.0),
    "quantize_cache": dict(quantize_cache=True),
    "quantize_for_decode": dict(quantized_weights=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_tokens_identical_to_jax_float32(f32, case):
    kw = dict(CASES[case])
    text = kw.pop("text", TEXT)
    ji, jseq, ti, tseq = generate_both(f32, text, **kw)
    assert tseq.shape == (2, TCFG.image_seq_len)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["top_k", "guidance", "top_p",
                                  "temperature"])
def test_generate_tokens_identical_to_jax_bfloat16(bf16, case):
    ji, jseq, ti, tseq = generate_both(bf16, TEXT, **CASES[case])
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(ti, ji, rtol=2e-2, atol=2e-2)


def test_generate_guided_mask_and_short_prompt_together(f32):
    """Guidance with a padded short prompt: the null stream's all-True
    mask rides beside the padded one, and the text span is completed
    under guidance (text positions sample from the conditional stream)."""
    mask = np.ones((2, 5), bool)
    mask[1, :2] = False
    _, jseq, _, tseq = generate_both(f32, TEXT[:, :5], mask=mask,
                                     guidance=2.0, top_p=0.8)
    np.testing.assert_array_equal(tseq, jseq)


def test_generate_clip_rerank_scores_match_jax(f32):
    """The rerank scores the sampled captions against the images: float32
    rtol/atol 1e-5."""
    jcc, tcc = JC.CLIPConfig(**CLIP_KW), TC.CLIPConfig(**CLIP_KW)
    cp = jax.device_get(JC.clip_init(jax.random.PRNGKey(5), jcc))
    clip = from_jax.clip_from_jax(cp, tcc, device="cpu")
    ji, js = JD.generate_images(f32["params"], f32["vae_params"],
                                jnp.asarray(TEXT[:, :4]), cfg=JCFG,
                                rng=jax.random.PRNGKey(3), clip_params=cp,
                                clip_cfg=jcc)
    ti, ts = TD.generate_images(f32["model"], f32["vae"],
                                torch.tensor(TEXT[:, :4]),
                                rng=prng.prng_key(3), clip=clip)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5,
                               atol=1e-5)
    assert ts.shape == (2,) and bool(torch.isfinite(ts).all())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_generate_rejects_a_clip_vocab_smaller_than_dalles(f32):
    small = TC.clip_init(TC.CLIPConfig(**dict(CLIP_KW, num_text_tokens=32)),
                         device="cpu")
    with pytest.raises(ValueError, match="num_text_tokens"):
        TD.generate_images(f32["model"], f32["vae"], torch.tensor(TEXT),
                           rng=prng.prng_key(0), clip=small)


def test_bf16_categorical_draw_equals_jax_on_a_fixed_key():
    """One key over a (rows, V) batch of bfloat16 logits: the noise has
    the logits' full shape and dtype, and ties (common in bfloat16) go to
    the first maximum on both sides."""
    rs = np.random.RandomState(11)
    logits = (rs.randn(6, 2049) * 2).astype(np.float32)
    logits[:, ::5] = -3.0e38
    lg = jnp.asarray(logits, jnp.bfloat16)
    tl = torch.tensor(np.asarray(lg).astype(np.float32)).to(torch.bfloat16)
    for pos in (8, 9, 1279):
        key = jax.random.fold_in(jax.random.PRNGKey(7), pos)
        want = np.asarray(jax.random.categorical(key, lg, axis=-1))
        got = prng.categorical(prng.fold_in(prng.prng_key(7), pos), tl)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quantize", [False, True])
@torch.no_grad()
def test_dense_cache_prefill_and_decode_steps_match_jax(f32, quantize):
    """``prefill`` with a prompt mask into the dense cache, then three
    ``decode_step``s (scalar positions) against JAX's: h_out and every
    cache buffer to 1e-5 (the int8 rows exactly)."""
    params, model = f32["params"], f32["model"]
    text = TEXT[:, :5]
    mask = MASK[:, :5]
    L = JCFG.seq_len
    jx = JD.embed_prompt(params, JCFG, jnp.asarray(text))
    jh, jcache = JDEC.prefill(params["transformer"], jx,
                              cfg=JCFG.transformer, total_len=L,
                              prompt_mask=jnp.asarray(mask),
                              quantize_cache=quantize)
    th, tcache = TDEC.prefill(model.transformer,
                              TD.embed_prompt(model, torch.tensor(text)),
                              cfg=TCFG.transformer, total_len=L,
                              prompt_mask=torch.tensor(mask),
                              quantize_cache=quantize)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    jkm = JDEC._full_key_mask(jnp.asarray(mask), 2, 5, L)
    tkm = TDEC._full_key_mask(torch.tensor(mask), 2, 5, L)
    np.testing.assert_array_equal(tkm.numpy(), np.asarray(jkm))
    tok = np.random.RandomState(2).randint(0, 64, (3, 2))
    for step, pos in enumerate((5, 6, 7)):
        jh, jcache = JDEC.decode_step(
            params["transformer"],
            JD.decode_token_embed(params, JCFG, jnp.asarray(tok[step]),
                                  jnp.full((2,), pos)),
            pos, jcache, cfg=JCFG.transformer, key_mask=jkm)
        th = TDEC.decode_step(
            model.transformer,
            TD.decode_token_embed(model, torch.tensor(tok[step]),
                                  torch.full((2,), pos)),
            pos, tcache, cfg=TCFG.transformer, key_mask=tkm)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
    assert set(tcache) == set(jcache)
    for name, buf in tcache.items():
        if buf.dtype == torch.int8:
            # a rounding at a .5 boundary may flip one step either way
            assert int((buf.int() - torch.tensor(np.asarray(
                jcache[name])).int()).abs().max()) <= 1
        else:
            np.testing.assert_allclose(buf.numpy(), np.asarray(jcache[name]),
                                       rtol=1e-5, atol=1e-5)


def test_store_rows_per_slot_matches_jax():
    """Per-row positions: row i writes cache row pos[i] of its own batch
    entry, in place, quantized like the contiguous write."""
    rs = np.random.RandomState(4)
    cfg = TCFG.transformer
    ks, vs = (rs.randn(2, 3, 2, 1, 16).astype(np.float32) for _ in range(2))
    pos = np.array([4, 0, 23])
    for quantized in (False, True):
        jc = JDEC.init_cache(JCFG.transformer, 3, 24, quantized=quantized)
        jc = JDEC._store_rows(jc, jnp.asarray(ks), jnp.asarray(vs),
                              jnp.asarray(pos))
        tc = TDEC.init_cache(cfg, 3, 24, quantized=quantized)
        TDEC._store_rows(tc, torch.tensor(ks), torch.tensor(vs),
                         torch.tensor(pos))
        for name in jc:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
