"""The reference-API facades (``DALLE``, ``CLIP``, ``DiscreteVAE`` from
the package root) and ``utils/debug.py`` against the JAX package's, on
the CPU.

Each facade is built with the reference's keywords and the JAX facade's
weights (``params=``, a JAX tree as numpy arrays, through
``compat.from_jax``), then: the VAE's properties, forward (Gumbel mix
under the same key), ``get_codebook_indices`` and ``decode``; CLIP's
scores and loss; DALLE's logits (text only, image tokens, raw images
through its VAE) and loss, and ``generate_images`` with and without a
CLIP rerank — float32 to rtol/atol 1e-5, codebook indices and sampled
tokens identical. Also: the root exports are lazy, the config
constructors still build bare containers, a seeded facade ties DALLE's
image embedding to the VAE's codebook, and ``check_finite_tree`` /
``guard_loss`` raise as JAX's do.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dalle_pytorch_tpu as J
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.utils import debug as JDBG
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.utils import debug as TDBG

VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(num_text_tokens=64, text_seq_len=8, heads=2, dim_head=16)
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
               text_enc_depth=1, text_seq_len=8, text_heads=2,
               visual_enc_depth=1, visual_heads=2, visual_image_size=16,
               visual_patch_size=4)
RS = np.random.RandomState(3)
TEXT = RS.randint(1, 64, (2, 8))
IMAGES = RS.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def facades():
    """Both packages' facades on the same weights."""
    import dalle_pytorch_tpu_torch as T
    jvae = J.DiscreteVAE(jax.random.PRNGKey(1), **VAE_KW)
    jdalle = J.DALLE(dim=32, vae=jvae, depth=2, key=jax.random.PRNGKey(0),
                     **DALLE_KW)
    jclip = J.CLIP(jax.random.PRNGKey(7), **CLIP_KW)
    tvae = T.DiscreteVAE(**VAE_KW, params=np_tree(jvae.params),
                         device="cpu")
    tdalle = T.DALLE(dim=32, vae=tvae, depth=2,
                     params=np_tree(jdalle.params), device="cpu",
                     **DALLE_KW)
    tclip = T.CLIP(**CLIP_KW, params=np_tree(jclip.params), device="cpu")
    return (jvae, jdalle, jclip), (tvae, tdalle, tclip)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **TOL)


# -- DiscreteVAE --------------------------------------------------------------

def test_vae_properties_equal_jax(facades):
    (jvae, _, _), (tvae, _, _) = facades
    for name in ("image_size", "num_tokens", "num_layers", "temperature"):
        assert getattr(tvae, name) == getattr(jvae, name), name
    assert tvae.config == tvae.cfg


def test_vae_forward_indices_and_decode_equal_jax(facades):
    (jvae, _, _), (tvae, _, _) = facades
    imgs = torch.from_numpy(IMAGES)
    close(tvae(imgs, rng=prng.prng_key(5)),
          jvae(jnp.asarray(IMAGES), rng=jax.random.PRNGKey(5)))
    close(tvae(imgs, return_logits=True),
          jvae(jnp.asarray(IMAGES), return_logits=True))
    ids = tvae.get_codebook_indices(imgs)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jvae.get_codebook_indices(
            jnp.asarray(IMAGES))))
    close(tvae.decode(ids), jvae.decode(jnp.asarray(ids.numpy())))


# -- CLIP ---------------------------------------------------------------------

def test_clip_forward_and_loss_equal_jax(facades):
    (_, _, jclip), (_, _, tclip) = facades
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    args_t = (torch.from_numpy(TEXT), torch.from_numpy(IMAGES))
    args_j = (jnp.asarray(TEXT), jnp.asarray(IMAGES))
    close(tclip(*args_t), jclip(*args_j))
    close(tclip(*args_t, text_mask=torch.from_numpy(mask),
                return_loss=True),
          jclip(*args_j, text_mask=jnp.asarray(mask), return_loss=True))
    assert tclip.config == tclip.cfg


# -- DALLE --------------------------------------------------------------------

def test_dalle_forward_and_loss_equal_jax(facades):
    (jvae, jdalle, _), (tvae, tdalle, _) = facades
    text_t, text_j = torch.from_numpy(TEXT), jnp.asarray(TEXT)
    close(tdalle(text_t[:, :5]), jdalle(text_j[:, :5]))
    ids = RS.randint(0, 32, (2, 16))
    close(tdalle(text_t, torch.from_numpy(ids)),
          jdalle(text_j, jnp.asarray(ids)))
    # raw images are tokenised through the held VAE
    close(tdalle(text_t, torch.from_numpy(IMAGES), return_loss=True),
          jdalle(text_j, jnp.asarray(IMAGES), return_loss=True))
    assert tdalle.vae is tvae and tdalle.config == tdalle.cfg
    # the held VAE is not part of DALLE's own state
    assert not any(k.startswith("vae") for k in tdalle.state_dict())


@pytest.mark.parametrize("with_clip", [False, True], ids=["plain", "clip"])
def test_dalle_generate_images_equals_jax(facades, with_clip):
    (jvae, jdalle, jclip), (tvae, tdalle, tclip) = facades
    text = TEXT[:1]
    kw = dict(filter_thres=0.9, temperature=0.8)
    got = tdalle.generate_images(torch.from_numpy(text), rng=prng.prng_key(
        11), clip=tclip if with_clip else None, **kw)
    want = jdalle.generate_images(jnp.asarray(text),
                                  rng=jax.random.PRNGKey(11),
                                  clip=jclip if with_clip else None, **kw)
    if with_clip:
        close(got[1], want[1])                    # CLIP scores
        got, want = got[0], want[0]
    close(got, want)
    # the sampled tokens themselves, through the same call
    _, seq_t = TD.generate_images(tdalle, tvae, torch.from_numpy(text),
                                  rng=prng.prng_key(11),
                                  return_img_seq=True, **kw)
    _, seq_j = JD.generate_images(jdalle.params, jvae.params,
                                  jnp.asarray(text), cfg=jdalle.config,
                                  rng=jax.random.PRNGKey(11),
                                  return_img_seq=True, **kw)
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))


def test_generate_images_default_key_is_jax_default(facades):
    (_, jdalle, _), (_, tdalle, _) = facades
    close(tdalle.generate_images(torch.from_numpy(TEXT[:1])),
          jdalle.generate_images(jnp.asarray(TEXT[:1])))


# -- the two ways in ----------------------------------------------------------

def test_config_constructors_still_build_containers():
    from dalle_pytorch_tpu_torch.models import clip as TC
    from dalle_pytorch_tpu_torch.models import vae as TV
    vcfg = TV.VAEConfig(**VAE_KW)
    dcfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, **DALLE_KW)
    assert TD.DALLE(dcfg, device="cpu").vae is None
    assert TV.DiscreteVAE(vcfg, device="cpu").cfg is vcfg
    TC.CLIP(TC.CLIPConfig(**CLIP_KW), device="cpu")
    with pytest.raises(TypeError, match="not both"):
        TD.DALLE(dcfg, dim=32)
    with pytest.raises(TypeError, match="DiscreteVAE"):
        TD.DALLE(dim=32, vae=object(), depth=2, device="cpu")


def test_seeded_facade_ties_the_codebook_and_is_reproducible():
    import dalle_pytorch_tpu_torch as T
    vae = T.DiscreteVAE(**VAE_KW, seed=4, device="cpu")
    a = T.DALLE(dim=32, vae=vae, depth=2, seed=9, device="cpu", **DALLE_KW)
    b = T.DALLE(dim=32, vae=vae, depth=2, seed=9, device="cpu", **DALLE_KW)
    torch.testing.assert_close(a.image_emb.weight, vae.codebook.weight,
                               rtol=0, atol=0)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_facades_run_on_the_card_by_default(monkeypatch):
    import dalle_pytorch_tpu_torch as T
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.DiscreteVAE(**VAE_KW)


def test_root_exports_are_lazy():
    code = ("import sys; import dalle_pytorch_tpu_torch.ops; "
            "assert not [m for m in sys.modules "
            "if m.startswith('dalle_pytorch_tpu_torch.models')]; "
            "from dalle_pytorch_tpu_torch import (DALLE, CLIP, DiscreteVAE,"
            " DALLEConfig, CLIPConfig, VAEConfig); "
            "import dalle_pytorch_tpu_torch.models.dalle as D; "
            "assert DALLE is D.DALLE and DALLEConfig is D.DALLEConfig; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
    import dalle_pytorch_tpu_torch as T
    with pytest.raises(AttributeError):
        T.NotAnExport


# -- utils/debug.py -----------------------------------------------------------

def test_check_finite_tree_names_bad_leaves_as_jax_does():
    tree_j = {"ok": jnp.ones(3), "bad": jnp.array([1.0, np.nan])}
    tree_t = {"ok": torch.ones(3), "bad": torch.tensor([1.0, np.nan])}
    with pytest.raises(FloatingPointError) as ej:
        JDBG.check_finite_tree(tree_j, "params")
    with pytest.raises(FloatingPointError) as et:
        TDBG.check_finite_tree(tree_t, "params")
    assert str(et.value) == str(ej.value)
    TDBG.check_finite_tree({"ok": torch.ones(3)})   # a clean tree passes
    many_j = {f"p{i}": jnp.array([np.inf]) for i in range(10)}
    many_t = {f"p{i}": torch.tensor([np.inf]) for i in range(10)}
    with pytest.raises(FloatingPointError) as ej:
        JDBG.check_finite_tree(many_j)
    with pytest.raises(FloatingPointError) as et:
        TDBG.check_finite_tree(many_t)
    assert str(et.value) == str(ej.value) and str(et.value).endswith("...")


def test_check_finite_tree_walks_a_module():
    lin = torch.nn.Linear(2, 2)
    TDBG.check_finite_tree(lin, "model")
    with torch.no_grad():
        lin.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="model: bias"):
        TDBG.check_finite_tree(lin, "model")


def test_guard_loss_equals_jax():
    assert TDBG.guard_loss(torch.tensor(1.25), 3) \
        == JDBG.guard_loss(jnp.float32(1.25), 3) == 1.25
    for bad in (np.inf, np.nan):
        with pytest.raises(FloatingPointError) as ej:
            JDBG.guard_loss(jnp.float32(bad), 7)
        with pytest.raises(FloatingPointError) as et:
            TDBG.guard_loss(torch.tensor(bad), 7)
        assert str(et.value) == str(ej.value)


def test_enable_nan_checks_toggles_anomaly_mode():
    TDBG.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        TDBG.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
