"""CLIP of the port against the JAX package on the CPU, float32: the same
weights through ``compat/from_jax.py::clip_from_jax``, the same numpy
inputs. Depth 2, dim 32, 2 heads of 64; a text of 20 tokens (not a
multiple of the 16-token sparse block, so every sparse layer pads and
masks its pad keys) and 32 px images in 8 px patches (16 patches). Each
encoder's layers are block-sparse and non-causal, under each
``sparse_impl``: in ``'pallas'`` the port runs K3's plain version on
these CPU tensors and JAX its Pallas kernel in interpret mode.
Latents, scores and the InfoNCE loss to rtol/atol 1e-5 (f32 sums in
another order).

Beside it, K3 with ``causal=False`` — the path the encoders take — and
the guard that keeps a non-causal layer off the static sparse backward
(which hard-codes the causal layout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.ops import block_sparse as JB
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.ops import block_sparse as TB
from dalle_pytorch_tpu_torch.ops import sparse as TS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
               text_enc_depth=2, text_seq_len=20, text_heads=2,
               visual_enc_depth=2, visual_heads=2, visual_image_size=32,
               visual_patch_size=8)
RS = np.random.RandomState(0)
TEXT = RS.randint(1, 64, (3, 20))
TEXT_MASK = np.ones((3, 20), bool)
TEXT_MASK[0, 5:] = False                # a 5-token caption
TEXT_MASK[1, 17:] = False
IMAGES = RS.randn(3, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("impl", ["ref", "windowed", "pallas"])
def test_clip_matches_jax(impl):
    jc = JC.CLIPConfig(sparse_impl=impl, **CLIP_KW)
    tc = TC.CLIPConfig(sparse_impl=impl, **CLIP_KW)
    params = jax.device_get(JC.clip_init(jax.random.PRNGKey(1), jc))
    model = from_jax.clip_from_jax(params, tc, device="cpu")
    assert tc.text_transformer.causal is False and all(
        tc.visual_transformer.sparse_pattern)
    text, mask, images = (jnp.asarray(TEXT), jnp.asarray(TEXT_MASK),
                          jnp.asarray(IMAGES))
    ttext, tmask, timages = (torch.tensor(x) for x in (TEXT, TEXT_MASK,
                                                       IMAGES))
    before = TB.block_sparse_attention_fwd.launches
    with torch.no_grad():
        got = {
            "text": TC.encode_text(model, ttext),
            "text_masked": TC.encode_text(model, ttext, tmask),
            "image": TC.encode_image(model, timages),
            "scores": TC.clip_apply(model, ttext, timages, text_mask=tmask),
            "loss": TC.clip_apply(model, ttext, timages, text_mask=tmask,
                                  return_loss=True)}
    assert TB.block_sparse_attention_fwd.launches == before  # plain on CPU
    want = {
        "text": JC.encode_text(params, text, jc),
        "text_masked": JC.encode_text(params, text, jc, mask),
        "image": JC.encode_image(params, images, jc),
        "scores": JC.clip_apply(params, text, images, cfg=jc,
                                text_mask=mask),
        "loss": JC.clip_apply(params, text, images, cfg=jc, text_mask=mask,
                              return_loss=True)}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    assert got["scores"].shape == (3,) and got["loss"].shape == ()


def test_patchify_and_masked_mean_match_jax():
    for patch in (4, 8):
        np.testing.assert_array_equal(
            TC.patchify(torch.tensor(IMAGES), patch).numpy(),
            np.asarray(JC.patchify(jnp.asarray(IMAGES), patch)))
    x = np.random.RandomState(1).randn(3, 20, 5).astype(np.float32)
    np.testing.assert_allclose(
        TC.masked_mean(torch.tensor(x), torch.tensor(TEXT_MASK)).numpy(),
        np.asarray(JC.masked_mean(jnp.asarray(x), jnp.asarray(TEXT_MASK))),
        **TOL)


def test_clip_init_needs_the_card_unless_cpu_is_asked_for():
    cfg = TC.CLIPConfig(**CLIP_KW)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.clip_init(cfg, seed=0)
    a = TC.clip_init(cfg, seed=3, device="cpu")
    b = TC.clip_init(cfg, seed=3, device="cpu")
    assert float(a.temperature.detach()) == 1.0
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


# -- K3 without the causal constraint --------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [32, 64])
def test_block_sparse_noncausal_plain_matches_jax_kernel(n, masked):
    """K3's plain version with causal=False (the CLIP encoders' layers)
    against JAX ``_bs_fwd`` in interpret mode, with and without a
    key-padding mask (a caption padded from token 5)."""
    rs = np.random.RandomState(n)
    q, k, v = (rs.randn(2, 2, n, 16).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((2, n), bool)
        mask[0, 5:] = False
    out, (m, l) = JB._bs_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if mask is None else jnp.asarray(mask),
                             0.25, False, 16, 4, (0,), n, n, True)
    got = TB.block_sparse_attention_fwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=0.25,
        causal=False, block=16,
        mask=None if mask is None else torch.tensor(mask))
    for g, w, what in zip(got, (out, m, l), ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=what)


def test_noncausal_layer_never_takes_the_static_backward(monkeypatch):
    """``_bs_bwd_static`` builds the causal layout whatever it is given;
    the schedule check refuses a non-causal layer, so at the tile sizes
    where a causal layer takes the static route (n 256, tiles of 128) a
    non-causal one takes the blockwise backward, and its gradients are
    autograd's through ``sparse_attention_ref`` (float32, 1e-4)."""
    assert TB._static_tile_schedule(128, 128, 16, 64, (0,), True) == [0]
    assert TB._static_tile_schedule(128, 128, 16, 64, (0,), False) is None

    def refuse(*args, **kw):
        raise AssertionError("a non-causal layer reached the static "
                             "backward")

    monkeypatch.setattr(TB, "_bs_bwd_static", refuse)
    rs = np.random.RandomState(3)
    q, k, v, do = (torch.tensor(rs.randn(1, 2, 256, 16).astype(np.float32))
                   for _ in range(4))
    mask = torch.ones((1, 256), dtype=torch.bool)
    mask[0, 200:] = False
    grads = {}
    for impl in ("ref", "k3"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        kw = dict(scale=0.25, causal=False, block=16, mask=mask)
        if impl == "ref":
            out = TS.sparse_attention_ref(*leaves, **kw)
        else:
            out = TB.block_sparse_attention(*leaves, block_q=128,
                                            block_k=128, **kw)
        grads[impl] = torch.autograd.grad(out, leaves, do)
    for g, w in zip(grads["k3"], grads["ref"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
