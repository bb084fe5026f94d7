"""The DiscreteVAE's own training (``models/vae.py::DiscreteVAE``,
``gumbel_softmax``, ``vae_apply``; ``parallel/train.py::vae_loss_fn``)
against the JAX package on the CPU, at a tiny VAE (16 px, 32 codes of
16, 2 layers, hidden 8, with and without a resnet block), the whole
``vae_init`` tree bridged by ``compat/from_jax.py::discrete_vae_from_jax``.

Covered: the Gumbel noise and ``gumbel_softmax`` (soft and
straight-through); ``vae_apply``'s logits, reconstruction and
reconstruction loss for soft and straight-through at the config's
temperature and at an override; ``vae_loss_fn`` with and without
``smooth_l1`` and the gradient of every parameter; three Adam steps of
``make_train_step`` against optax; and the ``DiscreteVAE`` facade's
``get_codebook_indices`` and ``decode``.

float32. Tolerances: reconstructions and losses rtol/atol 1e-5;
gradients rtol 1e-4 / atol 2e-5 (f32 sums in another order: the
codebook mix is one matrix product on both sides, the convolutions are
XLA's and oneDNN's); parameters after Adam steps atol 2e-5, as
``test_torch_train``. The float32 Gumbel noise agrees to an ulp or two
(``ops/prng.py``), well inside these.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.cli import common as TCOM
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel import train as TP


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
              hidden_dim=8)


def cfgs(**kw):
    return JV.VAEConfig(**VAE_KW, **kw), TV.VAEConfig(**VAE_KW, **kw)


@pytest.fixture(scope="module", params=[0, 1], ids=["res0", "res1"])
def bundle(request):
    """(JAX tree, port DiscreteVAE) at 0 and 1 resnet blocks."""
    jcfg, tcfg = cfgs(num_resnet_blocks=request.param)
    params = jax.device_get(JV.vae_init(jax.random.PRNGKey(0), jcfg))
    return params, from_jax.discrete_vae_from_jax(params, tcfg,
                                                  device="cpu"), \
        request.param


IMAGES = np.random.RandomState(1).uniform(-1, 1, (3, 16, 16, 3)).astype(
    np.float32)


def port_cfg(bundle, **kw):
    return cfgs(num_resnet_blocks=bundle[2], **kw)


@pytest.mark.parametrize("straight_through", [False, True])
def test_gumbel_softmax_matches_jax(straight_through):
    logits = np.random.RandomState(2).randn(2, 4, 4, 32).astype(np.float32)
    want = JV.gumbel_softmax(jax.random.PRNGKey(7), jnp.asarray(logits),
                             0.9, straight_through)
    got = TV.gumbel_softmax(prng.prng_key(7), torch.tensor(logits), 0.9,
                            straight_through)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if straight_through:
        assert bool(((got == 0) | (got == 1)).all())
        assert bool((got.sum(-1) == 1).all())


@pytest.mark.parametrize("temperature", [None, 0.5])
@pytest.mark.parametrize("straight_through", [False, True])
def test_vae_apply_matches_jax(bundle, straight_through, temperature):
    params, vae, _ = bundle
    jcfg, tcfg = port_cfg(bundle, straight_through=straight_through)
    jx, tx = jnp.asarray(IMAGES), torch.tensor(IMAGES)
    kw = dict(temperature=temperature)
    with torch.no_grad():
        np.testing.assert_allclose(
            TV.vae_apply(vae, tx, cfg=tcfg, return_logits=True).numpy(),
            np.asarray(JV.vae_apply(params, jx, cfg=jcfg,
                                    return_logits=True)), **TOL)
        recon = TV.vae_apply(vae, tx, cfg=tcfg, rng=prng.prng_key(4), **kw)
        loss = TV.vae_apply(vae, tx, cfg=tcfg, rng=prng.prng_key(4),
                            return_recon_loss=True, **kw)
        # the facade's forward is vae_apply under the module's own config
        torch.testing.assert_close(
            vae(tx, prng.prng_key(4), **kw),
            TV.vae_apply(vae, tx, cfg=vae.cfg, rng=prng.prng_key(4), **kw),
            rtol=0, atol=0)
    jrecon = JV.vae_apply(params, jx, cfg=jcfg, rng=jax.random.PRNGKey(4),
                          **kw)
    jloss = JV.vae_apply(params, jx, cfg=jcfg, rng=jax.random.PRNGKey(4),
                         return_recon_loss=True, **kw)
    assert recon.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    with pytest.raises(ValueError, match="PRNG key"):
        TV.vae_apply(vae, tx, cfg=tcfg)


@pytest.mark.parametrize("smooth_l1", [False, True])
@pytest.mark.parametrize("straight_through", [False, True])
def test_vae_loss_and_every_gradient_match_jax(bundle, smooth_l1,
                                               straight_through):
    params, _, _ = bundle
    jcfg, tcfg = port_cfg(bundle, straight_through=straight_through)
    vae = from_jax.discrete_vae_from_jax(params, tcfg, device="cpu")
    jloss, jgrads = jax.value_and_grad(JP.vae_loss_fn(
        jcfg, smooth_l1=smooth_l1, temperature=0.7))(
        params, {"images": jnp.asarray(IMAGES)}, jax.random.PRNGKey(5))
    loss = TP.vae_loss_fn(tcfg, smooth_l1=smooth_l1, temperature=0.7)(
        vae, {"images": torch.tensor(IMAGES)}, prng.prng_key(5))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(from_jax.discrete_vae_from_jax(
        jax.device_get(jgrads), tcfg, device="cpu").named_parameters())
    names = [n for n, _ in vae.named_parameters()]
    assert sorted(names) == sorted(want) and len(names) >= 13
    for name, p in vae.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_three_adam_steps_match_optax(bundle):
    params, _, _ = bundle
    jcfg, tcfg = port_cfg(bundle)
    vae = from_jax.discrete_vae_from_jax(params, tcfg, device="cpu")
    args = types.SimpleNamespace(lr=3e-3, lr_schedule="cosine",
                                 warmup_steps=1, decay_steps=6,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.vae_loss_fn(jcfg, smooth_l1=True), jopt)
    jparams, state = params, jopt.init(params)
    tstep = TP.make_train_step(TP.vae_loss_fn(tcfg, smooth_l1=True),
                               TCOM.make_optimizer(args, vae.parameters()))
    batch = {"images": IMAGES}
    for i in range(3):
        jparams, state, jloss = jstep(
            jparams, state, {"images": jnp.asarray(IMAGES)},
            JCOM.step_rng(jax.random.PRNGKey(9), i))
        tloss = tstep(vae, {"images": torch.tensor(batch["images"])},
                      TCOM.step_rng(prng.prng_key(9), i))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.discrete_vae_from_jax(
        jax.device_get(jparams), tcfg, device="cpu").named_parameters())
    start = dict(from_jax.discrete_vae_from_jax(
        params, tcfg, device="cpu").named_parameters())
    moved = 0.0
    for name, p in vae.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)
        moved = max(moved, float((p - start[name]).detach().abs().max()))
    assert moved > 1e-3


def test_facade_indices_and_decode_match_jax(bundle):
    params, vae, _ = bundle
    jx = jnp.asarray(IMAGES)
    ids = vae.get_codebook_indices(torch.tensor(IMAGES))
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(JV.get_codebook_indices(params, jx)))
    with torch.no_grad():
        img = vae.decode(ids)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(JV.decode(params, jnp.asarray(ids.numpy()))),
        **TOL)
    # the halves and the whole share one parameter layout
    tcfg = port_cfg(bundle)[1]
    dec = from_jax.vae_from_jax(params, tcfg, device="cpu")
    enc = from_jax.vae_encoder_from_jax(params, tcfg, device="cpu")
    whole = {n for n, _ in vae.named_parameters()}
    assert whole == ({n for n, _ in dec.named_parameters()}
                     | {n for n, _ in enc.named_parameters()})
    fresh = TV.discrete_vae_init(tcfg, seed=3, device="cpu")
    assert {n for n, _ in fresh.named_parameters()} == whole
    assert TV.VAEConfig().temperature == 0.9
    assert not TV.VAEConfig().straight_through
