"""The port's DALLE training step against the JAX package's, on the CPU,
at the tiny ``bench.py::build_cfg(tiny=True)`` widths (dim 32, depth 2,
2 heads of 16, text 8, VAE 16 px, sequence 24) with bridged weights.

Covered: ``split`` and ``bernoulli`` bit-equal to ``jax.random``;
``get_codebook_indices`` equal; ``dalle_apply`` logits and loss in eval
mode, dense and chunked, for ``attn_impl`` 'xla' and 'flash'; the
train-mode loss under dropout 0.1 (the masks are bit-equal); the
gradient of every parameter against ``jax.grad`` of ``dalle_loss_fn``
for each flash ``bwd_impl``, and the loss and every gradient at heads=2,
dim_head=192 (the wide kernels' width) under the kernel backwards; three
steps of ``make_train_step`` with ``make_optimizer`` (warmup-cosine, clip
1.0) against optax; and ``grad_accum`` 2. JAX's flash path runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.

float32 throughout. Tolerances: losses and logits rtol/atol 1e-5, and
gradients atol 2e-5 (f32 math in another summation order; dropout's
kept values differ by an ulp, XLA multiplying by 1/keep where torch
divides); parameters after Adam steps atol 2e-5, since Adam's update is
lr * m_hat / (sqrt(v_hat) + eps) whatever the gradient's scale, and
torch's clip divides by norm + 1e-6 where optax divides by norm.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.cli import common as TCOM
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.ops import transformer as TT
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
GRAD_ATOL = 2e-5
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16)
B = 4


def cfgs(**kw):
    """The JAX and the port's config with the same fields."""
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **DALLE_KW, **kw),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **DALLE_KW, **kw))


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(0)
    jcfg, _ = cfgs()
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae))
    return jax.device_get(JD.dalle_init(key, jcfg, vae)), vae


@pytest.fixture(scope="module")
def batch_np():
    rs = np.random.RandomState(3)
    text = rs.randint(1, 64, (B, 8)).astype(np.int32)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False                    # padded text tail
    mask[2, 2:] = False
    images = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    return {"text": text, "mask": mask, "image": images}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    out = {k: torch.tensor(v) for k, v in b.items()}
    out["text"] = out["text"].long()
    return out


def port_of(trees, tcfg):
    dalle, vae = trees
    return (from_jax.dalle_from_jax(dalle, tcfg, device="cpu"),
            from_jax.vae_encoder_from_jax(vae, tcfg.vae, device="cpu"))


def assert_grads_match(model, jgrads, tcfg):
    """Every parameter's .grad against the JAX gradient tree, mapped onto
    the port's parameters by the same bridge that maps the weights."""
    want = dict(from_jax.dalle_from_jax(jgrads, tcfg,
                                        device="cpu").named_parameters())
    n = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   rtol=1e-4, atol=GRAD_ATOL, err_msg=name)
        n += 1
    assert n == len(want) > 20


# -- random bits --------------------------------------------------------------

@pytest.mark.parametrize("p", [0.9, 0.5])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
@pytest.mark.parametrize("shape", [(2,), (12, 2), (2, 3, 4)])
def test_split_and_bernoulli_bit_equal(seed, shape, p):
    k, kt = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.split(k, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(kt, shape).numpy(), want)
    kb, ktb = jax.random.fold_in(k, 1), prng.fold_in(kt, 1)
    np.testing.assert_array_equal(
        prng.bernoulli(ktb, p, (5, 7) + shape).numpy(),
        np.asarray(jax.random.bernoulli(kb, p, (5, 7) + shape)))


# -- VAE tokenizer ------------------------------------------------------------

def test_get_codebook_indices_equal(trees, batch_np):
    _, vae = trees
    enc = from_jax.vae_encoder_from_jax(vae, TV.VAEConfig(**VAE_KW),
                                        device="cpu")
    want = JV.get_codebook_indices(vae, jnp.asarray(batch_np["image"]))
    got = TV.get_codebook_indices(enc, torch.tensor(batch_np["image"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 1
    np.testing.assert_allclose(
        TV.encode_logits(enc, torch.tensor(batch_np["image"]))
        .detach().numpy(),
        np.asarray(JV.encode_logits(vae, jnp.asarray(batch_np["image"]))),
        **TOL)


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("loss_chunk", [0, 10])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_dalle_apply_eval_logits_and_loss(trees, batch_np, attn_impl,
                                          loss_chunk):
    jcfg, tcfg = cfgs(attn_impl=attn_impl, loss_chunk=loss_chunk)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    jb, tb = jbatch(batch_np), tbatch(batch_np)
    for return_loss in (False, True):
        want = JD.dalle_apply(dalle, jb["text"], jb["image"], cfg=jcfg,
                              mask=jb["mask"], vae_params=vae,
                              return_loss=return_loss)
        got = TD.dalle_apply(model, tb["text"], tb["image"], mask=tb["mask"],
                             vae=enc, return_loss=return_loss)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_train_loss_with_dropout_equals_jax(trees, batch_np):
    jcfg, tcfg = cfgs(attn_impl="flash", attn_bwd_impl="pallas",
                      attn_dropout=0.1, ff_dropout=0.1, loss_chunk=10)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    loss_fn, losses = TP.dalle_loss_fn(enc), []
    for seed in (11, 12):
        want = JP.dalle_loss_fn(jcfg, vae)(dalle, jbatch(batch_np),
                                           jax.random.PRNGKey(seed))
        got = loss_fn(model, tbatch(batch_np), prng.prng_key(seed))
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
        losses.append(float(got.detach()))
    # the dropout keys matter: two keys give losses further apart than
    # the tolerance the port is held to
    assert abs(losses[0] - losses[1]) > 5 * TOL["atol"]
    with pytest.raises(ValueError, match="rng"):
        TD.dalle_apply(model, tbatch(batch_np)["text"],
                       tbatch(batch_np)["image"], vae=enc, train=True,
                       return_loss=True)


# -- gradients ------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl,bwd_impl", [
    ("xla", "xla"), ("flash", "xla"), ("flash", "pallas"),
    ("flash", "pallas_fused")])
def test_gradients_of_every_parameter_match_jax(trees, batch_np, attn_impl,
                                                bwd_impl):
    jcfg, tcfg = cfgs(attn_impl=attn_impl, attn_bwd_impl=bwd_impl,
                      attn_dropout=0.1, ff_dropout=0.1, loss_chunk=10)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    jgrads = jax.grad(JP.dalle_loss_fn(jcfg, vae))(
        dalle, jbatch(batch_np), jax.random.PRNGKey(5))
    loss = TP.dalle_loss_fn(enc)(model, tbatch(batch_np), prng.prng_key(5))
    loss.backward()
    assert_grads_match(model, jax.device_get(jgrads), tcfg)


# heads above 128: dim_head 192 is a width the wide bodies take as it is
# (in bfloat16 on the card, K1 and K2b split run the wide tensor-core
# bodies; here the port runs their plain versions)
WIDE_DALLE_KW = dict(DALLE_KW, dim_head=192)


@pytest.fixture(scope="module")
def wide_trees():
    key = jax.random.PRNGKey(0)
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **WIDE_DALLE_KW)
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae))
    return jax.device_get(JD.dalle_init(key, jcfg, vae)), vae


@pytest.mark.parametrize("bwd_impl", ["pallas", "pallas_fused"])
def test_wide_head_loss_and_gradients_match_jax(wide_trees, batch_np,
                                               bwd_impl):
    """The tiny DALLE at heads=2, dim_head=192 with attn_impl 'flash': its
    loss and the gradient of every parameter against ``jax.value_and_grad``
    of ``dalle_loss_fn`` (JAX's Pallas kernels in interpret mode), with
    the same tolerances as ``test_gradients_of_every_parameter_match_jax``
    (loss 1e-5; gradients rtol 1e-4, atol 2e-5)."""
    kw = dict(attn_impl="flash", attn_bwd_impl=bwd_impl, attn_dropout=0.1,
              ff_dropout=0.1, loss_chunk=10)
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **WIDE_DALLE_KW, **kw)
    tcfg = TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **WIDE_DALLE_KW, **kw)
    model, enc = port_of(wide_trees, tcfg)
    dalle, vae = wide_trees
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg, vae))(
        dalle, jbatch(batch_np), jax.random.PRNGKey(5))
    loss = TP.dalle_loss_fn(enc)(model, tbatch(batch_np), prng.prng_key(5))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert_grads_match(model, jax.device_get(jgrads), tcfg)


# -- optimizer steps ------------------------------------------------------------

def schedule_args(**kw):
    base = dict(lr=3e-3, lr_schedule="cosine", warmup_steps=2,
                decay_steps=6, lr_end_ratio=0.1, n_epochs=1,
                clip_grad_norm=1.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_schedules_match_optax():
    """The learning rate of every update against optax's: under a
    constant gradient of 1, Adam's m_hat / sqrt(v_hat) is 1, so optax's
    update i is -lr_i (to the f32 rounding of its bias corrections)."""
    for kw in (dict(), dict(lr_schedule="constant", warmup_steps=0),
               dict(lr_schedule="constant", warmup_steps=3),
               dict(warmup_steps=0, decay_steps=0)):
        args = schedule_args(**kw)
        assert TCOM.resolve_schedule(args, 5) == JCOM.resolve_schedule(args,
                                                                       5)
        jopt = JCOM.make_optimizer(args, steps_per_epoch=5)
        topt = TCOM.make_optimizer(args, [torch.nn.Parameter(
            torch.zeros(()))], steps_per_epoch=5)
        state = jopt.init(jnp.zeros(()))
        for i in range(9):
            upd, state = jopt.update(jnp.float32(1.0), state)
            np.testing.assert_allclose(topt.schedule(i), -float(upd),
                                       rtol=1e-4, atol=1e-12,
                                       err_msg=f"{kw} update {i}")


def test_three_train_steps_match_optax(trees, batch_np):
    jcfg, tcfg = cfgs(attn_impl="flash", attn_bwd_impl="pallas",
                      attn_dropout=0.1, ff_dropout=0.1, loss_chunk=10)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    args = schedule_args()
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.dalle_loss_fn(jcfg, vae), jopt)
    params, state = dalle, jopt.init(dalle)
    tstep = TP.make_train_step(TP.dalle_loss_fn(enc),
                               TCOM.make_optimizer(args, model.parameters()))
    jkey, tkey = jax.random.PRNGKey(9), prng.prng_key(9)
    for i in range(3):
        params, state, jloss = jstep(params, state, jbatch(batch_np),
                                     JCOM.step_rng(jkey, i))
        tloss = tstep(model, tbatch(batch_np), TCOM.step_rng(tkey, i))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(params), tcfg,
                                        device="cpu").named_parameters())
    start = dict(port_of(trees, tcfg)[0].named_parameters())
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)
        moved = max(moved, float((p - start[name]).detach().abs().max()))
    assert moved > 1e-3


def test_grad_accum_2_matches_jax(trees, batch_np):
    jcfg, tcfg = cfgs(attn_impl="flash", attn_bwd_impl="pallas_fused",
                      attn_dropout=0.1, ff_dropout=0.1)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    args = schedule_args(lr_schedule="constant", warmup_steps=0,
                         clip_grad_norm=0.0)
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.dalle_loss_fn(jcfg, vae), jopt,
                               grad_accum=2)
    params, _, jloss = jstep(dalle, jopt.init(dalle), jbatch(batch_np),
                             jax.random.PRNGKey(4))
    tstep = TP.make_train_step(TP.dalle_loss_fn(enc),
                               TCOM.make_optimizer(args, model.parameters()),
                               grad_accum=2)
    tloss = tstep(model, tbatch(batch_np), prng.prng_key(4))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(params), tcfg,
                                        device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)


# -- configuration and devices --------------------------------------------------

def test_unported_options_raise_and_entry_points_need_a_device():
    with pytest.raises(NotImplementedError, match="remat"):
        cfgs(remat="full")
    with pytest.raises(ValueError, match="bwd_impl"):
        TT.TransformerConfig(dim=32, depth=1, seq_len=8,
                             attn_bwd_impl="triton")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TV.vae_encoder_init(TV.VAEConfig(**VAE_KW), seed=0)
    enc = TV.vae_encoder_init(TV.VAEConfig(**VAE_KW), seed=0, device="cpu")
    assert enc.enc_out.weight.device.type == "cpu"
