"""The port's block-sparse DALLE training against the JAX package's, on
the CPU: a tiny DALLE (dim 32, 2 heads of 16, text 8, VAE 16 px,
sequence 24) with ``sparse_attn=(True, False)`` — a block-sparse layer,
then a dense flash layer whose backward is the split kernels — for
each ``sparse_impl`` ('ref', 'windowed', 'pallas'), with bridged
weights. ``sparse_block=4`` makes the window (16 tokens) narrower than
the sequence, so the layout is not merely causal; block 16 is the
reference's. JAX runs its Pallas kernels in interpret mode, the port
its kernels' plain versions.

float32 throughout. Tolerances, as in tests/test_torch_train.py: losses
rtol/atol 1e-5; gradients rtol 1e-4, atol 2e-5 (f32 math in another
summation order; dropout's kept values differ by an ulp); parameters
after two Adam steps (the warmup-cosine schedule and clip 1.0 of
tests/test_torch_train.py) atol 2e-5, since Adam's step is lr * m_hat /
(sqrt(v_hat) + eps) whatever the gradient's scale.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
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
from dalle_pytorch_tpu_torch.ops import block_sparse as TB
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
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16, sparse_attn=(True, False),
                attn_impl="flash", attn_bwd_impl="pallas", attn_dropout=0.1,
                ff_dropout=0.1, loss_chunk=10)
B = 4


def cfgs(**kw):
    """The JAX and the port's config with the same fields."""
    fields = {**DALLE_KW, **kw}
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **fields),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **fields))


def init_trees(**kw):
    key = jax.random.PRNGKey(0)
    jcfg, _ = cfgs(**kw)
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae))
    return jax.device_get(JD.dalle_init(key, jcfg, vae)), vae


@pytest.fixture(scope="module")
def trees():
    return init_trees()


# the tiny DALLE with its heads wider than 128: 2 heads of 192, the width
# the wide bodies (K3's, and the flash kernels' of the dense layer) take
# as they are, and their bfloat16 tensor-core bodies run on the card
WIDE_HEADS = dict(heads=2, dim_head=192)


@pytest.fixture(scope="module")
def wide_trees():
    return init_trees(**WIDE_HEADS)


@pytest.fixture(scope="module")
def batch_np():
    rs = np.random.RandomState(3)
    text = rs.randint(1, 64, (B, 8)).astype(np.int32)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False                    # padded text: pad keys
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


def check_loss_logits_and_gradients(trees, batch_np, **kw):
    """Eval logits, then the train-mode loss and every parameter's
    gradient of the port's model against JAX's from the same weights, at
    the module's tolerances; returns (model, its encoder, the batch)."""
    jcfg, tcfg = cfgs(**kw)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    jb, tb = jbatch(batch_np), tbatch(batch_np)
    # eval logits
    want = JD.dalle_apply(dalle, jb["text"], jb["image"], cfg=jcfg,
                          mask=jb["mask"], vae_params=vae)
    got = TD.dalle_apply(model, tb["text"], tb["image"], mask=tb["mask"],
                         vae=enc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # train-mode loss and every gradient
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg, vae))(
        dalle, jb, jax.random.PRNGKey(5))
    before = TB.block_sparse_attention_fwd.launches
    loss = TP.dalle_loss_fn(enc)(model, tb, prng.prng_key(5))
    loss.backward()
    assert TB.block_sparse_attention_fwd.launches == before   # CPU: plain
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(jgrads), tcfg,
                                        device="cpu").named_parameters())
    n = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=name)
        n += 1
    assert n == len(want) > 20
    return model, enc, tb


@pytest.mark.parametrize("impl,block", [("ref", 4), ("windowed", 4),
                                        ("pallas", 4), ("pallas", 16)])
def test_sparse_loss_logits_and_gradients_match_jax(trees, batch_np, impl,
                                                    block):
    model, enc, tb = check_loss_logits_and_gradients(
        trees, batch_np, sparse_impl=impl, sparse_block=block)
    # the sparse layer's attention gradient is not the dense one's
    dense = TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW),
                           **{**DALLE_KW, "sparse_attn": False})
    dmodel, _ = port_of(trees, dense)
    TP.dalle_loss_fn(enc)(dmodel, tb, prng.prng_key(5)).backward()
    qkv = "transformer.layers.0.attn.qkv.weight"
    if block == 4:
        assert float((dict(dmodel.named_parameters())[qkv].grad
                      - dict(model.named_parameters())[qkv].grad)
                     .abs().max()) > 1e-4


@pytest.mark.parametrize("block", [4, 16])
def test_wide_head_sparse_loss_logits_and_gradients_match_jax(
        wide_trees, batch_np, block):
    """The block-sparse DALLE with 2 heads of 192 under
    ``sparse_impl='pallas'``: K3's and the dense layer's flash kernels'
    plain versions at a width above 128 against JAX's Pallas kernels in
    interpret mode, loss, logits and every gradient at the module's
    tolerances."""
    check_loss_logits_and_gradients(wide_trees, batch_np,
                                    sparse_impl="pallas",
                                    sparse_block=block, **WIDE_HEADS)


@pytest.mark.parametrize("impl", ["ref", "windowed", "pallas"])
def test_two_adam_steps_match_optax(trees, batch_np, impl):
    jcfg, tcfg = cfgs(sparse_impl=impl, sparse_block=4)
    model, enc = port_of(trees, tcfg)
    dalle, vae = trees
    args = types.SimpleNamespace(lr=3e-3, lr_schedule="cosine",
                                 warmup_steps=2, decay_steps=6,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=1.0)
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.dalle_loss_fn(jcfg, vae), jopt)
    params, state = dalle, jopt.init(dalle)
    tstep = TP.make_train_step(TP.dalle_loss_fn(enc),
                               TCOM.make_optimizer(args, model.parameters()))
    jkey, tkey = jax.random.PRNGKey(9), prng.prng_key(9)
    for i in range(2):
        params, state, jloss = jstep(params, state, jbatch(batch_np),
                                     JCOM.step_rng(jkey, i))
        tloss = tstep(model, tbatch(batch_np), TCOM.step_rng(tkey, i))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(params), tcfg,
                                        device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)


def test_sparse_config_checks_and_what_still_raises():
    _, tcfg = cfgs(sparse_impl="pallas")
    assert tcfg.transformer.sparse_pattern == (True, False)
    assert tcfg.transformer.sparse_impl == "pallas"
    assert tcfg.transformer.sparse_block == 16
    with pytest.raises(ValueError, match="sparse impl"):
        cfgs(sparse_impl="triton")
    with pytest.raises(ValueError, match="flags for depth"):
        cfgs(sparse_attn=(True, False, True))
    for option in (dict(reversible=True), dict(moe_experts=4),
                   dict(remat="full")):
        assert cfgs(**option)[1].transformer.sparse_pattern == (True, False)
    for refused in (dict(reversible=True, moe_experts=4),
                    dict(moe_experts=2, moe_k=3), dict(remat="all")):
        with pytest.raises(ValueError):
            cfgs(**refused)
    assert TT._pattern_period((True, False) * 32) == 2
    assert TT._pattern_period((True, False, False, False, True)) == 5
    assert TT._pattern_period((True,) * 6) == 1
