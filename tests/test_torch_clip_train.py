"""CLIP's training (``parallel/train.py::clip_loss_fn``) against the JAX
package on the CPU: a tiny CLIP (32 wide, one text and one visual
layer of 2 heads, text 20 tokens padded to blocks of 16, 16 px images
in 4 px patches), the weights bridged by ``compat/from_jax.py``,
captions with padded tails (the text mask on).

Covered: the InfoNCE loss and the gradient of every parameter with
``sparse_impl`` 'ref' (the dense oracle) and 'pallas' (on the card
kernel K3 with ``causal=False`` and its plain backward; here its plain
version), and with dense attention; and three Adam steps of
``make_train_step`` against optax.

float32. Tolerances: losses rtol/atol 1e-5; gradients rtol 1e-4 / atol
2e-5 (f32 sums in another order), parameters after Adam steps atol
2e-5, as ``test_torch_train``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.cli import common as TCOM
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
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
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
               text_enc_depth=1, text_seq_len=20, text_heads=2,
               visual_enc_depth=1, visual_heads=2, visual_image_size=16,
               visual_patch_size=4)
B = 4


def cfgs(**kw):
    return JC.CLIPConfig(**CLIP_KW, **kw), TC.CLIPConfig(**CLIP_KW, **kw)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(JC.clip_init(jax.random.PRNGKey(0), cfgs()[0]))


@pytest.fixture(scope="module")
def batch_np():
    rs = np.random.RandomState(5)
    mask = np.ones((B, 20), bool)
    mask[0, 12:] = False                   # padded caption tails
    mask[2, 3:] = False
    return {"text": rs.randint(1, 64, (B, 20)).astype(np.int32),
            "mask": mask,
            "images": rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)}


def tbatch(b):
    out = {k: torch.tensor(v) for k, v in b.items()}
    out["text"] = out["text"].long()
    return out


@pytest.mark.parametrize("kw", [dict(sparse_impl="ref"),
                                dict(sparse_impl="pallas"),
                                dict(sparse_attn=False)],
                         ids=["ref", "pallas", "dense"])
def test_clip_loss_and_every_gradient_match_jax(params, batch_np, kw):
    jcfg, tcfg = cfgs(**kw)
    model = from_jax.clip_from_jax(params, tcfg, device="cpu")
    jloss, jgrads = jax.value_and_grad(JP.clip_loss_fn(jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()},
        jax.random.PRNGKey(0))
    loss = TP.clip_loss_fn()(model, tbatch(batch_np), prng.prng_key(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(from_jax.clip_from_jax(jax.device_get(jgrads), tcfg,
                                       device="cpu").named_parameters())
    n = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)
        n += 1
    assert n == len(want) > 20
    # the padded tails are masked: another pad token changes nothing
    other = dict(batch_np, text=np.where(batch_np["mask"], batch_np["text"],
                                         7).astype(np.int32))
    with torch.no_grad():
        again = TP.clip_loss_fn()(model, tbatch(other), prng.prng_key(0))
    np.testing.assert_allclose(float(again), float(loss.detach()), **TOL)


def test_three_adam_steps_match_optax(params, batch_np):
    jcfg, tcfg = cfgs(sparse_impl="pallas")
    model = from_jax.clip_from_jax(params, tcfg, device="cpu")
    args = types.SimpleNamespace(lr=3e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=1.0)
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.clip_loss_fn(jcfg), jopt)
    jparams, state = params, jopt.init(params)
    tstep = TP.make_train_step(TP.clip_loss_fn(),
                               TCOM.make_optimizer(args, model.parameters()))
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    for i in range(3):
        jparams, state, jloss = jstep(jparams, state, jb,
                                      jax.random.PRNGKey(i))
        tloss = tstep(model, tbatch(batch_np), prng.prng_key(i))
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.clip_from_jax(jax.device_get(jparams), tcfg,
                                       device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)
