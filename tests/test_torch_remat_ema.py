"""Rematerialisation (``TransformerConfig.remat``) and the EMA
(``cli/common.py::make_ema``, ``ema_as``) of the port, on the CPU.

Remat: for 'save_ln', 'dots' and 'full' the tiny DALLE's train-mode
loss (dropout 0.1) and every gradient equal both the port's 'none' and
JAX's same mode, for dense attention and for flash with the 'pallas'
backward (JAX's Pallas kernels in interpret mode, the port's plain
versions); how often each mode runs the flash forward (K1's plain
version: once a layer under 'none' and 'save_ln', twice under 'dots'
and 'full', whose backward recomputes it); and that 'save_ln' and
'dots' keep fewer bytes for the backward than 'none'.

EMA: the float32 accumulator moves under bfloat16 parameters (JAX
``tests/test_ema.py:24``), equals JAX's update, ``ema_decay <= 0``
gives (None, None), ``ema_as`` casts to the parameters' dtypes, and a
resume path without an EMA starts from the parameters.

float32. Tolerances: losses rtol/atol 1e-5; gradients rtol 1e-4 / atol
2e-5 against JAX, as ``test_torch_train``; against the port's own
'none' the recompute runs the same ops on the same inputs, so exactly.
"""

import argparse

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
from dalle_pytorch_tpu_torch.ops import flash_attention as FA
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
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16, attn_dropout=0.1, ff_dropout=0.1,
                loss_chunk=10)
B = 4
MODES = ("save_ln", "dots", "full")


def cfgs(**kw):
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **DALLE_KW, **kw),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **DALLE_KW, **kw))


@pytest.fixture(scope="module")
def params():
    return jax.device_get(JD.dalle_init(jax.random.PRNGKey(0), cfgs()[0]))


@pytest.fixture(scope="module")
def batch_np():
    rs = np.random.RandomState(3)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    return {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
            "mask": mask,
            "image": rs.randint(0, 32, (B, 16)).astype(np.int32)}


def tbatch(b):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in b.items()}


def port_step(params, tcfg, batch_np):
    """(loss, {name: grad}, K1 forwards run, bytes saved for backward)
    of one train-mode loss and its backward."""
    model = from_jax.dalle_from_jax(params, tcfg, device="cpu")
    fwd = FA.flash_attention_fwd_plain
    runs, saved = [0], [0]

    def counting(*a, **kw):
        runs[0] += 1
        return fwd(*a, **kw)

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    FA.flash_attention_fwd_plain = counting
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = TP.dalle_loss_fn()(model, tbatch(batch_np),
                                      prng.prng_key(5))
        loss.backward()
    finally:
        FA.flash_attention_fwd_plain = fwd
    return (float(loss.detach()),
            {n: p.grad for n, p in model.named_parameters()}, runs[0],
            saved[0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("attn_impl,bwd_impl", [("xla", "xla"),
                                                ("flash", "pallas")])
def test_remat_loss_and_gradients_equal_none_and_jax(params, batch_np, mode,
                                                     attn_impl, bwd_impl):
    kw = dict(attn_impl=attn_impl, attn_bwd_impl=bwd_impl)
    jcfg, tcfg = cfgs(remat=mode, **kw)
    _, base = cfgs(**kw)
    loss, grads, runs, saved = port_step(params, tcfg, batch_np)
    loss0, grads0, runs0, saved0 = port_step(params, base, batch_np)
    assert loss == loss0
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=0, atol=0,
                                   msg=name)
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch_np.items()},
        jax.random.PRNGKey(5))
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(jgrads), tcfg,
                                        device="cpu").named_parameters())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)
    if attn_impl == "flash":
        # K1 once a layer, and again in the backward where the layer is
        # recomputed past its products
        assert runs0 == 2
        assert runs == (2 if mode == "save_ln" else 4)
    if mode != "full":
        assert saved < saved0


def test_reversible_ignores_remat(params, batch_np):
    """``reversible`` runs its own engine whatever ``remat`` says, as
    JAX's dispatch does."""
    _, rev = cfgs(reversible=True)
    _, rev_full = cfgs(reversible=True, remat="full")
    loss, grads, _, _ = port_step(params, rev_full, batch_np)
    loss0, grads0, _, _ = port_step(params, rev, batch_np)
    assert loss == loss0
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=0, atol=0)


# -- EMA ----------------------------------------------------------------------

def _args(decay):
    return argparse.Namespace(ema_decay=decay)


def test_ema_moves_despite_bf16_params():
    model = torch.nn.Linear(4, 1, bias=False).to(torch.bfloat16)
    with torch.no_grad():
        model.weight.zero_()
    ema, update = TCOM.make_ema(_args(0.999), model)
    assert ema["weight"].dtype == torch.float32
    with torch.no_grad():
        model.weight.fill_(2.0)
    for _ in range(100):
        ema = update(ema, model)
    # 1 - 0.999^100 ~ 0.0952 of the way from 0 to 2
    assert float(ema["weight"][0, 0]) == pytest.approx(2 * 0.0952, rel=0.01)
    assert model.weight.dtype == torch.bfloat16
    cast = TCOM.ema_as(ema, model)
    assert cast["weight"].dtype == torch.bfloat16
    np.testing.assert_allclose(cast["weight"].float().numpy(),
                               ema["weight"].to(torch.bfloat16).float()
                               .numpy())


def test_ema_updates_equal_jax():
    rs = np.random.RandomState(0)
    start = {"w": rs.randn(3, 5).astype(np.float32),
             "b": rs.randn(5).astype(np.float32)}
    model = torch.nn.Linear(3, 5)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(start["w"]).T)
        model.bias.copy_(torch.tensor(start["b"]))
    jema, jupdate = JCOM.make_ema(_args(0.9), {k: jnp.asarray(v)
                                               for k, v in start.items()})
    tema, tupdate = TCOM.make_ema(_args(0.9), model)
    for i in range(4):
        new = {"w": rs.randn(3, 5).astype(np.float32),
               "b": rs.randn(5).astype(np.float32)}
        with torch.no_grad():
            model.weight.copy_(torch.tensor(new["w"]).T)
            model.bias.copy_(torch.tensor(new["b"]))
        jema = jupdate(jema, {k: jnp.asarray(v) for k, v in new.items()})
        tema = tupdate(tema, model)
    np.testing.assert_allclose(tema["weight"].numpy(),
                               np.asarray(jema["w"]).T, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tema["bias"].numpy(), np.asarray(jema["b"]),
                               rtol=1e-6, atol=1e-7)


def test_ema_off_is_none_and_resume_waits_for_checkpoints(tmp_path):
    """Off for decay <= 0; a resume path whose checkpoint has no EMA
    starts from the parameters, as JAX's does (``ema.msgpack`` restores
    are covered in ``test_torch_checkpoint.py``); resuming a checkpoint
    that carries an EMA with decay 0 is refused, -1 discards it."""
    model = torch.nn.Linear(2, 2)
    assert TCOM.make_ema(_args(0.0), model) == (None, None)
    assert TCOM.make_ema(_args(-1.0), model) == (None, None)
    assert TCOM.make_ema(argparse.Namespace(), model) == (None, None)
    ema, _ = TCOM.make_ema(_args(0.999), model,
                           resume_path=str(tmp_path / "m-0"))
    np.testing.assert_array_equal(ema["weight"].numpy(),
                                  model.weight.detach().numpy())
    (tmp_path / "m-1").mkdir()
    (tmp_path / "m-1" / "ema.msgpack").write_bytes(b"")
    with pytest.raises(SystemExit, match="carries an EMA"):
        TCOM.make_ema(_args(0.0), model, resume_path=str(tmp_path / "m-1"))
    assert TCOM.make_ema(_args(-1.0), model,
                         resume_path=str(tmp_path / "m-1")) == (None, None)
