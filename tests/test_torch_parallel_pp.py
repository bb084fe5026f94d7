"""The port's pipeline on CPU process groups (gloo), against the JAX
package.

``parallel/pipeline.py::pipeline_transformer`` over 2 stages of a depth-4
stack, with 2 microbatches and with 4 (M > P), a padding mask or none:
in eval mode against JAX's one-device ``transformer_apply`` (JAX's own
tests hold its pipeline to that), and the gradients of sum(y^2) against
``jax.grad`` of it (JAX's sharded gradient compiles for ~20 s). With
dropout 0.1 the keys are ``fold_in(fold_in(rng, stage), microbatch)``:
against JAX's ``pipeline_transformer`` on conftest's 8-device mesh at pp
2 and at dp 2 x pp 2 (world 4; each dp shard of a microbatch draws the
mask of its own rows' shape, as JAX's does). The MoE load-balance aux
summed over stages / M against JAX's pipeline. ``pp_dalle_loss_fn``
through ``make_train_step`` with the stage placement (each rank stores
its layers and the embeddings and head) and the global-norm clip: the
parameters after two Adam steps against JAX's one-device step, gathered
from the stages; the stages' parameter counts; the refusals with JAX's
messages. float32, outputs to 2e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops.transformer import (TransformerConfig,
                                               transformer_apply,
                                               transformer_init)
from dalle_pytorch_tpu.parallel import make_mesh, pipeline_transformer
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as R

ATOL = 2e-5
CFG = dict(dim=16, depth=4, seq_len=32, heads=4, dim_head=8, causal=True,
           attn_dropout=0.1, ff_dropout=0.1)
MOE = dict(CFG, attn_dropout=0.0, ff_dropout=0.0, moe_experts=2, moe_k=1)
SEED = 5


def stack(cfg_kw=CFG):
    cfg = TransformerConfig(**cfg_kw)
    params = jax.device_get(transformer_init(jax.random.PRNGKey(0), cfg))
    rs = np.random.RandomState(1)
    x = rs.randn(4, 32, 16).astype(np.float32)
    mask = np.ones((4, 32), bool)
    mask[1, 20:] = False
    mask[2, 9:] = False
    return cfg, params, x, mask


PP2 = [(2, False, False), (4, True, False), (4, True, True)]
DPPP = [(2, True, False), (2, True, True)]


@pytest.fixture(scope="module")
def ranks():
    _, params, x, mask = stack()
    spec = {"cfg": CFG, "params": params, "x": x, "mask": mask,
            "seed": SEED}
    _, mparams, _, _ = stack(MOE)
    return {
        "pp2": spawn(R.pp_stack_case, 2, ({**spec, "axes": {"pp": 2},
                                           "cases": PP2, "grads": True},),
                     device="cpu", timeout_s=240),
        "dp2xpp2": spawn(R.pp_stack_case, 4, ({**spec, "cases": DPPP,
                                               "axes": {"dp": 2, "pp": 2}},),
                         device="cpu", timeout_s=240),
        "moe": spawn(R.pp_stack_case, 2, ({**spec, "cfg": MOE,
                                           "params": mparams,
                                           "axes": {"pp": 2},
                                           "cases": [(2, True, False)]},),
                     device="cpu", timeout_s=240)}


@pytest.mark.parametrize("layout, case", [
    ("pp2", PP2[0]), ("pp2", PP2[1]), ("dp2xpp2", DPPP[0])],
    ids=["pp2-m2", "pp2-m4-mask", "dp2xpp2-mask"])
def test_pipeline_matches_jax_one_device(ranks, layout, case):
    cfg, params, x, mask = stack()
    want = np.asarray(transformer_apply(
        params, jnp.asarray(x), cfg=cfg,
        mask=jnp.asarray(mask) if case[1] else None))
    for got in ranks[layout]:
        y, aux = got[case]
        np.testing.assert_allclose(y, want, atol=ATOL)
        assert aux == 0.0


def test_pipeline_gradients_match_jax(ranks):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig as T
    cfg, params, x, _ = stack()

    def loss(p):
        return jnp.sum(transformer_apply(p, jnp.asarray(x), cfg=cfg) ** 2)

    grads = jax.device_get(jax.grad(loss)(params))
    want = dict(from_jax.transformer_from_jax(
        grads, T(**CFG), device="cpu").named_parameters())
    for got in ranks["pp2"]:
        assert set(got["grads"]) == set(want)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, want[name].detach().numpy(),
                                       atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("layout, axes, case", [
    ("pp2", {"pp": 2}, PP2[2]), ("dp2xpp2", {"dp": 2, "pp": 2}, DPPP[1])],
    ids=["pp2", "dp2xpp2"])
def test_dropout_keys_match_jax_pipeline(ranks, layout, axes, case):
    cfg, params, x, mask = stack()
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, jax.devices()[:n])
    want = np.asarray(pipeline_transformer(
        params, jnp.asarray(x), cfg=cfg, mesh=mesh,
        num_microbatches=case[0], dp_axis="dp" if "dp" in axes else None,
        mask=jnp.asarray(mask), rng=jax.random.PRNGKey(SEED), train=True))
    for got in ranks[layout]:
        np.testing.assert_allclose(got[case][0], want, atol=ATOL)


def test_moe_aux_matches_jax_pipeline(ranks):
    cfg, params, x, mask = stack(MOE)
    mesh = make_mesh({"pp": 2}, jax.devices()[:2])
    y, aux = pipeline_transformer(params, jnp.asarray(x), cfg=cfg, mesh=mesh,
                                  num_microbatches=2, mask=jnp.asarray(mask),
                                  with_aux=True)
    for got in ranks["moe"]:
        ty, taux = got[(2, True, False)]
        np.testing.assert_allclose(ty, np.asarray(y), atol=ATOL)
        np.testing.assert_allclose(taux, float(aux), rtol=1e-5)
        assert taux > 0


# -- the DALLE step -------------------------------------------------------------

VAE = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
           hidden_dim=8)
DALLE = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
             dim_head=16, attn_dropout=0.0, ff_dropout=0.0)
B = 4


@pytest.fixture(scope="module")
def pp_step():
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**VAE), **DALLE)
    key = jax.random.PRNGKey(0)
    vae = JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae)
    params = jax.device_get(JD.dalle_init(key, jcfg, vae))
    rs = np.random.RandomState(3)
    mask = np.ones((B, 8), bool)
    mask[2, 4:] = False
    batch = {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
             "image": rs.randint(0, 32, (B, 16)).astype(np.int32),
             "mask": mask}
    spec = {"kind": "pp", "axes": {"dp": 1, "pp": 2}, "microbatches": 2,
            "cfg": {**DALLE, "vae": VAE}, "params": params, "batch": batch,
            "seed": 7, "steps": 2, "opt": {"clip_grad_norm": 1.0}}
    return jcfg, params, batch, spawn(R.step_case, 2, (spec,),
                                      device="cpu", timeout_s=240)


def test_pp_step_matches_jax_one_device_step(pp_step):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.models import vae as TV
    jcfg, params, batch, got = pp_step
    args = types.SimpleNamespace(lr=1e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=1.0)
    opt = JCOM.make_optimizer(args)
    step = jax.jit(JP.make_train_step(JP.dalle_loss_fn(jcfg), opt))
    state, losses = opt.init(params), []
    for i in range(2):
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                                   jax.random.PRNGKey(7 + i))
        losses.append(float(loss))
    tcfg = TD.DALLEConfig(vae=TV.VAEConfig(**VAE), **DALLE)
    # jaxlint: disable=JL001 — terminal fetch for the comparison
    want = dict(from_jax.dalle_from_jax(jax.device_get(params), tcfg,
                                        device="cpu").named_parameters())
    # the stages' gathered trees come home on the first pipeline's ranks
    for r in range(2):
        np.testing.assert_allclose(got[r]["losses"], losses, rtol=1e-5)
        assert set(got[r]["params"]) == set(want)
        # clip_by_global_norm divides by the norm, torch's clip by
        # norm + 1e-6 (cli/common.py): 2e-5, as tests/test_torch_train.py
        for name, p in got[r]["params"].items():
            np.testing.assert_allclose(p, want[name].detach().numpy(),
                                       atol=2e-5, err_msg=name)


def test_each_stage_stores_its_layers_only(pp_step):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.models import vae as TV
    _, params, _, got = pp_step
    model = from_jax.dalle_from_jax(params, TD.DALLEConfig(
        vae=TV.VAEConfig(**VAE), **DALLE), device="cpu")
    total = sum(p.numel() for p in model.parameters())
    layers = sum(p.numel() for p in model.transformer.parameters())
    for r in range(2):
        assert got[r]["stage_params"] == total - layers // 2
        # one rotation a tick but the last, forward and back
        assert got[r]["calls"]["ppermute"] == 2 * (2 + 2 - 2) * 2


# -- refusals -------------------------------------------------------------------

def _messages(jax_call, port_call, exc):
    with pytest.raises(exc) as jerr:
        jax_call()
    with pytest.raises(exc) as terr:
        port_call()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", ["depth", "reversible", "pattern",
                                 "microbatches"])
def test_pipeline_refusals_match_jax(bad):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig as T
    from dalle_pytorch_tpu_torch.parallel import pipeline as TPP
    from dalle_pytorch_tpu_torch.parallel.mesh import Mesh
    cfg, params, x, _ = stack()
    kw, stages, m = {}, 2, None
    if bad == "depth":
        stages = 3
    elif bad == "reversible":
        kw = dict(reversible=True)
    elif bad == "pattern":
        kw = dict(sparse_attn=(True, True, False, False))
    else:
        m = 3
    jcfg = dataclasses.replace(cfg, **kw)
    tcfg = dataclasses.replace(T(**CFG), **kw)
    jmesh = make_mesh({"pp": stages}, jax.devices()[:stages])
    mesh = Mesh({"pp": stages}, np.arange(stages), {"pp": 0}, {})
    model = from_jax.transformer_from_jax(params, T(**CFG), device="cpu")
    exc = NotImplementedError if bad == "reversible" else ValueError
    _messages(lambda: pipeline_transformer(params, jnp.asarray(x), cfg=jcfg,
                                           mesh=jmesh, num_microbatches=m),
              lambda: TPP.pipeline_transformer(model, torch.tensor(x),
                                               cfg=tcfg, mesh=mesh,
                                               num_microbatches=m), exc)
