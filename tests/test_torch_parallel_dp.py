"""The port's data-parallel steps on CPU process groups (gloo), against
the JAX package's one-device steps.

``parallel/train.py::make_train_step`` over a ``dp`` mesh, each rank on
its rows of the batch (``mesh.shard_batch``), the replicas placed alike
(``setup_sharded``) and the gradients averaged once per update: the
DALLE step with dropout 0.1 (each rank draws its rows of the whole
batch's masks, ``prng.batch_rows``) at dp 2 and dp 4; the VAE step with
its Gumbel noise (the same rows of the whole draw); the CLIP step, whose
InfoNCE spans the whole batch (the image latents gathered, their
cotangents summed back); and each of the three with ``grad_accum`` 2 at
dp 2, where a rank's microbatch ``i`` is its half of the global batch's
microbatch ``i`` (``microbatch_rows``), so the DALLE's dropout (0.1) and
the VAE's noise pair with the rows they pair with in JAX and CLIP's
InfoNCE sees JAX's negatives. Each against JAX's
``make_train_step`` on one device over the whole batch: the losses to
1e-5 relative and the parameters after two Adam steps to 1e-5, every
rank's the same. Also ``make_mesh``'s refusal with JAX's message, and
``shard_batch``'s two contracts. float32.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.parallel import make_mesh as j_make_mesh
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as R

TOL = dict(rtol=1e-5)
PARAM_ATOL = 1e-5
VAE = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
           hidden_dim=8)
DALLE = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
             dim_head=16)
CLIP = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
            text_enc_depth=1, text_seq_len=20, text_heads=2,
            visual_enc_depth=1, visual_heads=2, visual_image_size=16,
            visual_patch_size=4)
B = 8
SEED = 7
STEPS = 2


def opt_args():
    return types.SimpleNamespace(lr=1e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)


def setups():
    """{case: (JAX loss fn, JAX params, numpy batch, port's step spec)}"""
    rs = np.random.RandomState(3)
    key = jax.random.PRNGKey(0)
    out = {}
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    mask[6, 2:] = False
    ids = {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
           "image": rs.randint(0, 32, (B, 16)).astype(np.int32),
           "mask": mask}
    kw = dict(attn_dropout=0.1, ff_dropout=0.1)
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**VAE), **DALLE, **kw)
    vae = JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae)
    params = jax.device_get(JD.dalle_init(key, jcfg, vae))
    out["dalle"] = (JP.dalle_loss_fn(jcfg), params, ids,
                    {"kind": "dalle", "cfg": {**DALLE, **kw, "vae": VAE}})
    # the DALLE case under grad_accum (its historical name)
    out["accum"] = out["dalle"]
    vcfg = JV.VAEConfig(**VAE)
    images = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    out["vae"] = (JP.vae_loss_fn(vcfg, smooth_l1=True, temperature=0.7),
                  jax.device_get(JV.vae_init(key, vcfg)), {"images": images},
                  {"kind": "vae", "cfg": VAE, "temperature": 0.7})
    ccfg = JC.CLIPConfig(**CLIP)
    text = rs.randint(1, 64, (B, 20)).astype(np.int32)
    text[2, 12:] = 0
    out["clip"] = (JP.clip_loss_fn(ccfg),
                   jax.device_get(JC.clip_init(key, ccfg)),
                   {"text": text, "images": images, "mask": text != 0},
                   {"kind": "clip", "cfg": CLIP})
    return out


RUNS = [("dalle", 2, 1), ("dalle", 4, 1), ("vae", 2, 1), ("clip", 2, 1),
        ("accum", 2, 2), ("vae", 2, 2), ("clip", 2, 2)]


@pytest.fixture(scope="module")
def ranks():
    cases = setups()
    out = {}
    for world in sorted({w for _, w, _ in RUNS}):
        runs = [r for r in RUNS if r[1] == world]
        specs = [{**cases[name][3], "params": cases[name][1],
                  "batch": cases[name][2], "seed": SEED, "steps": STEPS,
                  "grad_accum": accum, "axes": {"dp": world}}
                 for name, _, accum in runs]
        per_rank = spawn(R.step_cases, world, (specs,), device="cpu",
                         timeout_s=240)
        for i, run in enumerate(runs):
            out[run] = [got[i] for got in per_rank]
    return out


def jax_steps(name, accum):
    loss_fn, params, batch, _ = setups()[name]
    opt = JCOM.make_optimizer(opt_args())
    step = jax.jit(JP.make_train_step(loss_fn, opt, grad_accum=accum))
    state, losses = opt.init(params), []
    for i in range(STEPS):
        params, state, loss = step(params, state,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                                   jax.random.PRNGKey(SEED + i))
        losses.append(float(loss))
    # jaxlint: disable=JL001 — terminal fetch for the comparison
    return losses, jax.device_get(params)


def port_params(name, tree):
    if name == "vae":
        model = from_jax.discrete_vae_from_jax(tree, TV.VAEConfig(**VAE),
                                               device="cpu")
    elif name == "clip":
        model = from_jax.clip_from_jax(tree, TC.CLIPConfig(**CLIP),
                                       device="cpu")
    else:
        spec = setups()[name][3]["cfg"]
        model = from_jax.dalle_from_jax(tree, TD.DALLEConfig(
            vae=TV.VAEConfig(**VAE), **{k: v for k, v in spec.items()
                                        if k != "vae"}), device="cpu")
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name, world, accum", RUNS,
                         ids=[f"{n}-dp{w}" + ("-accum2" if a > 1 else "")
                              for n, w, a in RUNS])
def test_dp_step_matches_jax_one_device_step(ranks, name, world, accum):
    losses, tree = jax_steps(name, accum)
    want = port_params(name, tree)
    for r, got in enumerate(ranks[(name, world, accum)]):
        np.testing.assert_allclose(got["losses"], losses, **TOL,
                                   err_msg=f"rank {r}")
        assert set(got["params"]) == set(want)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, want[n], atol=PARAM_ATOL,
                                       err_msg=f"rank {r}: {n}")
        # one reduction a step, after the accumulation
        assert got["calls"]["all_reduce"] == STEPS


def test_make_mesh_refusal_matches_jax():
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError) as jerr:
        j_make_mesh({"dp": 2}, jax.devices()[:1])
    with pytest.raises(ValueError) as terr:
        make_mesh({"dp": 2})
    assert str(terr.value) == str(jerr.value)


def test_shard_batch_global_rows_or_local_as_is():
    from dalle_pytorch_tpu_torch.parallel.mesh import Mesh, shard_batch
    batch = {"text": torch.arange(12).reshape(6, 2), "lr_scale": 0.5}
    mesh = Mesh({"dp": 3, "sp": 2}, np.arange(6).reshape(3, 2),
                {"dp": 1, "sp": 1}, {})
    got = shard_batch(mesh, batch, "dp", local=False)
    np.testing.assert_array_equal(got["text"].numpy(),
                                  batch["text"][2:4].numpy())
    assert got["lr_scale"] == 0.5
    assert shard_batch(mesh, batch, "dp", local=True) is batch
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, {"text": torch.zeros(4, 2)}, "dp", local=False)
