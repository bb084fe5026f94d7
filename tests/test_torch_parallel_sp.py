"""The port's sequence-parallel stack and DALLE step on CPU process groups
(gloo), against the JAX package.

``parallel/sequence.py::sp_transformer_apply`` with the ring and the
Ulysses body, with a padding mask or none: in eval mode against JAX's
one-device ``transformer_apply`` (JAX's own tests hold its sharded stack
to that), and with dropout 0.1 against JAX's ``sp_transformer_apply`` on
conftest's 8-device mesh (sp 2): the per-position masks are bit-equal,
so the outputs agree to 2e-5 at sp 2, at sp 4 and at dp 2 x sp 2 (the
masks' invariance under the sp degree). The gradients of sum(y^2) under
remat 'save_ln', 'dots' and 'full' against ``jax.grad`` of the one-device
stack (JAX's sharded gradient compiles for ~20 s). ``sp_dalle_loss_fn``
through ``make_train_step`` on 2 ranks: with dropout 0.1 the step's loss
against JAX's ``sp_dalle_loss_fn`` on a 2-device mesh (rtol 1e-5); with
dropout 0 the parameters after one Adam step against JAX's one-device
step (atol 1e-5). ``core.positional_dropout`` at any offset and
``prng``'s counter offset (``uniform``, ``bernoulli``, ``gumbel``,
``batch_rows``) bit-equal to JAX; every refusal of the stack with JAX's
message. float32.
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
from dalle_pytorch_tpu.ops import core as JCORE
from dalle_pytorch_tpu.ops.transformer import (TransformerConfig,
                                               transformer_apply,
                                               transformer_init)
from dalle_pytorch_tpu.parallel import make_mesh, sp_dalle_loss_fn
from dalle_pytorch_tpu.parallel import sp_transformer_apply as j_sp_apply
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.ops import core as TCORE
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as R

ATOL = 2e-5
CFG = dict(dim=16, depth=2, seq_len=32, heads=4, dim_head=8, causal=True,
           attn_dropout=0.1, ff_dropout=0.1)
SEED = 3


def stack():
    cfg = TransformerConfig(**CFG)
    params = jax.device_get(transformer_init(jax.random.PRNGKey(0), cfg))
    rs = np.random.RandomState(1)
    x = rs.randn(4, 32, 16).astype(np.float32)
    mask = np.ones((4, 32), bool)
    mask[1, 20:] = False
    mask[3, 5:] = False
    return cfg, params, x, mask


EVAL = [("ring", True, False), ("ulysses", True, False),
        ("ring", False, False)]
TRAIN = [("ring", True, True), ("ulysses", True, True)]
REMAT = [("ring", "save_ln"), ("ring", "dots"), ("ring", "full"),
         ("ulysses", "full")]


@pytest.fixture(scope="module")
def ranks():
    cfg, params, x, mask = stack()
    spec = {"cfg": CFG, "params": params, "x": x, "mask": mask,
            "seed": SEED}
    return {
        "sp2": spawn(R.sp_stack_case, 2, ({**spec, "cases": EVAL + TRAIN,
                                           "remat": REMAT},),
                     device="cpu", timeout_s=240),
        "sp4": spawn(R.sp_stack_case, 4, ({**spec, "cases": TRAIN},),
                     device="cpu", timeout_s=240),
        "dp2xsp2": spawn(R.sp_stack_case, 4, ({**spec, "dp": 2,
                                               "cases": TRAIN[:1]},),
                         device="cpu", timeout_s=240)}


@pytest.mark.parametrize("case", EVAL, ids=lambda c: "-".join(map(str, c)))
def test_stack_matches_jax_one_device(ranks, case):
    cfg, params, x, mask = stack()
    want = np.asarray(transformer_apply(
        params, jnp.asarray(x), cfg=cfg,
        mask=jnp.asarray(mask) if case[1] else None))
    for got in ranks["sp2"]:
        np.testing.assert_allclose(got[case], want, atol=ATOL)


@pytest.fixture(scope="module")
def jax_train():
    """JAX's sharded stack in train mode (dropout 0.1): both bodies at
    sp 2, and the ring at dp 2 x sp 2 (whose shards draw masks of their
    own rows' shape, as the port's do)."""
    cfg, params, x, mask = stack()
    out = {}
    for layout, axes, batch_axis in (("sp", {"sp": 2}, None),
                                     ("dp2xsp2", {"dp": 2, "sp": 2}, "dp")):
        n = int(np.prod(list(axes.values())))
        mesh = make_mesh(axes, jax.devices()[:n])
        for impl in (("ring", "ulysses") if layout == "sp" else ("ring",)):
            out[(layout, impl)] = np.asarray(j_sp_apply(
                params, jnp.asarray(x), cfg=cfg, mesh=mesh, impl=impl,
                batch_axis=batch_axis, mask=jnp.asarray(mask),
                rng=jax.random.PRNGKey(SEED), train=True))
    return out


@pytest.mark.parametrize("layout, case", [
    ("sp2", TRAIN[0]), ("sp2", TRAIN[1]), ("sp4", TRAIN[0]),
    ("sp4", TRAIN[1]), ("dp2xsp2", TRAIN[0])],
    ids=["sp2-ring", "sp2-ulysses", "sp4-ring", "sp4-ulysses",
         "dp2xsp2-ring"])
def test_dropout_masks_match_jax_at_every_degree(ranks, jax_train, layout,
                                                 case):
    """sp 4 against JAX at sp 2: the masks do not depend on the degree."""
    want = jax_train[("dp2xsp2" if layout == "dp2xsp2" else "sp", case[0])]
    for got in ranks[layout]:
        np.testing.assert_allclose(got[case], want, atol=ATOL)


@pytest.fixture(scope="module")
def jax_grads():
    cfg, params, x, mask = stack()
    cfg = dataclasses.replace(cfg, attn_dropout=0.0, ff_dropout=0.0)

    def loss(p):
        return jnp.sum(transformer_apply(p, jnp.asarray(x), cfg=cfg,
                                         mask=jnp.asarray(mask)) ** 2)

    return jax.device_get(jax.grad(loss)(params))


@pytest.mark.parametrize("impl, mode", REMAT)
def test_remat_gradients_match_jax(ranks, jax_grads, impl, mode):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig as T
    want = dict(from_jax.transformer_from_jax(
        jax_grads, T(**CFG), device="cpu").named_parameters())
    for got in ranks["sp2"]:
        grads = got[("remat", impl, mode)]
        assert set(grads) == set(want)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want[name].detach().numpy(),
                                       atol=1e-4, rtol=1e-5, err_msg=name)


# -- the DALLE step -------------------------------------------------------------

VAE = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
           hidden_dim=8)
DALLE = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
             dim_head=16)
B = 4


def dalle_setup(**kw):
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**VAE), **DALLE, **kw)
    key = jax.random.PRNGKey(0)
    vae = JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae)
    params = jax.device_get(JD.dalle_init(key, jcfg, vae))
    rs = np.random.RandomState(3)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    batch = {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
             "image": rs.randint(0, 32, (B, 16)).astype(np.int32),
             "mask": mask}
    return jcfg, params, batch


def opt_args():
    return types.SimpleNamespace(lr=1e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)


@pytest.fixture(scope="module")
def sp_steps():
    out = {}
    for name, impl, kw in (("dropout", "ring", {}),
                           ("no_dropout", "ulysses",
                            dict(attn_dropout=0.0, ff_dropout=0.0))):
        jcfg, params, batch = dalle_setup(**kw)
        spec = {"kind": "sp", "impl": impl, "axes": {"dp": 1, "sp": 2},
                "cfg": {**DALLE, **kw, "vae": VAE}, "params": params,
                "batch": batch, "seed": 7}
        out[name] = spawn(R.step_case, 2, (spec,), device="cpu",
                          timeout_s=240)
    return out


def test_sp_step_loss_with_dropout_matches_jax_sp_loss(sp_steps):
    jcfg, params, batch = dalle_setup()
    mesh = make_mesh({"dp": 1, "sp": 2}, jax.devices()[:2])
    loss = sp_dalle_loss_fn(jcfg, mesh, batch_axis="dp", impl="ring")
    want = float(jax.jit(loss)(params, {k: jnp.asarray(v) for k, v in
                                        batch.items()},
                               jax.random.PRNGKey(7)))
    for got in sp_steps["dropout"]:
        np.testing.assert_allclose(got["losses"][0], want, rtol=1e-5)


def test_sp_step_matches_jax_one_device_step(sp_steps):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.models import vae as TV
    kw = dict(attn_dropout=0.0, ff_dropout=0.0)
    jcfg, params, batch = dalle_setup(**kw)
    opt = JCOM.make_optimizer(opt_args())
    step = JP.make_train_step(JP.dalle_loss_fn(jcfg), opt)
    new, _, loss = step(params, opt.init(params),
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(7))
    tcfg = TD.DALLEConfig(vae=TV.VAEConfig(**VAE), **DALLE, **kw)
    want = dict(from_jax.dalle_from_jax(jax.device_get(new), tcfg,
                                        device="cpu").named_parameters())
    for got in sp_steps["no_dropout"]:
        np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, want[name].detach().numpy(),
                                       atol=1e-5, err_msg=name)
        assert got["calls"]["all_to_all"] > 0


# -- dropout keys and counters ----------------------------------------------------

@pytest.mark.parametrize("offset", [0, 5, 1280])
def test_positional_dropout_bit_equal_to_jax(offset):
    x = np.random.RandomState(2).randn(3, 7, 5).astype(np.float32)
    want = np.asarray(JCORE.positional_dropout(
        jax.random.PRNGKey(11), jnp.asarray(x), 0.1, True, offset=offset))
    got = TCORE.positional_dropout(prng.prng_key(11), torch.tensor(x), 0.1,
                                   True, offset=offset).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a shard starting at position 4 draws that slice of the whole mask
    shard = TCORE.positional_dropout(prng.prng_key(11), torch.tensor(x[:, 4:]),
                                     0.1, True, offset=offset + 4).numpy()
    np.testing.assert_array_equal(shard, got[:, 4:])


@pytest.mark.parametrize("draw", ["uniform", "bernoulli", "gumbel"])
def test_counter_offset_draws_rows_of_the_whole(draw):
    shape, rows = (6, 4, 3), slice(2, 5)
    jax_draw = {"uniform": lambda ku: jax.random.uniform(ku, shape),
                "bernoulli": lambda kb: jax.random.bernoulli(kb, 0.3, shape),
                "gumbel": lambda kg: jax.random.gumbel(kg, shape)}[draw]
    whole = jax_draw(jax.random.PRNGKey(5))
    local = (3,) + shape[1:]
    off = 2 * 4 * 3
    key = prng.prng_key(5)
    got = {"uniform": lambda: prng.uniform(key, local, offset=off),
           "bernoulli": lambda: prng.bernoulli(key, 0.3, local, off),
           "gumbel": lambda: prng.gumbel(key, local, offset=off)}[draw]()
    if draw == "gumbel":
        np.testing.assert_allclose(got.numpy(), np.asarray(whole)[rows],
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(whole)[rows])


def test_batch_rows_dropout_is_a_slice_of_the_whole_batch():
    x = torch.tensor(np.random.RandomState(4).randn(8, 5, 6).astype(
        np.float32))
    key = prng.prng_key(3)
    whole = TCORE.dropout(key, x, 0.1, True)
    want = np.asarray(JCORE.dropout(jax.random.PRNGKey(3), jnp.asarray(
        x.numpy()), 0.1, True))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6)
    with prng.batch_rows(4):
        half = TCORE.dropout(key, x[4:], 0.1, True)
    np.testing.assert_array_equal(half.numpy(), whole[4:].numpy())


# -- refusals ---------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(sparse_attn=True),
                                 dict(reversible=True),
                                 dict(moe_experts=2)],
                         ids=["sparse", "reversible", "moe"])
def test_stack_refusals_match_jax(bad):
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig as T
    from dalle_pytorch_tpu_torch.parallel.mesh import Mesh
    from dalle_pytorch_tpu_torch.parallel.sequence import \
        sp_transformer_apply
    cfg, params, x, _ = stack()
    jmesh = make_mesh({"sp": 2}, jax.devices()[:2])
    with pytest.raises(ValueError) as jerr:
        j_sp_apply(params, jnp.asarray(x),
                   cfg=dataclasses.replace(cfg, **bad), mesh=jmesh)
    tcfg = T(**CFG)
    model = from_jax.transformer_from_jax(params, tcfg, device="cpu")
    mesh = Mesh({"sp": 2}, np.arange(2), {"sp": 0}, {})
    with pytest.raises(ValueError) as terr:
        sp_transformer_apply(model, torch.tensor(x),
                             cfg=dataclasses.replace(tcfg, **bad), mesh=mesh)
    assert str(terr.value) == str(jerr.value)


def test_stack_refuses_unknown_impl_and_uneven_sequence():
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig as T
    from dalle_pytorch_tpu_torch.parallel.mesh import Mesh
    from dalle_pytorch_tpu_torch.parallel.sequence import \
        sp_transformer_apply
    cfg, params, x, _ = stack()
    tcfg = T(**CFG)
    model = from_jax.transformer_from_jax(params, tcfg, device="cpu")
    jmesh = make_mesh({"sp": 3}, jax.devices()[:3])
    mesh = Mesh({"sp": 3}, np.arange(3), {"sp": 0}, {})
    for kw in (dict(impl="tree"), dict()):
        with pytest.raises(ValueError) as jerr:
            j_sp_apply(params, jnp.asarray(x), cfg=cfg, mesh=jmesh, **kw)
        with pytest.raises(ValueError) as terr:
            sp_transformer_apply(model, torch.tensor(x), cfg=tcfg,
                                 mesh=mesh, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="explicit `rng`"):
        sp_transformer_apply(model, torch.tensor(x), cfg=tcfg, mesh=mesh,
                             train=True)
