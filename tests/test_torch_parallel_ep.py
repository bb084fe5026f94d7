"""Expert parallelism in the port on CPU process groups (gloo), against
the JAX package.

``ops/moe.py::moe_param_specs``, ``parallel/train.py::
dalle_moe_param_specs`` and ``parallel/pipeline.py::pp_param_specs(ep=)``
equal JAX's ``PartitionSpec`` trees leaf for leaf (laid out
depth-stacked, linear weights (in, out)); their refusals are JAX's. Over
``ep`` every rank holds the same tokens and the same router, runs its
E/ep experts and sums the combine over the group: ``moe_apply`` over ep
2 gives JAX's output, aux and gradients, and two Adam steps of a MoE
DALLE with the global-norm clip give JAX's one-device loss and
parameters (gathered, 2e-5) at ep 2 and dp 2 x ep 2 (dropout 0.1) and
pp 2 x ep 2 (dropout 0: a pipeline keys its dropout per stage). A rank
stores half of each expert stack. float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalle_pytorch_tpu.ops import moe as JM
from dalle_pytorch_tpu.parallel import pp_param_specs as j_pp_param_specs
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.ops import moe as TM
from dalle_pytorch_tpu_torch.parallel import train as TP
from dalle_pytorch_tpu_torch.parallel.launch import spawn
from dalle_pytorch_tpu_torch.parallel.pipeline import pp_param_specs

import torch_parallel_jax as J
import torch_parallel_ranks as R

MOE_PP = dict(J.MOE, attn_dropout=0.0, ff_dropout=0.0)
MOE_CFG = dict(dim=16, num_experts=4, k=2, ff_mult=4, capacity_factor=1.25)


def moe_model(kw=J.MOE):
    params, _ = J.setup(kw)
    return params, from_jax.dalle_from_jax(params, J.torch_cfg(kw),
                                           device="cpu")


# -- the specs ----------------------------------------------------------------------

def test_dalle_moe_param_specs_match_jax():
    params, model = moe_model()
    want = J.jax_specs(params, JP.dalle_moe_param_specs(params))
    got = J.port_specs_as_jax(model, TP.dalle_moe_param_specs(model))
    assert got == want
    assert got[("transformer", "ff", "moe", "w1")] == (None, "ep", None,
                                                      None)


@pytest.mark.parametrize("ep", [None, "ep"])
def test_pp_param_specs_match_jax(ep):
    params, model = moe_model()
    want = J.jax_specs(params, j_pp_param_specs(params, ep=ep))
    got = J.port_specs_as_jax(model, pp_param_specs(model, ep=ep))
    assert got == want


def test_moe_param_specs_match_jax():
    want = JM.moe_param_specs("ep")
    got = TM.moe_param_specs("ep")
    # the router is an nn.Linear: its (out, in) dims are JAX's (in, out)
    assert tuple(reversed(J._pad(got["router.weight"].dims, 2))) == \
        J._pad(want["router"]["w"], 2)
    for k in ("w1", "w2"):
        assert J._pad(got[k].dims, 3) == J._pad(want[k], 3)


def test_refusals_match_jax():
    params, _ = J.setup(J.DALLE)
    model = from_jax.dalle_from_jax(params, J.torch_cfg(J.DALLE),
                                    device="cpu")
    with pytest.raises(ValueError) as jerr:
        j_pp_param_specs(params, ep="ep")
    with pytest.raises(ValueError) as terr:
        pp_param_specs(model, ep="ep")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(KeyError) as jerr:
        JP.dalle_moe_param_specs(params)
    with pytest.raises(KeyError) as terr:
        TP.dalle_moe_param_specs(model)
    assert str(terr.value) == str(jerr.value)


# -- the ranks ------------------------------------------------------------------------

def moe_inputs():
    cfg = JM.MoEConfig(**MOE_CFG)
    params = jax.device_get(JM.moe_init(jax.random.PRNGKey(2), cfg))
    x = np.random.RandomState(4).randn(3, 10, 16).astype(np.float32)
    return cfg, params, x


@pytest.fixture(scope="module")
def two():
    _, mparams, x = moe_inputs()
    items = [("moe_ep_case", {"cfg": MOE_CFG, "params": mparams, "x": x}),
             ("step_case", J.step_spec(J.MOE, {"ep": 2}, {"ep": "ep"}))]
    return spawn(R.run_cases, 2, (items,), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def four():
    items = [("step_case", J.step_spec(J.MOE, {"dp": 2, "ep": 2},
                                       {"ep": "ep"})),
             ("step_case", J.step_spec(MOE_PP, {"dp": 1, "pp": 2, "ep": 2},
                                       {"ep": "ep"}, kind="pp",
                                       microbatches=2))]
    return spawn(R.run_cases, 4, (items,), device="cpu", timeout_s=240)


def test_moe_apply_over_ep2_matches_jax(two):
    cfg, params, x = moe_inputs()

    def f(p, x):
        out, aux = JM.moe_apply(p, x, cfg=cfg)
        return jnp.sum(out ** 2) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    for rank in two:
        got = rank[0]
        assert got["experts"] == 2
        np.testing.assert_allclose(got["out"], np.asarray(out), atol=2e-5)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)
        np.testing.assert_allclose(got["dx"], np.asarray(gx), atol=2e-5)
        np.testing.assert_allclose(got["grads"]["router.weight"],
                                   np.asarray(gp["router"]["w"]).T,
                                   atol=2e-5)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(got["grads"][k], np.asarray(gp[k]),
                                       atol=2e-5)


def test_ep2_step_matches_jax_one_device_step(two):
    want = J.jax_steps(J.MOE)
    for rank in two:
        J.assert_step_matches(rank[1], want)


def test_dp2_ep2_step_matches_jax_one_device_step(four):
    want = J.jax_steps(J.MOE)
    for rank in four:
        J.assert_step_matches(rank[0], want)


def test_pp2_ep2_step_matches_jax_one_device_step(four):
    want = J.jax_steps(MOE_PP)
    for rank in four:
        J.assert_step_matches(rank[1], want)


def test_pp2_ep2_stages_fetch_no_layer(four):
    """A pipeline's stages each run only the layers they store, so the
    depth split over pp gives no layer an owner to fetch it from."""
    for rank in four:
        assert rank[1]["owners"] == [None] * MOE_PP["depth"]


def test_ep_ranks_store_their_share(two, four):
    """ep 2: everything but the expert stacks whole, half of each stack;
    pp 2 x ep 2: half of the layers, and of theirs half of the
    stacks."""
    _, model = moe_model()
    total = sum(p.numel() for p in model.parameters())
    layers = sum(p.numel() for p in model.transformer.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith((".moe.w1", ".moe.w2")))
    for rank in two:
        assert rank[1]["stage_params"] == total - experts // 2
    for rank in four:
        assert rank[1]["stage_params"] == (total - layers) + (
            layers - experts // 2) // 2
