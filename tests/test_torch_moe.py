"""The port's Mixture-of-Experts feed-forward (``ops/moe.py``) and the
MoE DALLE against the JAX package on the CPU, with the weights bridged
by ``compat/from_jax.py``.

Covered: ``moe_apply``'s output and Switch aux loss for several expert
counts, k and capacity factors, capacity overflow (tokens dropped past
an expert's queue), ties in the router (the lower expert first, as
``lax.top_k``), the gradient of ``moe_apply`` with respect to its input
and every parameter, ``k > num_experts`` refused with JAX's exception
type, the tiny DALLE (``bench.py::build_cfg(tiny=True)`` widths) with 4
experts: its loss with ``moe_aux_coef * aux`` and every gradient (xla
and flash/pallas, JAX's Pallas kernels in interpret mode), and its
``generate_images`` tokens, identical to JAX's for a fixed key.

float32. Tolerances: outputs and losses rtol/atol 1e-5; gradients rtol
1e-4 / atol 2e-5 (f32 sums in another order), as ``test_torch_train``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import moe as JM
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import moe as TM
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
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16, moe_experts=4)
B = 4


def moe_pair(seed=0, **kw):
    """(JAX params, port MoE, JAX config, port config)."""
    jcfg, tcfg = JM.MoEConfig(dim=16, **kw), TM.MoEConfig(dim=16, **kw)
    params = jax.device_get(JM.moe_init(jax.random.PRNGKey(seed), jcfg))
    m = TM.MoE(tcfg, device="cpu")
    from_jax._linear(m.router, params["router"])
    from_jax._set(m.w1, params["w1"])
    from_jax._set(m.w2, params["w2"])
    return params, m, jcfg, tcfg


def x_of(seed=0, b=3, n=10):
    return np.random.RandomState(seed).randn(b, n, 16).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(num_experts=4, k=2, ff_mult=2),
    dict(num_experts=4, k=1, ff_mult=2),
    dict(num_experts=3, k=3, ff_mult=1),
    dict(num_experts=8, k=2, ff_mult=2, capacity_factor=2.0)])
def test_moe_apply_output_and_aux_match_jax(kw):
    params, m, jcfg, tcfg = moe_pair(**kw)
    x = x_of()
    jo, ja = JM.moe_apply(params, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        to, ta = TM.moe_apply(m, torch.tensor(x), cfg=tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert ta.dtype == torch.float32
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert float(ta) > 0


def test_capacity_overflow_drops_tokens_like_jax():
    """At capacity factor 0.5 the queues hold half the routed tokens:
    the dropped ones get zero output on both sides."""
    params, m, jcfg, tcfg = moe_pair(num_experts=4, k=2, ff_mult=2,
                                     capacity_factor=0.5)
    assert TM.capacity(tcfg, 10) == 2          # int(ceil(10*2/4) * 0.5)
    x = x_of(1)
    jo, _ = JM.moe_apply(params, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        to, _ = TM.moe_apply(m, torch.tensor(x), cfg=tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    dropped = (to.abs().sum(-1) == 0).sum()
    assert int(dropped) == int((np.abs(np.asarray(jo)).sum(-1) == 0).sum())
    assert int(dropped) > 0
    assert TM.capacity(TM.MoEConfig(dim=4, num_experts=8, k=1,
                                    capacity_factor=0.1), 1) == 1


def test_router_ties_pick_the_lower_expert_as_jax():
    """A zero router gives every expert the same probability: the top-k
    are the lowest indices, as ``lax.top_k`` keeps them."""
    params, m, jcfg, tcfg = moe_pair(num_experts=4, k=2, ff_mult=2,
                                     capacity_factor=4.0)
    params = dict(params, router={"w": np.zeros_like(params["router"]["w"])})
    with torch.no_grad():
        m.router.weight.zero_()
    x = x_of(2)
    dispatch, combine, _ = TM.route(m, torch.tensor(x), tcfg)
    chosen = dispatch.sum(-1)                    # (b, n, E)
    assert bool((chosen[..., :2] == 1).all())
    assert bool((chosen[..., 2:] == 0).all())
    jo, ja = JM.moe_apply(params, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        to, ta = TM.moe_apply(m, torch.tensor(x), cfg=tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


def test_moe_apply_gradients_match_jax():
    params, m, jcfg, tcfg = moe_pair(num_experts=4, k=2, ff_mult=2,
                                     capacity_factor=0.75)
    x = x_of(3)
    w = np.random.RandomState(4).randn(3, 10, 16).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_apply(p, x, cfg=jcfg)
        return jnp.sum(out * w) + 3.0 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out, aux = TM.moe_apply(m, tx, cfg=tcfg)
    (torch.sum(out * torch.tensor(w)) + 3.0 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(m.router.weight.grad.numpy(),
                               np.asarray(jgp["router"]["w"]).T, **GRAD_TOL)
    np.testing.assert_allclose(m.w1.grad.numpy(), np.asarray(jgp["w1"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(m.w2.grad.numpy(), np.asarray(jgp["w2"]),
                               **GRAD_TOL)


def test_k_above_the_experts_is_refused():
    with pytest.raises(ValueError, match="exceeds num_experts"):
        TM.MoEConfig(dim=8, num_experts=2, k=3)
    with pytest.raises(ValueError, match="exceeds num_experts"):
        TT.TransformerConfig(dim=8, depth=1, seq_len=4, moe_experts=2,
                             moe_k=3)
    with pytest.raises(ValueError, match="reversible"):
        TT.TransformerConfig(dim=8, depth=1, seq_len=4, moe_experts=2,
                             reversible=True)
    cfg = TT.TransformerConfig(dim=8, depth=1, seq_len=4, moe_experts=2,
                               moe_k=1, moe_capacity=2.0)
    assert cfg.moe == TM.MoEConfig(dim=8, num_experts=2, k=1,
                                   capacity_factor=2.0)


# -- the MoE DALLE ------------------------------------------------------------

def cfgs(**kw):
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
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False
    return {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
            "mask": mask,
            "image": rs.randint(0, 32, (B, 16)).astype(np.int32)}


def tbatch(b):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in b.items()}


def test_moe_dalle_init_and_bridge_shapes(trees):
    _, tcfg = cfgs()
    model = TD.dalle_init(tcfg, seed=0, device="cpu")
    bridged = from_jax.dalle_from_jax(trees[0], tcfg, device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert shapes == {n: p.shape for n, p in bridged.named_parameters()}
    assert shapes["transformer.layers.0.ff.moe.w1"] == (4, 32, 256)
    w1 = model.transformer.layers[1].ff.moe.w1
    assert 0 < float(w1.detach().abs().max()) <= 32 ** -0.5


@pytest.mark.parametrize("attn_impl,bwd_impl", [("xla", "xla"),
                                                ("flash", "pallas")])
def test_moe_dalle_loss_with_aux_and_gradients_match_jax(trees, batch_np,
                                                         attn_impl,
                                                         bwd_impl):
    """The train-mode loss (dropout 0.1) includes moe_aux_coef * aux, and
    every gradient (router, experts, attention) equals JAX's."""
    jcfg, tcfg = cfgs(attn_impl=attn_impl, attn_bwd_impl=bwd_impl,
                      attn_dropout=0.1, ff_dropout=0.1, moe_aux_coef=0.5)
    dalle, _ = trees
    model = from_jax.dalle_from_jax(dalle, tcfg, device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg))(
        dalle, jb, jax.random.PRNGKey(5))
    loss = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(5))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    # the aux term is in the loss: without it the loss drops
    with torch.no_grad():
        h, aux = TT.transformer_apply(
            model.transformer, TD.embed_prompt(
                model, tbatch(batch_np)["text"], tbatch(batch_np)["image"]),
            cfg=tcfg.transformer, with_aux=True)
    assert float(aux) > 0
    want = dict(from_jax.dalle_from_jax(jax.device_get(jgrads), tcfg,
                                        device="cpu").named_parameters())
    n = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)
        n += "moe" in name
    assert n == 6


def test_moe_generate_tokens_identical_to_jax(trees):
    jcfg, tcfg = cfgs()
    dalle, vae = trees
    model = from_jax.dalle_from_jax(dalle, tcfg, device="cpu")
    tvae = from_jax.vae_from_jax(vae, tcfg.vae, device="cpu")
    text = np.random.RandomState(0).randint(1, 64, (2, 8))
    _, jseq = JD.generate_images(dalle, vae, jnp.asarray(text), cfg=jcfg,
                                 rng=jax.random.PRNGKey(3),
                                 return_img_seq=True)
    _, tseq = TD.generate_images(model, tvae, torch.tensor(text),
                                 rng=prng.prng_key(3), return_img_seq=True)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
