"""Megatron tensor parallelism in the port on CPU process groups (gloo),
against the JAX package.

``parallel/train.py::dalle_param_specs(tp=)`` equals JAX's
``PartitionSpec`` tree leaf for leaf (the port's specs laid out
depth-stacked with (in, out) linear weights), for a DALLE of an even and
of an odd vocabulary, with and without ``mesh=`` (its divisibility
fallback), and for a bare transformer. Under ``setup_sharded`` a tp rank
holds its heads' rows of each third of ``qkv``, its slice of GEGLU's two
halves, the matching rows of ``out`` and ``w2`` and its columns of the
vocabulary: the FF and attention branches in train mode (dropout 0.1,
the FF mask drawn as the rank's columns of the one-process mask) equal
JAX's one-device branches, and two Adam steps with the global-norm clip
give JAX's one-device loss and parameters (gathered, 2e-5) at tp 2 (even
vocabulary: the column-parallel head's softmax across ranks; odd: the
head whole through ``mesh=``), dp 2 x tp 2 and tp 2 x sp 2 (ring, the
rank's heads; dropout 0 against the one-device step, dropout 0.1's loss
against JAX's sequence-parallel loss). A tp rank stores the reckoned
share of the parameters. float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.ops import transformer as JT
from dalle_pytorch_tpu.parallel import make_mesh, sp_dalle_loss_fn
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.ops import core as TCORE
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel import train as TP
from dalle_pytorch_tpu_torch.parallel.launch import spawn
from dalle_pytorch_tpu_torch.parallel.mesh import Mesh

import torch_parallel_jax as J
import torch_parallel_ranks as R

NO_DROPOUT = dict(J.DALLE, attn_dropout=0.0, ff_dropout=0.0)
# the head's loss streamed over 8-position chunks (24 positions: 3)
CHUNKED = dict(J.DALLE, loss_chunk=8)
STACK = dict(dim=32, depth=2, seq_len=24, heads=4, dim_head=8,
             attn_dropout=0.1, ff_dropout=0.1)


def port_mesh(axes):
    return Mesh(dict(axes), np.arange(int(np.prod(list(axes.values())))),
                {a: 0 for a in axes}, {})


# -- the specs ------------------------------------------------------------------

@pytest.mark.parametrize("vocab", ["even", "odd"])
@pytest.mark.parametrize("fit", [False, True], ids=["no_mesh", "mesh"])
def test_dalle_param_specs_match_jax(vocab, fit):
    kw = J.DALLE if vocab == "even" else J.ODD_VOCAB
    params, _ = J.setup(kw)
    model = from_jax.dalle_from_jax(params, J.torch_cfg(kw), device="cpu")
    axes = {"tp": 2, "fsdp": 2}
    jmesh = make_mesh(axes, jax.devices()[:4]) if fit else None
    want = J.jax_specs(params, JP.dalle_param_specs(
        params, tp="tp", fsdp="fsdp", mesh=jmesh))
    got = J.port_specs_as_jax(model, TP.dalle_param_specs(
        model, tp="tp", fsdp="fsdp", mesh=port_mesh(axes) if fit else None))
    assert got == want
    head = got[("to_logits", "proj", "w")]
    assert head == ((None, None) if fit and vocab == "odd" else (None, "tp"))


def test_transformer_specs_match_jax_and_depth_fallback():
    """A bare stack's tree (JAX's test_parallel.py:195-202), and an fsdp
    axis the depth does not divide dropped by ``mesh=``."""
    cfg = JT.TransformerConfig(**dict(STACK, depth=3))
    params = jax.device_get(JT.transformer_init(jax.random.PRNGKey(0), cfg))
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig
    model = from_jax.transformer_from_jax(
        params, TransformerConfig(**dict(STACK, depth=3)), device="cpu")
    for axes in ({"tp": 2}, {"tp": 2, "fsdp": 2}):
        jmesh = make_mesh(axes, jax.devices()[:int(np.prod(list(
            axes.values())))])
        fsdp = axes.get("fsdp") and "fsdp"
        want = J.jax_specs(params, JP.dalle_param_specs(
            params, tp="tp", fsdp=fsdp, mesh=jmesh))
        got = J.port_specs_as_jax(model, TP.dalle_param_specs(
            model, tp="tp", fsdp=fsdp, mesh=port_mesh(axes)))
        assert got == want
        assert got[("attn", "qkv", "w")] == (None, None, "tp")


def test_setup_sharded_refuses_what_the_mesh_cannot_place():
    """Without ``mesh=`` an odd vocabulary keeps its tp split, and
    ``setup_sharded`` refuses it with a ``ValueError`` (JAX refuses the
    placement when it puts the array)."""
    params, _ = J.setup(J.ODD_VOCAB)
    model = from_jax.dalle_from_jax(params, J.torch_cfg(J.ODD_VOCAB),
                                    device="cpu")
    specs = TP.dalle_param_specs(model, tp="tp")
    with pytest.raises(ValueError, match="logits_proj.weight: dimension 0 "
                                         "of size 97 does not split"):
        TP.setup_sharded(model, R._Nothing(), port_mesh({"tp": 2}), specs)


# -- dropout under tp -------------------------------------------------------------

@pytest.mark.parametrize("rows", [0, 2])
def test_tp_dropout_draws_its_columns_of_the_whole_mask(rows):
    """``core.dropout(cols=)`` on a rank's columns (and rows, under
    ``batch_rows``) is that block of JAX's one-device dropout."""
    x = np.random.RandomState(0).randn(4, 6, 16).astype(np.float32)
    from dalle_pytorch_tpu.ops import core as JCORE
    want = np.asarray(JCORE.dropout(jax.random.PRNGKey(4), jnp.asarray(x),
                                    0.1, True))
    for r in range(2):
        part = torch.tensor(x[rows:, :, r * 8:(r + 1) * 8])
        with prng.batch_rows(rows):
            got = TCORE.dropout(prng.prng_key(4), part, 0.1, True,
                                cols=(r * 8, 16))
        np.testing.assert_array_equal(got.numpy(),
                                      want[rows:, :, r * 8:(r + 1) * 8])


# -- the ranks ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    cfg = JT.TransformerConfig(**STACK)
    params = jax.device_get(JT.transformer_init(jax.random.PRNGKey(0), cfg))
    x = np.random.RandomState(1).randn(2, 24, 32).astype(np.float32)
    return cfg, params, x


@pytest.fixture(scope="module")
def tp2(stack):
    _, params, x = stack
    items = [("tp_branches_case", {"cfg": STACK, "params": params, "x": x,
                                   "seed": 9}),
             ("step_case", J.step_spec(J.DALLE, {"tp": 2}, {"tp": "tp"})),
             ("step_case", J.step_spec(J.ODD_VOCAB, {"tp": 2}, {"tp": "tp"},
                                       fit=True)),
             ("tp_logits_case", J.step_spec(J.DALLE, {"tp": 2},
                                            {"tp": "tp"})),
             ("step_case", J.step_spec(CHUNKED, {"tp": 2}, {"tp": "tp"}))]
    return spawn(R.run_cases, 2, (items,), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def four():
    items = [("step_case", J.step_spec(J.DALLE, {"dp": 2, "tp": 2},
                                       {"tp": "tp"})),
             ("step_case", J.step_spec(NO_DROPOUT, {"tp": 2, "sp": 2},
                                       {"tp": "tp"}, kind="sp")),
             ("step_case", J.step_spec(J.DALLE, {"tp": 2, "sp": 2},
                                       {"tp": "tp"}, kind="sp", steps=1))]
    return spawn(R.run_cases, 4, (items,), device="cpu", timeout_s=240)


def test_tp_branches_match_jax_one_device(stack, tp2):
    cfg, params, x = stack
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, (1, 2))[0]
    layer = jax.tree.map(lambda a: a[0], params)
    xj = jnp.asarray(x)
    want_ff = JT.ff_branch(layer, xj, cfg, keys[1], True)
    want_attn = JT.attn_branch(layer, xj, None, cfg, False, keys[0], True)
    want = JT.transformer_apply(params, xj, cfg=cfg, rng=key, train=True)
    for got in (tp2[0][0], tp2[1][0]):
        np.testing.assert_allclose(got["ff"], np.asarray(want_ff),
                                   atol=2e-5)
        np.testing.assert_allclose(got["attn"], np.asarray(want_attn),
                                   atol=2e-5)
        np.testing.assert_allclose(got["stack"], np.asarray(want),
                                   atol=2e-5)
        # each rank holds half of each of GEGLU's two halves
        assert got["w1_rows"] == 32 * 4


@pytest.mark.parametrize("vocab, case", [("even", 1), ("odd", 2),
                                         ("chunked", 4)])
def test_tp2_step_matches_jax_one_device_step(tp2, vocab, case):
    """Even: the softmax across the ranks' vocabulary columns; odd: the
    head whole; chunked: the split softmax under ``loss_chunk``."""
    kw = {"even": J.DALLE, "odd": J.ODD_VOCAB, "chunked": CHUNKED}[vocab]
    want = J.jax_steps(kw)
    for rank in tp2:
        J.assert_step_matches(rank[case], want)


def test_tp2_rank_stores_its_share(tp2):
    """Per rank: the embeddings, layer norms and the out/w2 biases whole,
    half of every qkv, out, w1 (and its bias) and w2, and half of the
    head (even vocabulary) or all of it (odd)."""
    for vocab, case in (("even", 1), ("odd", 2)):
        kw = J.DALLE if vocab == "even" else J.ODD_VOCAB
        params, _ = J.setup(kw)
        model = from_jax.dalle_from_jax(params, J.torch_cfg(kw),
                                        device="cpu")
        total = sum(p.numel() for p in model.parameters())
        split = sum(p.numel() for n, p in model.named_parameters()
                    if n.endswith(("qkv.weight", "out.weight", "w1.weight",
                                   "w1.bias", "w2.weight"))
                    or (vocab == "even" and n.startswith("logits_proj")))
        for rank in tp2:
            assert rank[case]["stage_params"] == total - split // 2


def test_dp2_tp2_step_matches_jax_one_device_step(four):
    want = J.jax_steps(J.DALLE)
    for rank in four:
        J.assert_step_matches(rank[0], want)


def test_tp2_sp2_step_matches_jax_one_device_step(four):
    """tp inside sp: ring attention on the rank's heads (JAX's dp x tp x
    sp, ``__graft_entry__.py:181-224``), dropout 0."""
    want = J.jax_steps(NO_DROPOUT)
    for rank in four:
        J.assert_step_matches(rank[1], want)


def test_tp2_sp2_loss_with_dropout_matches_jax_sp_loss(four):
    """With dropout 0.1 the masks are positional (the same at every sp
    degree and, over tp, each rank's columns of them): the step's loss
    against JAX's ``sp_dalle_loss_fn``."""
    params, batch = J.setup(J.DALLE)
    mesh = make_mesh({"dp": 1, "sp": 2}, jax.devices()[:2])
    loss = sp_dalle_loss_fn(J.jax_cfg(J.DALLE), mesh, batch_axis="dp",
                            impl="ring")
    want = float(loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(J.SEED)))
    for rank in four:
        np.testing.assert_allclose(rank[2]["losses"][0], want, rtol=1e-5)


def test_tp_logits_are_gathered_whole(tp2):
    """``dalle_apply``'s masked logits under a column-parallel head come
    back whole on every rank: JAX's one-device logits."""
    params, batch = J.setup(J.DALLE)
    want = JD.dalle_apply(params, jnp.asarray(batch["text"]),
                          jnp.asarray(batch["image"]),
                          cfg=J.jax_cfg(J.DALLE),
                          mask=jnp.asarray(batch["mask"]))
    for rank in tp2:
        np.testing.assert_allclose(rank[3], np.asarray(want), atol=2e-5)
