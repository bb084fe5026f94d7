"""Int8 weights (``ops/quant.py``, ``core.linear``'s int8 branch,
``models/dalle.py::quantize_for_decode``) against the JAX package on
the CPU. The int8 weights and their scales must be EQUAL (the same
symmetric rounding, half to even, of the same float32 values); the
quantized linear's output is held to rtol/atol 1e-6 in float32 (one
product in another summation order) and to JAX's bfloat16 output within
one bf16 rounding (rtol 1e-2) in bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import core as JCORE
from dalle_pytorch_tpu.ops import quant as JQ
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import quant


def linear_pair(bias: bool, seed=0, n_in=24, n_out=40):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n_in, n_out) * 0.3).astype(np.float32)
    w[:, 3] = 0.0                                   # the 1e-12 floor
    p = {"w": w}
    if bias:
        p["b"] = rs.randn(n_out).astype(np.float32)
    lin = nn.Linear(n_in, n_out, bias=bias)
    from_jax._linear(lin, p)
    return p, lin


@pytest.mark.parametrize("bias", [False, True])
def test_quantize_linear_int8_equals_jax(bias):
    p, lin = linear_pair(bias)
    jq = JQ.quantize_linear_int8({k: jnp.asarray(v) for k, v in p.items()})
    tq = quant.quantize_linear_int8(lin)
    assert tq.w_q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.w_q.numpy().T, np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq["scale"]))
    assert (tq.bias is None) == (not bias)
    assert not list(tq.parameters())                # buffers, not weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_matches_jax(bias, dtype):
    """x's dtype for the product and the scale, as JAX orders them."""
    p, lin = linear_pair(bias, seed=1)
    jq = JQ.quantize_linear_int8({k: jnp.asarray(v) for k, v in p.items()})
    tq = quant.quantize_linear_int8(lin)
    x = np.random.RandomState(2).randn(5, 24).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx).astype(np.float32)).to(
        getattr(torch, dtype))
    want = np.asarray(JCORE.linear(jq, jx)).astype(np.float32)
    got = core.linear(tq, tx)
    assert got.dtype == tx.dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" \
        else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_quantize_for_decode_matches_jax_tree():
    """Every linear of the transformer and the vocabulary head in int8
    with JAX's values; embeddings and layernorms as they were; the
    original model untouched."""
    vcfg = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
                hidden_dim=8)
    kw = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
              dim_head=16)
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**vcfg), **kw)
    tcfg = TD.DALLEConfig(vae=TV.VAEConfig(**vcfg), **kw)
    params = jax.device_get(JD.dalle_init(jax.random.PRNGKey(0), jcfg))
    model = from_jax.dalle_from_jax(params, tcfg, device="cpu")
    jq = JD.quantize_for_decode(params)
    tq = TD.quantize_for_decode(model)
    assert isinstance(model.logits_proj, nn.Linear)         # untouched
    assert tq.text_emb is model.text_emb
    head = jq["to_logits"]["proj"]
    np.testing.assert_array_equal(tq.logits_proj.w_q.numpy().T,
                                  np.asarray(head["w_q"]))
    np.testing.assert_array_equal(tq.logits_proj.scale.numpy(),
                                  np.asarray(head["scale"]))
    stack = jq["transformer"]
    for i, layer in enumerate(tq.transformer.layers):
        for mod, leaf in ((layer.attn.qkv, stack["attn"]["qkv"]),
                          (layer.attn.out, stack["attn"]["out"]),
                          (layer.ff.w1, stack["ff"]["w1"]),
                          (layer.ff.w2, stack["ff"]["w2"])):
            assert isinstance(mod, quant.QuantLinear)
            np.testing.assert_array_equal(mod.w_q.numpy().T,
                                          np.asarray(leaf["w_q"][i]))
            np.testing.assert_array_equal(mod.scale.numpy(),
                                          np.asarray(leaf["scale"][i]))
        assert isinstance(layer.attn.ln, nn.LayerNorm)
