"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's, on the CPU, where the port runs the kernels' plain versions
and JAX runs its Pallas kernels in interpret mode, as its own tests do.

Covered: ``out``, ``m`` and ``l`` against ``_flash_fwd``; the gradients
of q, k and v against ``jax.grad`` of ``flash_attention`` under each
``bwd_impl`` ('xla' blockwise, 'pallas' split, 'pallas_fused'); causal
and not; no mask, an all-True mask, and a pad mask with fully padded
query rows (the uniform-over-the-causal-prefix case); a ragged n (not a
multiple of the tile), an exact multiple, and n shorter than one tile.
float32 throughout, rtol/atol 1e-5: both sides are f32 CPU math that
differs only in summation order (observed differences ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import flash_attention as JF
from dalle_pytorch_tpu_torch.ops import flash_attention as TF


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.3
# (n, JAX tile): one exact tile shorter than the kernels' 64, a ragged
# tail, an exact multiple of the tile
SHAPES = [(24, 128), (40, 16), (48, 16)]


def inputs(n, mask_kind, seed=0):
    rs = np.random.RandomState(seed + n)
    b, h, d = 2, 2, 16
    q, k, v, do = (rs.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind == "all_true":
        mask = np.ones((b, n), bool)
    elif mask_kind == "pad":
        mask = np.ones((b, n), bool)
        mask[0, :5] = False           # fully padded leading query rows
        mask[1, n - 9:] = False       # a padded tail
        mask[1, 7] = False
    return q, k, v, do, mask


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("n,tile", SHAPES)
@pytest.mark.parametrize("mask_kind", ["none", "all_true", "pad"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_out_and_stats_match_jax(n, tile, mask_kind, causal):
    q, k, v, _, mask = inputs(n, mask_kind)
    jm = None if mask is None else jnp.asarray(mask)
    out, (m, l) = JF._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jm, SCALE, causal,
                                min(tile, n), min(tile, n), True)
    tm = None if mask is None else torch.tensor(mask)
    t_out, t_m, t_l = TF.flash_attention_fwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=SCALE,
        causal=causal, mask=tm)
    close(t_out, out)
    close(t_m, m)
    close(t_l, l)
    if mask_kind == "pad" and causal:
        # a fully padded row: max at the fill, uniform over its prefix
        assert float(t_m[0, 0, 3]) == float(np.float32(TF.FILL))
        assert float(t_l[0, 0, 3]) == 4.0


@pytest.mark.parametrize("bwd_impl", TF.BWD_IMPLS)
@pytest.mark.parametrize("n,tile,mask_kind,causal", [
    (40, 16, "pad", True), (40, 16, "pad", False), (40, 16, "none", True),
    (24, 128, "all_true", True), (48, 16, "pad", True)])
def test_gradients_match_jax_grad(bwd_impl, n, tile, mask_kind, causal):
    q, k, v, do, mask = inputs(n, mask_kind, seed=1)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        out = JF.flash_attention(q, k, v, scale=SCALE, causal=causal,
                                 mask=jm, block_q=tile, block_k=tile,
                                 bwd_impl=bwd_impl)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = TF.flash_attention(
        *leaves, scale=SCALE, causal=causal,
        mask=None if mask is None else torch.tensor(mask), block_q=tile,
        block_k=tile, bwd_impl=bwd_impl)
    (out * torch.tensor(do)).sum().backward()
    for t, j in zip(leaves, want):
        close(t.grad, j)


@pytest.mark.parametrize("block_k", [7, 16, 64])
def test_blockwise_backward_does_not_depend_on_its_tile(block_k):
    """The plain blockwise backward walks block_k key columns at a time
    (ragged last tile included); every tile gives the one-shot
    gradients of the kernels' plain versions."""
    q, k, v, do, mask = (torch.tensor(x) if x is not None else None
                         for x in inputs(40, "pad", seed=2))
    kw = dict(scale=SCALE, causal=True, mask=mask)
    out, m, l = TF.flash_attention_fwd_plain(q, k, v, **kw)
    dstat = (do * out).sum(-1)
    dq = TF.flash_attention_bwd_dq_plain(q, k, v, do, m, l, dstat, **kw)
    dk, dv, dq_f = TF.flash_attention_bwd_dkv_plain(
        q, k, v, do, m, l, dstat, with_dq=True, **kw)
    got = TF.blockwise_attention_bwd(
        q, k, v, mask, do, out, (m, l), scale=SCALE, block_k=block_k,
        structural_mask_fn=lambda r, c: c[None, :] <= r[:, None])
    for g, w in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(g, w, **TOL)
    torch.testing.assert_close(dq_f, dq, **TOL)


def test_flash_attention_rejects_unknown_bwd_impl_and_bad_masks():
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="bwd_impl"):
        TF.flash_attention(q, q, q, bwd_impl="triton")
    with pytest.raises(ValueError, match="mask"):
        TF.flash_attention(q, q, q, mask=torch.ones((1, 8)))
    with pytest.raises(ValueError, match="shape"):
        TF.flash_attention_fwd(q, q[..., :8], q, scale=1.0, causal=True)
