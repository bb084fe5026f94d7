"""The port's block-sparse attention against the JAX package's, on the
CPU: the VariableSparsity layout and visible-page tables, the two plain
sparse impls, kernel K3's plain forward against JAX ``_bs_fwd`` in
interpret mode, and the autograd ``Function``'s gradients through both
backward routes (the static diagonal + global-strip pieces, and the
blockwise scan) against ``jax.grad`` of JAX ``block_sparse_attention``.

The tables are integers and must be equal. float32 unless said;
tolerances: forward rtol/atol 1e-5 (one softmax over at most 80 keys in
another summation order), gradients rtol/atol 1e-4 (the loss's gradient
reaches a few units, summed over up to 80 keys and 160 rows in another
order).

bfloat16 (``test_block_sparse_bf16_forward_rounds_like_jax_kernel``):
the TPU kernel rounds p to v's dtype before the PV product, and so must
the plain version, the yardstick of the CUDA kernel. The kernel rounds
each tile's p against its running max, the plain version against the
row's max, so single roundings of p differ: each output is held to one
bf16 rounding (2^-7) of its magnitude sum_j p_j |v_j| / l, and at b 1,
h 2, n 256, d 64 under 15 % of the outputs may differ at all (9 % do;
with p kept in f32, 35 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import block_sparse as JB
from dalle_pytorch_tpu.ops import sparse as JS
from dalle_pytorch_tpu_torch.ops import block_sparse as TB
from dalle_pytorch_tpu_torch.ops import flash_attention as TF
from dalle_pytorch_tpu_torch.ops import sparse as TS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def qkv(n, b=2, h=2, d=16, seed=0):
    rs = np.random.RandomState(seed + n)
    return tuple(rs.randn(b, h, n, d).astype(np.float32) for _ in range(3))


def key_mask(n, b=2):
    """Pad keys: a padded tail and a padded span inside the text."""
    m = np.ones((b, n), bool)
    m[0, n - 11:] = False
    m[1, 3:9] = False
    return m


def t(x):
    return None if x is None else torch.tensor(x)


def j(x):
    return None if x is None else jnp.asarray(x)


# -- layout tables ---------------------------------------------------------------

@pytest.mark.parametrize("seq,page,block", [
    (24, 8, 4), (72, 8, 4), (160, 16, 16), (100, 8, 16), (1280, 16, 16),
    (1280, 8, 16), (48, 16, 16)])
def test_layout_and_visibility_tables_equal_jax(seq, page, block):
    padded = -(-seq // block) * block
    np.testing.assert_array_equal(
        TS.token_layout_mask(padded, block),
        JS.token_layout_mask(padded, block))
    np.testing.assert_array_equal(
        TS.variable_sparsity_layout(padded // block, causal=False),
        JS.variable_sparsity_layout(padded // block, causal=False))
    got = TS.visible_pages_causal(seq, page, block)
    want = JS.visible_pages_causal(seq, page, block)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert not got[0].flags.writeable
    vis, cnt = TS.visible_pages(seq, page, block)
    np.testing.assert_array_equal(vis, want[0])
    np.testing.assert_array_equal(cnt, want[1])


# -- the two plain impls ----------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,block", [(160, 16), (48, 16), (72, 8)])
def test_sparse_ref_and_windowed_match_jax(n, block, masked, causal):
    q, k, v = qkv(n)
    mask = key_mask(n) if masked else None
    kw = dict(scale=0.3, causal=causal, block=block)
    want = np.asarray(JS.sparse_attention_ref(j(q), j(k), j(v), mask=j(mask),
                                              **kw))
    for fn in (TS.sparse_attention_ref, TS.sparse_attention_windowed):
        got = fn(t(q), t(k), t(v), mask=t(mask), **kw)
        np.testing.assert_allclose(got.numpy(), want, **FWD,
                                   err_msg=fn.__name__)


# -- K3: the forward's plain version -----------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,block,causal", [(256, 16, True), (160, 16, True),
                                            (48, 16, True), (72, 8, True),
                                            (160, 16, False)])
def test_block_sparse_forward_matches_jax_kernel(n, block, causal, masked):
    q, k, v = qkv(n)
    mask = key_mask(n) if masked else None
    bq = min(128, n)
    out, (m, l) = JB._bs_fwd(j(q), j(k), j(v), j(mask), 0.3, causal, block, 4,
                             (0,), bq, bq, True)
    before = TB.block_sparse_attention_fwd.launches
    got = TB.block_sparse_attention_fwd(t(q), t(k), t(v), scale=0.3,
                                        causal=causal, block=block,
                                        mask=t(mask))
    assert TB.block_sparse_attention_fwd.launches == before  # plain on CPU
    for g, w, what in zip(got, (out, m, l), ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD,
                                   err_msg=what)
    # the plain version is the oracle's function too (queries unmasked)
    ref = TS.sparse_attention_ref(t(q), t(k), t(v), scale=0.3,
                                  causal=causal, block=block, mask=t(mask))
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), **FWD)


def bf16_case(n, block, causal, masked, b=2, h=2, d=16):
    """bf16 inputs made from the f32 ``qkv``; the plain forward's out and
    its magnitude (the plain forward over |v| in f32), and JAX
    ``_bs_fwd``'s out in interpret mode, all as f32 numpy."""
    rs = np.random.RandomState(n)
    q, k, v = (rs.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    mask = key_mask(n, b) if masked else None
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    bq = min(128, n)
    scale = d ** -0.5
    want, _ = JB._bs_fwd(jq, jk, jv, j(mask), scale, causal, block, 4, (0,),
                         bq, bq, True)
    tq, tk, tv = (torch.tensor(np.asarray(jnp.asarray(x, jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    kw = dict(scale=scale, causal=causal, block=block, mask=t(mask))
    got = TB.block_sparse_attention_fwd(tq, tk, tv, **kw)[0]
    assert got.dtype == torch.bfloat16
    mag = TB.block_sparse_attention_fwd_plain(tq.float(), tk.float(),
                                              tv.float().abs(), **kw)[0]
    return (got.float().numpy(), mag.numpy(),
            np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,block,causal", [(256, 16, True), (160, 16, True),
                                            (48, 16, True), (72, 8, True),
                                            (160, 16, False)])
def test_block_sparse_bf16_forward_rounds_like_jax_kernel(n, block, causal,
                                                          masked):
    got, mag, want = bf16_case(n, block, causal, masked)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * mag)


def test_block_sparse_bf16_forward_differs_from_jax_in_few_outputs():
    got, mag, want = bf16_case(256, 16, True, False, b=1, d=64)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * mag)
    assert float((got != want).mean()) < 0.15


def test_fully_padded_rows_average_their_allowed_keys():
    """A row whose every allowed key is padding keeps m == FILL and
    weighs those keys evenly (l = their count), as the TPU kernel does."""
    q, k, v = qkv(64, b=1)
    mask = np.zeros((1, 64), bool)
    mask[0, 40:] = True
    out, m, l = TB.block_sparse_attention_fwd_plain(
        t(q), t(k), t(v), scale=0.3, causal=True, block=16, mask=t(mask))
    assert float(m[0, 0, 5]) == np.float32(TB.FILL)
    assert float(l[0, 0, 5]) == 6.0
    np.testing.assert_allclose(out[0, 0, 5].numpy(),
                               v[0, 0, :6].mean(0), **FWD)


# -- gradients: both backward routes ------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,block,route", [(256, 16, "static"),
                                           (160, 16, "generic"),
                                           (48, 16, "generic")])
def test_block_sparse_gradients_match_jax(n, block, route, masked,
                                          monkeypatch):
    q, k, v = qkv(n)
    mask = key_mask(n) if masked else None
    tgt = np.random.RandomState(n).randn(*q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = JB.block_sparse_attention(q, k, v, scale=0.2, causal=True,
                                      mask=j(mask), block=block)
        return jnp.sum((o - tgt) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(j(q), j(k), j(v))

    calls = []
    static = TB._bs_bwd_static
    monkeypatch.setattr(TB, "_bs_bwd_static",
                        lambda *a, **kw: calls.append(1) or static(*a, **kw))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = TB.block_sparse_attention(*leaves, scale=0.2, causal=True,
                                  mask=t(mask), block=block)
    ((o - torch.tensor(tgt)) ** 2).sum().backward()
    assert bool(calls) == (route == "static")
    for leaf, w, what in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD,
                                   err_msg=f"d{what}")


def test_static_tile_schedule_selection():
    """The same cases as the JAX package's own schedule test."""
    s = TB._static_tile_schedule
    assert s(128, 128, 16, 64, (0,), True) == [0]
    assert s(128, 128, 16, 64, (0, 8), True) == [0, 1]
    assert s(128, 128, 16, 64, (0,), False) is None
    assert s(64, 128, 16, 64, (0,), True) is None
    assert s(96, 96, 16, 64, (0,), True) is None
    assert s(64, 64, 48, 16, (1,), True) is None
    for args in ((128, 128, 16, 64, (0,), True), (64, 64, 48, 16, (1,), True),
                 (128, 128, 16, 64, (0, 8), True)):
        assert s(*args) == JB._static_tile_schedule(*args)


# -- head dims other than the kernels' 64 and 128 ---------------------------
# On the card K3's wrapper runs such a d through the flash kernels'
# ``at_kernel_dim_head`` (zero-padded to the next kernel width, sliced
# back). Around the plain version the padding must change nothing but
# the summation blocking of the wider products: rtol/atol 1e-6.


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 24, 48, 96])
def test_block_sparse_padding_to_kernel_width_is_exact(d, dtype, causal,
                                                       masked):
    dtype = getattr(torch, dtype)
    q, k, v = (t(x).to(dtype) for x in qkv(160, d=d, seed=d))
    kw = dict(scale=d ** -0.5, causal=causal, block=16,
              mask=t(key_mask(160)) if masked else None)
    got = TF.at_kernel_dim_head(TB.block_sparse_attention_fwd_plain, q, k,
                                v, **kw)
    want = TB.block_sparse_attention_fwd_plain(q, k, v, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 48])
def test_block_sparse_padded_plain_matches_jax_kernel(d, causal, masked):
    """Padded to the kernel width and sliced back, K3's plain version
    against JAX ``_bs_fwd`` at the real d in interpret mode (float32,
    the module's forward tolerance)."""
    n, block = 160, 16
    q, k, v = qkv(n, d=d, seed=d)
    mask = key_mask(n) if masked else None
    out, (m, l) = JB._bs_fwd(j(q), j(k), j(v), j(mask), d ** -0.5, causal,
                             block, 4, (0,), 128, 128, True)
    got = TF.at_kernel_dim_head(TB.block_sparse_attention_fwd_plain, t(q),
                                t(k), t(v), scale=d ** -0.5, causal=causal,
                                block=block, mask=t(mask))
    for g, w, what in zip(got, (out, m, l), ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD,
                                   err_msg=what)


# Heads wider than 128: K3's wrapper hands the wide body a multiple of 64
# (d 130 zero-padded to 192 and sliced back; 192, 256 and 320 as they
# are), exact around the plain version (rtol/atol 1e-6); the plain
# version against JAX's kernel at d 192, 256 and 320 (the module's
# forward tolerance).


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [130, 192, 256, 320])
def test_block_sparse_wide_padding_is_exact(d, causal, masked):
    q, k, v = (t(x) for x in qkv(48, d=d, seed=d))
    kw = dict(scale=d ** -0.5, causal=causal, block=16,
              mask=t(key_mask(48)) if masked else None)
    got = TF.at_kernel_dim_head(TB.block_sparse_attention_fwd_plain, q, k,
                                v, **kw)
    want = TB.block_sparse_attention_fwd_plain(q, k, v, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [192, 256, 320])
def test_block_sparse_wide_plain_matches_jax_kernel(d, causal, masked):
    n, block = 48, 16
    q, k, v = qkv(n, d=d, seed=d)
    mask = key_mask(n) if masked else None
    out, (m, l) = JB._bs_fwd(j(q), j(k), j(v), j(mask), d ** -0.5, causal,
                             block, 4, (0,), n, n, True)
    got = TB.block_sparse_attention_fwd(t(q), t(k), t(v), scale=d ** -0.5,
                                        causal=causal, block=block,
                                        mask=t(mask))
    for g, w, what in zip(got, (out, m, l), ("out", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD,
                                   err_msg=what)


# (dtype, d, the kernel csrc/block_sparse.cu launches for it): bfloat16 on
# the tensor cores up to 128 and at 192 and 256 (and a d padded to them),
# float32 and bfloat16 above 256 on CUDA cores
BODY_ROUTES = [
    ("bfloat16", 64, "block_sparse_fwd_wgmma_kernel"),
    ("bfloat16", 16, "block_sparse_fwd_wgmma_kernel"),
    ("bfloat16", 128, "block_sparse_fwd_wgmma_kernel"),
    ("bfloat16", 192, "block_sparse_fwd_wide_wgmma_kernel"),
    ("bfloat16", 256, "block_sparse_fwd_wide_wgmma_kernel"),
    ("bfloat16", 130, "block_sparse_fwd_wide_wgmma_kernel"),
    ("bfloat16", 320, "block_sparse_fwd_wide_kernel"),
    ("bfloat16", 257, "block_sparse_fwd_wide_kernel"),
    ("float32", 64, "block_sparse_fwd_kernel"),
    ("float32", 192, "block_sparse_fwd_wide_kernel"),
    ("float32", 256, "block_sparse_fwd_wide_kernel"),
]


@pytest.mark.parametrize("dtype,d,kernel", BODY_ROUTES)
def test_block_sparse_kernel_body_routes_each_call(dtype, d, kernel):
    """K3's dispatch helper names the wide tensor-core body for bfloat16
    at d 192 and 256 (and a d padded to them), and the route the wrapper
    passes to the C entry point (``wide_tensor_cores`` at the padded
    width) is the one it names."""
    dtype = getattr(torch, dtype)
    assert TB.kernel_body(dtype, d) == kernel
    assert TF.wide_tensor_cores(dtype, TF.kernel_dim_head(d)) == \
        (kernel == "block_sparse_fwd_wide_wgmma_kernel")


def test_block_sparse_kernel_body_names_kernels_of_the_source():
    """Every kernel K3's ``kernel_body`` names is a ``__global__`` function
    of ``csrc/block_sparse.cu``; it refuses a dtype the kernel does not
    take."""
    import pathlib
    import re
    src = (pathlib.Path(TB.__file__).parent.parent / "csrc" /
           "block_sparse.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                             r"\s*(\w+)\(", src))
    named = {TB.kernel_body(dtype, d)
             for dtype in (torch.float32, torch.bfloat16)
             for d in (16, 64, 128, 192, 256, 320)}
    assert named == kernels, (named, kernels)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TB.kernel_body(torch.float16, 64)
