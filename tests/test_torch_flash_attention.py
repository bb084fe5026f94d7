"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's, on the CPU, where the port runs the kernels' plain versions
and JAX runs its Pallas kernels in interpret mode, as its own tests do.

Covered: ``out``, ``m`` and ``l`` against ``_flash_fwd``; the gradients
of q, k and v against ``jax.grad`` of ``flash_attention`` under each
``bwd_impl`` ('xla' blockwise, 'pallas' split, 'pallas_fused'); causal
and not; no mask, an all-True mask, and a pad mask with fully padded
query rows (the uniform-over-the-causal-prefix case); a ragged n (not a
multiple of the tile), an exact multiple, and n shorter than one tile.
float32, rtol/atol 1e-5: both sides are f32 CPU math that differs only
in summation order (observed differences ~1e-6).

bfloat16 (``test_bf16_plain_versions_round_like_the_pallas_kernels``,
and ``test_bf16_fused_plain_version_rounds_like_the_pallas_kernel`` for
the fused backward at d 64 and 256): the Pallas kernels round p and ds
to the input dtype before the second product of each pair; the plain
versions must do the same, or a third or more of their bf16 outputs come
out one rounding away from JAX's.
"""

import functools

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


# -- bfloat16: where p and ds are rounded ----------------------------------

BF16_N, BF16_D, BF16_TILE = 256, 64, 128
# Largest share of bf16 outputs allowed to differ from JAX's, and largest
# difference. Forward: the Pallas kernel rescales its accumulator tile by
# tile (online softmax over 128-wide tiles) while the plain version
# normalises once, so some outputs land one bf16 rounding apart (11-19 %
# here, by at most 2^-9); rounding p before the PV product, as JAX does,
# is what keeps the share there: with p in f32 it is 28-39 %, by up to
# 2^-7. Backward: the same products in the same types, so only f32
# summation order differs (under 0.5 %); with p and ds in f32, 30-44 %.
BF16_BOUNDS = {"fwd": (0.25, 4e-3), "dq": (0.02, 4e-3), "dkv": (0.02, 4e-3)}


@functools.lru_cache(maxsize=None)
def bf16_case(causal, masked):
    """Inputs as bf16 numpy-made tensors and JAX's Pallas results
    (interpret mode): forward (out, m, l), backward (dq, dk, dv)."""
    rs = np.random.RandomState(0)
    q, k, v, do = (rs.randn(1, 2, BF16_N, BF16_D).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((1, BF16_N), bool)
        mask[0, :5] = False                  # fully padded query rows
        mask[0, 200:] = False                # a padded tail
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask)
    scale = BF16_D ** -0.5
    out, (m, l) = JF._flash_fwd(jq, jk, jv, jm, scale, causal, BF16_TILE,
                                BF16_TILE, True)
    grads = JF._pallas_attention_bwd(jq, jk, jv, jm, jdo, out, (m, l),
                                     scale=scale, causal=causal,
                                     block_q=BF16_TILE, block_k=BF16_TILE,
                                     interpret=True)

    def f32(x):
        return np.asarray(jnp.asarray(x, jnp.float32))

    def bf16(x):
        return torch.tensor(f32(x)).to(torch.bfloat16)

    ins = tuple(bf16(x) for x in (jq, jk, jv, jdo))
    return (ins, None if mask is None else torch.tensor(mask), scale,
            (bf16(out), torch.tensor(f32(m)), torch.tensor(f32(l))),
            tuple(f32(g) for g in grads))


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_versions_round_like_the_pallas_kernels(kind, masked,
                                                           causal):
    (q, k, v, do), mask, scale, (out, m, l), (dq, dk, dv) = bf16_case(
        causal, masked)
    kw = dict(scale=scale, causal=causal, mask=mask)
    if kind == "fwd":
        pairs = [(TF.flash_attention_fwd_plain(q, k, v, **kw)[0],
                  out.float().numpy())]
    else:
        dstat = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, m, l, dstat)
        if kind == "dq":
            pairs = [(TF.flash_attention_bwd_dq_plain(*args, **kw), dq)]
        else:
            got = TF.flash_attention_bwd_dkv_plain(*args, **kw)
            pairs = [(got[0], dk), (got[1], dv)]
    share_max, diff_max = BF16_BOUNDS[kind]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - want)
        share = float((diff > 0).mean())
        assert share <= share_max, (kind, share)
        assert float(diff.max()) <= diff_max, (kind, float(diff.max()))


# The fused K2b in bfloat16 (dq, dk and dv in one pass), at the narrow
# bodies' d 64 and the wide tensor-core bodies' d 256: JAX's
# ``_bwd_fused_kernel`` rounds ds to bf16 once and takes it into both dK
# and dQ, sums dq in f32 across key tiles and casts it to q's dtype after
# the call; the plain version (whose f32 dq the autograd backward casts
# the same way) must round ds there too. Same products of the same bf16
# values in f32, in another order: an output may land one bf16 rounding
# apart (at most 2^-7 of its value; observed in under 1.1 % of them), or
# 1e-5 off where its sum cancels to about 0 (observed 1.4e-6), in at
# most BF16_BOUNDS' backward share of them. With ds left in f32 a third
# or more would differ.
FUSED_N, FUSED_TILE = 96, 32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256])
def test_bf16_fused_plain_version_rounds_like_the_pallas_kernel(d, causal,
                                                                masked):
    rs = np.random.RandomState(d)
    q, k, v, do = (rs.randn(1, 2, FUSED_N, d).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((1, FUSED_N), bool)
        mask[0, :5] = False                  # fully padded query rows
        mask[0, 70:] = False                 # a padded tail
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask)
    scale = d ** -0.5
    out, (m, l) = JF._flash_fwd(jq, jk, jv, jm, scale, causal, FUSED_TILE,
                                FUSED_TILE, True)
    want = JF._pallas_attention_bwd(
        jq, jk, jv, jm, jdo, out, (m, l), scale=scale, causal=causal,
        block_q=FUSED_TILE, block_k=FUSED_TILE, interpret=True, fused=True)

    def f32(x):
        return np.asarray(jnp.asarray(x, jnp.float32))

    tq, tk, tv, tdo, tout = (torch.tensor(f32(x)).to(torch.bfloat16)
                             for x in (jq, jk, jv, jdo, out))
    dstat = (tdo.float() * tout.float()).sum(-1)
    dk, dv, dq32 = TF.flash_attention_bwd_dkv_plain(
        tq, tk, tv, tdo, torch.tensor(f32(m)), torch.tensor(f32(l)), dstat,
        scale=scale, causal=causal,
        mask=None if mask is None else torch.tensor(mask), with_dq=True)
    assert dq32.dtype == torch.float32
    share_max, _ = BF16_BOUNDS["dq"]
    for got, w in zip((dq32.to(torch.bfloat16), dk, dv), want):
        assert got.dtype == torch.bfloat16
        w = f32(w)
        diff = np.abs(got.float().numpy() - w)
        share = float((diff > 0).mean())
        assert share <= share_max, share
        excess = diff - (2.0 ** -7 * np.abs(w) + 1e-5)
        assert float(excess.max()) <= 0.0, float(diff.max())


# -- head dims other than the kernels' 64 and 128 ----------------------------
# On the card each wrapper runs such a d through ``at_kernel_dim_head``:
# q, k, v and dout zero-padded to the next kernel width, the kernel, the
# results sliced back. The helper is plain PyTorch, so here it wraps the
# kernels' plain versions: padded and sliced they must give the unpadded
# plain versions' values. The zero columns add exact zeros to every dot
# product, so only the summation blocking of the wider products may move
# an f32 result, by a rounding: rtol 1e-6 (atol 1e-6 for values near 0).

PAD_DIMS = (16, 24, 48, 96)
PAD_TOL = dict(rtol=1e-6, atol=1e-6)


def pad_inputs(d, dtype, masked, n=40, seed=3):
    rs = np.random.RandomState(seed + d)
    q, k, v, do = (torch.tensor(rs.randn(2, 2, n, d), dtype=torch.float32)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((2, n), dtype=torch.bool)
        mask[0, :5] = False           # fully padded leading query rows
        mask[1, n - 9:] = False       # a padded tail
    return q, k, v, do, mask


def plain_call(kind, q, k, v, do, mask, causal, pad):
    """One plain version's results, through the padding helper or not."""
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal, mask=mask)
    run = TF.at_kernel_dim_head if pad else \
        (lambda fn, *a, **k_: fn(*a, **k_))
    if kind == "fwd":
        return run(TF.flash_attention_fwd_plain, q, k, v, **kw)
    out, m, l = TF.flash_attention_fwd_plain(q, k, v, **kw)
    dstat = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, m, l, dstat)
    if kind == "dq":
        return (run(TF.flash_attention_bwd_dq_plain, *args, **kw),)
    dk, dv, dq = run(TF.flash_attention_bwd_dkv_plain, *args,
                     with_dq=kind == "dkv_fused", **kw)
    return (dk, dv) if dq is None else (dk, dv, dq)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv", "dkv_fused"])
def test_padding_to_kernel_width_is_exact(kind, d, dtype, causal, masked):
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = pad_inputs(d, dtype, masked)
    got = plain_call(kind, q, k, v, do, mask, causal, pad=True)
    want = plain_call(kind, q, k, v, do, mask, causal, pad=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.is_contiguous()
        torch.testing.assert_close(g.float(), w.float(), **PAD_TOL)


@pytest.mark.parametrize("d,width", [(1, 64), (16, 64), (63, 64), (64, 64),
                                     (65, 128), (96, 128), (128, 128),
                                     (129, 192), (130, 192), (192, 192),
                                     (256, 256), (300, 320), (320, 320)])
def test_kernel_dim_head_is_the_next_kernel_width(d, width):
    """Up to 128 the next narrow body's width, above it the next
    multiple of 64 (the wide bodies)."""
    assert TF.kernel_dim_head(d) == width


# (dtype, d, kind, the kernel csrc/flash_attention.cu launches for it)
BODY_ROUTES = [
    # bfloat16 K1, K2a and K2b (split and fused) at d 192 and 256: the
    # wide tensor-core bodies, also for a d the wrappers pad to those
    # widths
    ("bfloat16", 192, "fwd", "flash_fwd_wide_wgmma_kernel"),
    ("bfloat16", 256, "fwd", "flash_fwd_wide_wgmma_kernel"),
    ("bfloat16", 130, "fwd", "flash_fwd_wide_wgmma_kernel"),
    ("bfloat16", 192, "dkv", "flash_bwd_dkv_wide_wgmma_kernel"),
    ("bfloat16", 256, "dkv", "flash_bwd_dkv_wide_wgmma_kernel"),
    ("bfloat16", 255, "dkv", "flash_bwd_dkv_wide_wgmma_kernel"),
    ("bfloat16", 192, "fused", "flash_bwd_fused_wide_wgmma_kernel"),
    ("bfloat16", 256, "fused", "flash_bwd_fused_wide_wgmma_kernel"),
    ("bfloat16", 192, "dq", "flash_bwd_dq_wide_wgmma_kernel"),
    ("bfloat16", 256, "dq", "flash_bwd_dq_wide_wgmma_kernel"),
    ("bfloat16", 130, "dq", "flash_bwd_dq_wide_wgmma_kernel"),
    # float32 at every wide d, and bfloat16 above 256: CUDA cores
    ("float32", 192, "fwd", "flash_fwd_wide_kernel"),
    ("float32", 256, "dkv", "flash_bwd_dkv_wide_kernel"),
    ("bfloat16", 320, "fwd", "flash_fwd_wide_kernel"),
    ("bfloat16", 320, "dkv", "flash_bwd_dkv_wide_kernel"),
    ("bfloat16", 320, "fused", "flash_bwd_dkv_wide_kernel"),
    ("float32", 256, "fused", "flash_bwd_dkv_wide_kernel"),
    ("bfloat16", 257, "fwd", "flash_fwd_wide_kernel"),
    ("float32", 192, "dq", "flash_bwd_dq_wide_kernel"),
    ("float32", 256, "dq", "flash_bwd_dq_wide_kernel"),
    ("bfloat16", 320, "dq", "flash_bwd_dq_wide_kernel"),
    # up to 128 the narrow bodies: bfloat16 on the tensor cores (fused
    # K2b too), float32 on CUDA cores
    ("bfloat16", 64, "fwd", "flash_fwd_wgmma_kernel"),
    ("bfloat16", 16, "dq", "flash_bwd_dq_wgmma_kernel"),
    ("bfloat16", 128, "dkv", "flash_bwd_dkv_wgmma_kernel"),
    ("bfloat16", 128, "fused", "flash_bwd_fused_wgmma_kernel"),
    ("bfloat16", 64, "fused", "flash_bwd_fused_wgmma_kernel"),
    ("float32", 64, "fwd", "flash_fwd_kernel"),
    ("float32", 64, "fused", "flash_bwd_dkv_kernel"),
]


@pytest.mark.parametrize("dtype,d,kind,kernel", BODY_ROUTES)
def test_kernel_body_routes_each_call(dtype, d, kind, kernel):
    """The dispatch helper names the wide tensor-core bodies for bfloat16
    K1, K2a and K2b (split and fused) at d 192 and 256 (and the d padded
    to them), the CUDA-core wide bodies for float32 and d 320, and the
    narrow bodies up to 128 (bfloat16 fused K2b on the tensor cores)."""
    assert TF.kernel_body(kind, getattr(torch, dtype), d) == kernel


@pytest.mark.parametrize("dtype,d,kind,kernel", BODY_ROUTES)
def test_wrappers_ask_for_the_wide_tensor_cores_where_kernel_body_names_them(
        dtype, d, kind, kernel):
    """The route the wrappers pass to the C entry points
    (``wide_tensor_cores`` at the padded width) is the one
    ``kernel_body`` names, fused K2b's wide tensor-core body included."""
    wide = TF.wide_tensor_cores(getattr(torch, dtype),
                                TF.kernel_dim_head(d))
    assert wide == kernel.endswith("_wide_wgmma_kernel")


def test_kernel_body_names_kernels_of_the_source():
    """Every kernel ``kernel_body`` names is a ``__global__`` function of
    ``csrc/flash_attention.cu``."""
    import pathlib
    import re
    src = (pathlib.Path(TF.__file__).parent.parent / "csrc" /
           "flash_attention.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                             r"\s*(\w+)\(", src))
    named = {TF.kernel_body(kind, dtype, d) for kind in TF.KINDS
             for dtype in (torch.float32, torch.bfloat16)
             for d in (16, 64, 128, 192, 256, 320)}
    assert named <= kernels, named - kernels
    # the fused mode's own tensor-core bodies, narrow and wide, and the
    # wide K2a's
    assert {"flash_bwd_fused_wgmma_kernel",
            "flash_bwd_fused_wide_wgmma_kernel",
            "flash_bwd_dq_wide_wgmma_kernel"} <= named
    assert TF.WIDE_WGMMA_DIM_HEADS == (192, 256)


def test_kernel_body_rejects_unknown_kinds_and_dtypes():
    with pytest.raises(ValueError, match="unknown kind"):
        TF.kernel_body("bwd", torch.bfloat16, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TF.kernel_body("fwd", torch.float16, 64)


@pytest.mark.parametrize("d", [64, 128])
def test_padding_helper_takes_no_copy_at_kernel_widths(d):
    q, k, v, do, mask = pad_inputs(d, torch.float32, True)
    seen = []

    def spy(*args, **kw):
        seen.extend(args)
        return args[0]

    assert TF.at_kernel_dim_head(spy, q, k, v, do, mask=mask) is q
    assert all(a is b for a, b in zip(seen, (q, k, v, do)))


@pytest.mark.parametrize("d", [0, 129, 192])
def test_padding_helper_names_the_limit_above_128(d):
    """Since the wide bodies there is no limit above 128: d 129 runs
    padded to 192 and d 192 as it is, both exact against the plain
    version at the real d; only a d below 1 is refused."""
    if d < 1:
        q = torch.zeros((1, 1, 8, d))
        with pytest.raises(ValueError, match="dim_head 0: the kernels take "
                                             "any dim_head of 1 or more"):
            TF.at_kernel_dim_head(TF.flash_attention_fwd_plain, q, q, q,
                                  scale=1.0, causal=True)
        return
    q, k, v, _, mask = pad_inputs(d, torch.float32, True, n=16)
    kw = dict(scale=d ** -0.5, causal=True, mask=mask)
    got = TF.at_kernel_dim_head(TF.flash_attention_fwd_plain, q, k, v, **kw)
    want = TF.flash_attention_fwd_plain(q, k, v, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **PAD_TOL)


WIDE_DIMS = (130, 192, 256, 320)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv", "dkv_fused"])
def test_wide_padding_is_exact(kind, d, dtype, causal, masked):
    """Above 128 the wrappers hand the wide bodies a multiple of 64: d 130
    runs zero-padded to 192 and sliced back, exact as below 128; 192,
    256 and 320 run as they are."""
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = pad_inputs(d, dtype, masked, n=24)
    got = plain_call(kind, q, k, v, do, mask, causal, pad=True)
    want = plain_call(kind, q, k, v, do, mask, causal, pad=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), **PAD_TOL)


@pytest.mark.parametrize("mask_kind", ["none", "pad"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [192, 256, 320])
def test_wide_plain_versions_match_jax_kernels(d, causal, mask_kind):
    """The plain K1, K2a and K2b (split and fused), the wide bodies'
    yardsticks on the card, against JAX's Pallas kernels in interpret
    mode at d 192, 256 and 320, which they take as they are: float32,
    rtol/atol 1e-5."""
    check_plain_against_jax_kernels(d, causal, mask_kind)


@pytest.mark.parametrize("mask_kind", ["none", "pad"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 48])
def test_padded_plain_versions_match_jax_kernels(d, causal, mask_kind):
    """Padded to the kernel width and sliced back, the plain K1, K2a and
    K2b (split and fused) against JAX's Pallas kernels at the real d in
    interpret mode: float32, rtol/atol 1e-5 (the module's tolerance)."""
    check_plain_against_jax_kernels(d, causal, mask_kind)


def check_plain_against_jax_kernels(d, causal, mask_kind):
    n, tile = 40, 16
    rs = np.random.RandomState(d)
    q, k, v, do = (rs.randn(2, 2, n, d).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind == "pad":
        mask = np.ones((2, n), bool)
        mask[0, :5] = False
        mask[1, n - 9:] = False
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask)
    out, (m, l) = JF._flash_fwd(jq, jk, jv, jm, scale, causal, tile, tile,
                                True)
    bwd = {fused: JF._pallas_attention_bwd(
        jq, jk, jv, jm, jdo, out, (m, l), scale=scale, causal=causal,
        block_q=tile, block_k=tile, interpret=True, fused=fused)
        for fused in (False, True)}
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.tensor(mask)
    kw = dict(scale=scale, causal=causal, mask=tm)
    t_out, t_m, t_l = TF.at_kernel_dim_head(TF.flash_attention_fwd_plain,
                                            tq, tk, tv, **kw)
    for g, w in ((t_out, out), (t_m, m), (t_l, l)):
        close(g, w)
    dstat = (tdo * t_out).sum(-1)
    args = (tq, tk, tv, tdo, t_m, t_l, dstat)
    dq = TF.at_kernel_dim_head(TF.flash_attention_bwd_dq_plain, *args, **kw)
    dk, dv, _ = TF.at_kernel_dim_head(TF.flash_attention_bwd_dkv_plain,
                                      *args, **kw)
    for g, w in zip((dq, dk, dv), bwd[False]):
        close(g, w)
    dk, dv, dq32 = TF.at_kernel_dim_head(TF.flash_attention_bwd_dkv_plain,
                                         *args, with_dq=True, **kw)
    for g, w in zip((dq32, dk, dv), bwd[True]):
        close(g, w)
