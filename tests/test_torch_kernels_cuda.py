"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no CUDA device
is visible (the kernels have no CPU mode); on the H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports no JAX, so it also runs where only the port's
dependencies are installed. Tolerances: float32 rtol/atol 1e-5 and
bfloat16 1e-2 on m, l and acc / l; the unnormalised acc to the same rtol
of its summands' magnitude (sum_j p_j |v_j|), because the kernel sums
up to 1279 signed terms in another order than the plain version.

The flash kernels (K1, K2a, K2b) against their plain versions: float32
(TF32 off in the plain versions) to rtol/atol 2e-4 — both sides
accumulate in f32, over up to 1,280 terms in another order, and the
fused dq adds its key-tile shares with atomics in an order that changes
from run to run; float32 K1 and K2b (split and fused) at d 64 and 128
run on the tensor cores as three TF32 products a product (a few f32
ulps; ``test_f32_tensor_core_bodies_hold_a_wide_dynamic_range`` holds
them where one TF32 product would fail), K2a on CUDA cores; bfloat16 to
rtol/atol 2e-2, one bf16 rounding of the output (2^-8 relative) on
either side plus the f32 differences (bfloat16 K1, K2a and K2b, split
and fused, run on the tensor cores, and both sides round p and ds to
bf16 before the second product of each pair; l to 1e-4 in both types),
the bfloat16 gradients dq, dk and dv with their atol tightened to 0.05 x
their RMS where that is below 2e-2 (``assert_grad_close``).

The block-sparse kernel K3 (bfloat16 on the tensor cores, float32 on
CUDA cores; both sides round p to the input dtype before the PV product)
against its plain version with the same tolerances as the flash kernels
(f32 2e-4, bf16 2e-2; l to 1e-4), over walks of one to twenty query
tiles and layouts whose windows straddle, nest in or span the tiles; its
gradients through both backward routes against autograd through
``sparse_attention_ref`` to 2e-4 in f32; K4's visible walk against its
plain version and against the prefix walk over the same fully masked
rows, with K4's tolerances. The prefix walk is split across blocks
(flash-decoding); its splits are held against the plain version with
K4's tolerances, and its FILL corner cases exactly. bfloat16 and int8
pages at 128 < dh <= 256 run the wide split body on both walks, float32
pages there and dh 320 the CUDA-core wide body; each call's kernel is
named by the profiler.
"""

import re

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import block_sparse as BS
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import flash_attention as FA
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.ops import sparse as SP

SCALE = 512 ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check_partials(got, want, mag, rtol, atol):
    acc, m, l = (x.double().cpu() for x in got)
    acc_w, m_w, l_w = (x.double().cpu() for x in want)
    assert bool(((acc - acc_w).abs() <= rtol * mag.double().cpu()
                 + atol).all())
    torch.testing.assert_close(m, m_w, rtol=rtol, atol=atol)
    torch.testing.assert_close(l, l_w, rtol=rtol, atol=atol)
    live = l_w > 0
    torch.testing.assert_close(acc[live] / l[live][:, None],
                               acc_w[live] / l_w[live][:, None],
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dh", [16, 17, 24, 32, 48, 64, 128, 192, 256])
def test_kernel_matches_plain(cuda, page_size, dtype, dh):
    """dh 16, 32, 64 and 128 run their own bodies; 17, 24 and 48 the
    bodies of 32 and 64 with the real dh at run time (rows at stride dh;
    int8 at dh 17 stages its rows by 8-byte copies); 192 and 256 the
    wide body (two slices of acc columns a head, a walk of five
    splits)."""
    rs = np.random.RandomState(dh + page_size)
    slots, heads, L = 5, 3, 1280
    mp = L // page_size
    P = slots * mp + 1
    pos = torch.tensor([0, 1, 17, 1279, 640], dtype=torch.int32)
    bt = torch.tensor(rs.permutation(P - 1) + 1).reshape(slots, mp)
    need = (pos.long() + page_size - 1) // page_size
    bt = torch.where(torch.arange(mp)[None] < need[:, None], bt, 0) \
        .to(torch.int32)
    allowed = torch.arange(L)[None] < pos[:, None]
    allowed[3, 5] = False
    allowed[4, :page_size] = False
    q = torch.tensor(rs.randn(slots, heads, dh), dtype=torch.float32)
    shape = (P, heads, page_size, dh)
    kw = {}
    if dtype == "int8":
        kp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        vp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        kw = {"k_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32),
              "v_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32)}
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, dtype)
        q = q.to(dt)
        kp = torch.tensor(rs.randn(*shape), dtype=torch.float32).to(dt)
        vp = torch.tensor(rs.randn(*shape), dtype=torch.float32).to(dt)
    args = [t.to(cuda) for t in (q, kp, vp, bt, pos, allowed)]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    before = PA.paged_decode_attention.launches
    got = PA.paged_decode_attention(*args, scale=SCALE, **kw)
    assert PA.paged_decode_attention.launches == before + 1
    want = PA.paged_decode_attention_plain(*args, scale=SCALE, **kw)
    mag = PA.paged_decode_attention_plain(args[0], args[1], args[2].abs(),
                                          *args[3:], scale=SCALE, **kw)[0]
    torch.cuda.synchronize()
    rtol = 1e-2 if dtype == "bfloat16" else 1e-5
    atol = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-4}[dtype]
    check_partials(got, want, mag, rtol, atol)
    assert float(got[1][0, 0]) == PA.FILL
    assert float(got[2][0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_prefix_walk_across_split_boundaries(cuda, page_size, dtype):
    """The prefix walk split across blocks (SPLIT_ROWS rows each): one
    long slot beside short ones, walks that end on a split boundary and
    one row past it, a slot at pos 0, an all-masked walk over several
    splits (weight 1 per row: l is the walked row count exactly) and a
    masked prefix of two and a half splits wiped by the live rows after
    it. A second launch gives the same bits: the split counters were
    left zero."""
    split_walk_case(cuda, page_size, dtype, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [192, 320])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_wide_prefix_walk_across_split_boundaries(cuda, page_size, dtype,
                                                  dh):
    """The same walks through the wide bodies (dh > 128): float32 and dh
    320 on the CUDA-core body, whose splits merge per slice of acc
    columns, each slice with its own counter; bfloat16 and int8 at dh 192
    on the wide split body, whose splits are WIDE_SPLIT_ROWS rows."""
    split_walk_case(cuda, page_size, dtype, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("visible", [False, True])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("dh", [129, 160, 192, 200, 256])
def test_wide_split_body_across_split_boundaries(cuda, dh, dtype, page_size,
                                                 visible):
    """bfloat16 and int8 pages at 128 < dh <= 256 on the wide split body
    (the narrow body compiled for dh 256; below 256 rows at stride dh,
    int8 at dh 129 by 8-byte copies), on both walks (the visible walk
    over a list of every walked page): 20 splits of WIDE_SPLIT_ROWS rows
    at pos 1279, walks ending on a split boundary and one row past it,
    pos 0's (0, FILL, 0), an all-masked walk's weight 1 per row, a masked
    prefix wiped, the same bits from a second launch, and the kernel the
    profiler saw the one ``kernel_body`` names."""
    split_walk_case(cuda, page_size, dtype, dh, visible=visible)


def profiled_bodies(call, pattern: str, attempts: int = 3) -> set:
    """The kernels matching ``pattern`` that a torch.profiler trace of
    twelve calls names. A session may drop the records of its first
    milliseconds, which can hold every launch of a kernel this short:
    one that records none is tried again, up to ``attempts``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(12):
                call()
            torch.cuda.synchronize()
        names = {name for e in prof.key_averages()
                 for name in re.findall(pattern, e.key)}
        if names:
            return names
    return set()


def k4_bodies(call, attempts: int = 3) -> set:
    """The K4 kernels a profiled run of ``call`` names."""
    return profiled_bodies(call, r"(paged_decode\w*?_kernel)<", attempts)


def split_walk_case(cuda, page_size, dtype, dh, visible=False):
    rs = np.random.RandomState(page_size)
    heads, L = 4, 1280
    mp = L // page_size
    pos = torch.tensor([1279, 0, 1, 256, 257, 700, 900, 16, 300],
                       dtype=torch.int32)
    slots = len(pos)
    P = slots * mp + 1
    bt = torch.tensor(rs.permutation(P - 1) + 1).reshape(slots, mp)
    need = (pos.long() + page_size - 1) // page_size
    bt = torch.where(torch.arange(mp)[None] < need[:, None], bt, 0) \
        .to(torch.int32)
    allowed = torch.arange(L)[None] < pos[:, None]
    allowed[5] = False                             # every walked row masked
    allowed[6, :640] = False                       # a masked prefix
    allowed[0, 255:258] = False                    # pads across a boundary
    q = torch.tensor(rs.randn(slots, heads, dh), dtype=torch.float32)
    shape = (P, heads, page_size, dh)
    kw = {}
    if dtype == "int8":
        kp, vp = (torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
                  for _ in range(2))
        kw = {n: torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                              dtype=torch.float32)
              for n in ("k_scales", "v_scales")}
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, dtype)
        q = q.to(dt)
        kp, vp = (torch.tensor(rs.randn(*shape), dtype=torch.float32).to(dt)
                  for _ in range(2))
    args = [t.to(cuda) for t in (q, kp, vp, bt, pos, allowed)]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    wide = PA.wide_split(kp.dtype, dh)
    assert -(-mp // PA.pages_per_split(page_size, wide)) \
        == (20 if wide else 5)
    if visible:                        # every walked page, listed
        kw.update(visible=torch.arange(mp, dtype=torch.int32, device=cuda)
                  .expand(slots, mp).contiguous(),
                  visible_cnt=((pos.long() + page_size - 1) // page_size)
                  .to(torch.int32).to(cuda))
    got = PA.paged_decode_attention(*args, scale=SCALE, **kw)
    again = PA.paged_decode_attention(*args, scale=SCALE, **kw)
    want = PA.paged_decode_attention_plain(*args, scale=SCALE, **kw)
    assert k4_bodies(lambda: PA.paged_decode_attention(
        *args, scale=SCALE, **kw)) == {PA.kernel_body(kp.dtype, dh, visible)}
    mag = PA.paged_decode_attention_plain(args[0], args[1], args[2].abs(),
                                          *args[3:], scale=SCALE, **kw)[0]
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    rtol = 1e-2 if dtype == "bfloat16" else 1e-5
    atol = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-4}[dtype]
    check_partials(got, want, mag, rtol, atol)
    acc, m, l = (x.cpu() for x in got)
    assert float(m[1].max()) == PA.FILL == float(m[1].min())
    assert float(l[1].abs().max()) == 0.0 == float(acc[1].abs().max())
    walked = float(-(-700 // page_size) * page_size)
    assert float(m[5].max()) == PA.FILL and torch.equal(
        l[5], torch.full_like(l[5], walked))
    assert float(m[6].min()) > PA.FILL


@pytest.mark.cuda
@pytest.mark.parametrize("visible", [False, True])
@pytest.mark.parametrize("dtype,dh", [("float32", 192), ("float32", 256),
                                      ("bfloat16", 320), ("int8", 320),
                                      ("bfloat16", 64), ("int8", 128),
                                      ("bfloat16", 160), ("int8", 256)])
def test_k4_calls_launch_the_kernel_body_names(cuda, dtype, dh, visible):
    """Each call launches the kernel ``kernel_body`` names: float32 pages
    above dh 128 and any page type at dh 320 still the CUDA-core wide
    body, bf16 and int8 pages up to 256 the wide split body, dh up to
    128 the narrow walks."""
    rs = np.random.RandomState(dh)
    slots, heads, ps, L = 3, 2, 16, 320
    mp = L // ps
    pos = torch.tensor([0, 77, 319], dtype=torch.int32, device=cuda)
    bt = torch.arange(1, slots * mp + 1, dtype=torch.int32,
                      device=cuda).reshape(slots, mp)
    allowed = torch.ones((slots, L), dtype=torch.bool, device=cuda)
    shape = (slots * mp + 1, heads, ps, dh)
    kw = {}
    if dtype == "int8":
        kp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8,
                          device=cuda)
        kw = {n: torch.full(shape[:-1], 0.05, device=cuda)
              for n in ("k_scales", "v_scales")}
        q = torch.randn((slots, heads, dh), device=cuda).to(torch.bfloat16)
    else:
        kp = torch.randn(shape, device=cuda).to(getattr(torch, dtype))
        q = torch.randn((slots, heads, dh), device=cuda).to(kp.dtype)
    if visible:
        kw.update(visible=torch.arange(mp, dtype=torch.int32, device=cuda)
                  .expand(slots, mp).contiguous(),
                  visible_cnt=(pos + ps - 1) // ps)
    call = lambda: PA.paged_decode_attention(   # noqa: E731
        q, kp, kp, bt, pos, allowed, scale=dh ** -0.5, **kw)
    assert k4_bodies(call) == {PA.kernel_body(kp.dtype, dh, visible)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [("float32", 192), ("bfloat16", 320),
                                      ("bfloat16", 128)])
def test_k4_entry_refuses_the_wide_split_body_where_it_has_none(
        cuda, dtype, dh, monkeypatch):
    """The C entry launches the wide split body only for bf16 and int8
    pages at 128 < dh <= 256: asked for it anywhere else it refuses, and
    the wrapper raises (nothing falls back)."""
    monkeypatch.setattr(PA, "wide_split", lambda kv_dtype, d: True)
    dt = getattr(torch, dtype)
    q = torch.zeros((1, 1, dh), device=cuda, dtype=dt)
    pages = torch.zeros((2, 1, 8, dh), device=cuda, dtype=dt)
    bt = torch.ones((1, 3), dtype=torch.int32, device=cuda)
    pos = torch.full((1,), 5, dtype=torch.int32, device=cuda)
    allowed = torch.ones((1, 24), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        PA.paged_decode_attention(q, pages, pages, bt, pos, allowed,
                                  scale=1.0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    """dh 192 runs (the wide body; a slot at pos 0 returns (0, FILL, 0));
    another dtype is refused."""
    q = torch.zeros((1, 1, 192), device=cuda)
    pages = torch.zeros((2, 1, 8, 192), device=cuda)
    bt = torch.zeros((1, 3), dtype=torch.int32, device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    allowed = torch.zeros((1, 24), dtype=torch.bool, device=cuda)
    acc, m, l = PA.paged_decode_attention(q, pages, pages, bt, pos, allowed,
                                          scale=1.0)
    torch.cuda.synchronize()
    assert acc.shape == (1, 1, 192) and float(acc.abs().max()) == 0.0
    assert float(m[0, 0]) == PA.FILL and float(l[0, 0]) == 0.0
    with pytest.raises(ValueError, match="dtypes"):
        PA.paged_decode_attention(q[..., :32].half(),
                                  pages[..., :32].half(),
                                  pages[..., :32].half(), bt, pos, allowed,
                                  scale=1.0)


@pytest.mark.cuda
def test_decode_step_kernel_matches_gather_oracle(cuda):
    vcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    model = TD.dalle_init(cfg, seed=0, device=cuda)
    L, ps = cfg.seq_len, 8
    mp = L // ps
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, 2 * mp + 1, 2, ps, 16)
    pool = {"k": torch.randn(shape, generator=g, device=cuda),
            "v": torch.randn(shape, generator=g, device=cuda)}
    bt = (torch.arange(2 * mp, device=cuda) + 1).reshape(2, mp) \
        .to(torch.int32)
    pos = torch.tensor([L - 1, 9], dtype=torch.int32, device=cuda)
    x = torch.randn((2, 32), generator=g, device=cuda)
    key_mask = torch.ones((2, L), dtype=torch.bool, device=cuda)
    with torch.no_grad():
        hk, _, _ = TDEC._decode_step_math(model.transformer, x, pos, pool,
                                          cfg=cfg.transformer,
                                          key_mask=key_mask, block_tables=bt)
        hg, _, _ = TDEC._decode_step_math(
            model.transformer, x, pos, TDEC.paged_view(pool, bt, L),
            cfg=cfg.transformer, key_mask=key_mask, attn_impl="gather")
    torch.testing.assert_close(hk, hg, rtol=1e-4, atol=1e-4)


def spec_inputs(cuda, dtype, seed=3):
    """The speculative verify's K4 inputs at the serving shape (8 slots,
    8 heads, dh 64, page 16, L 1280): chunk starts from 0 to the last
    row, and the W = 4 per-offset row masks ``_chunk_masks`` gives a
    block-sparse layer (each offset its own layout row)."""
    rs = np.random.RandomState(seed)
    slots, heads, dh, ps, L, W = 8, 8, 64, 16, 1280, 4
    mp = L // ps
    P = slots * mp + 1
    bt = torch.tensor(rs.permutation(P - 1) + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 640, 1276, 1279],
                       dtype=torch.int32)
    vcfg = TV.VAEConfig(image_size=256, num_tokens=2048, codebook_dim=512,
                        num_layers=3, hidden_dim=64)
    cfg = TD.DALLEConfig(dim=512, depth=2, vae=vcfg, num_text_tokens=10000,
                         sparse_attn=(True, False), heads=heads,
                         dim_head=dh).transformer
    key_mask = torch.ones((slots, L), dtype=torch.bool)
    key_mask[3, :5] = False                    # a padded prompt
    dense_c, _, sparse_c, _ = TDEC._chunk_masks(cfg, pos, key_mask, W)
    shape = (P, heads, ps, dh)
    kw = {}
    if dtype == "int8":
        kp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        vp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        kw = {"k_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32).to(cuda),
              "v_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32).to(cuda)}
    else:
        kp = torch.tensor(rs.randn(*shape)).to(torch.bfloat16)
        vp = torch.tensor(rs.randn(*shape)).to(torch.bfloat16)
    q = torch.tensor(rs.randn(slots, heads, W, dh)).to(torch.bfloat16)
    return ([t.to(cuda) for t in (q, kp, vp, bt, pos)], kw,
            dense_c.to(cuda), sparse_c.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_k4_at_each_speculative_offsets_row_mask(cuda, dtype):
    """Every offset's walk of the verify (to the chunk-start pos, with
    that offset's row mask, sparse rows not all True below pos) against
    the plain version, with K4's tolerances."""
    (q, kp, vp, bt, pos), kw, dense_c, sparse_c = spec_inputs(cuda, dtype)
    rtol, atol = (1e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-4)
    for masks in (dense_c, sparse_c):
        for i in range(q.shape[2]):
            args = (q[:, :, i].contiguous(), kp, vp, bt, pos, masks[:, i])
            before = PA.paged_decode_attention.launches
            got = PA.paged_decode_attention(*args, scale=SCALE, **kw)
            assert PA.paged_decode_attention.launches == before + 1
            want = PA.paged_decode_attention_plain(*args, scale=SCALE, **kw)
            mag = PA.paged_decode_attention_plain(
                args[0], kp, vp.abs(), bt, pos, masks[:, i], scale=SCALE,
                **kw)[0]
            torch.cuda.synchronize()
            check_partials(got, want, mag, rtol, atol)
            assert float(got[1][0].max()) == PA.FILL   # pos 0 walks none


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kernel_read_wide_matches_plain_and_gather_on_card(cuda, dtype):
    """The whole wide read through K4 (one walk per offset plus the
    intra-chunk merge) against the same read on CPU tensors (K4's plain
    version), to 1e-2; in bfloat16 also against the gather over
    ``paged_view``, to 2e-2 (the int8 gather applies its scales in the
    bfloat16 score dtype, the int8 pool's accuracy contract, so it is
    held to the plain version only)."""
    (q, kp, vp, bt, pos), kw, _, sparse_c = spec_inputs(cuda, dtype, seed=4)
    W = q.shape[2]
    g = torch.Generator(device=cuda).manual_seed(5)
    k = torch.randn(q.shape, generator=g, device=cuda).to(q.dtype)
    v = torch.randn(q.shape, generator=g, device=cuda).to(q.dtype)
    intra = torch.ones((q.shape[0], W, W), dtype=torch.bool,
                       device=cuda).tril()
    args = (q, k, v, kp, vp, bt, pos, sparse_c, intra)
    with torch.no_grad():
        got = TDEC._kernel_read_wide(*args, scale=SCALE,
                                     ksc=kw.get("k_scales"),
                                     vsc=kw.get("v_scales"))
        plain = TDEC._kernel_read_wide(
            *(t.cpu() for t in args), scale=SCALE,
            **{n: t.cpu() for n, t in (("ksc", kw.get("k_scales")),
                                       ("vsc", kw.get("v_scales")))
               if t is not None})
        torch.testing.assert_close(got.float().cpu(), plain.float(),
                                   rtol=1e-2, atol=1e-2)
        if dtype == "bfloat16":
            view = TDEC.paged_view({"k": kp[None], "v": vp[None]}, bt,
                                   sparse_c.shape[2])
            want = TDEC._gather_read_wide(q, k, v, view["k"][0],
                                          view["v"][0], sparse_c, intra,
                                          scale=SCALE)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)


# -- flash attention: K1, K2a, K2b ------------------------------------------

def flash_inputs(cuda, dtype, n, d, masked, seed=0, b=2, h=3):
    rs = np.random.RandomState(seed + n + d)
    q, k, v, do = (torch.tensor(rs.randn(b, h, n, d), dtype=torch.float32)
                   .to(cuda).to(dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.ones((b, n), dtype=torch.bool)
        mask[0, :min(5, n)] = False            # fully padded query rows
        mask[-1, n // 2:] = False              # a padded tail
        mask = mask.to(cuda)
    return q, k, v, do, mask


def flash_tols(dtype):
    return (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 2e-2)


def assert_flash_close(got, want, dtype):
    rtol, atol = flash_tols(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def assert_grad_close(got, want, dtype):
    """A gradient (dq, dk, dv) as ``chip_smoke.py`` holds it: in bfloat16
    the atol is tightened to 0.05 x its RMS where that is below 2e-2,
    since a typical |dq| of a long walk's late rows is below 2e-2
    itself."""
    rtol, atol = flash_tols(dtype)
    if dtype == torch.bfloat16:
        atol = min(atol, 0.05 * float(want.float().square().mean().sqrt()))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# head dims: 64 and 128 are the narrow bodies' own widths, the others run
# zero-padded to the next of them (at_kernel_dim_head); above 128 the wide
# bodies take multiples of 64 (160 runs padded to 192)
DIM_HEADS = [16, 32, 48, 64, 96, 128]
WIDE_DIM_HEADS = [160, 192, 256, 320]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [37, 64, 200])
@pytest.mark.parametrize("d", DIM_HEADS + WIDE_DIM_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain(cuda, dtype, d, n, masked, causal):
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = flash_inputs(cuda, dtype, n, d, masked)
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    before = (FA.flash_attention_fwd.launches,
              FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(m, m_p, rtol=flash_tols(dtype)[0],
                               atol=flash_tols(dtype)[1])
    if masked and causal:
        # a fully padded row's max is the finite fill, its l the count of
        # its causal prefix (uniform over the prefix)
        fill32 = torch.tensor(FA.FILL, dtype=torch.float32).item()
        assert float(m[0, 0, 3]) == fill32 and float(l[0, 0, 3]) == 4.0
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    dk, dv, none = FA.flash_attention_bwd_dkv(*args, **kw)
    dk_f, dv_f, dq_f = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
    dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
    dk_p, dv_p, dq32_p = FA.flash_attention_bwd_dkv_plain(
        *args, with_dq=True, **kw)
    torch.cuda.synchronize()
    assert none is None and dq_f.dtype == torch.float32
    assert (FA.flash_attention_fwd.launches,
            FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 2)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p), (dk_f, dk_p),
                      (dv_f, dv_p), (dq_f, dq32_p)):
        assert_grad_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [37, 1000, 1280])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_and_split_dkv_match_plain_over_long_walks(
        cuda, dtype, d, n, masked, causal):
    """K1 and K2b split, whose bfloat16 bodies run on the tensor cores
    (float32 too at d 64 and 128, three TF32 products a product; d 192
    and 256 the wide bodies), over walks of
    one tile (n 37), of 16 tiles with a ragged last one (n 1000) and of
    20 full tiles (n 1280, the north length): every stage of the key and
    query rings, and the whole causal walk."""
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = flash_inputs(cuda, dtype, n, d, masked, b=1, h=2)
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    rtol, atol = flash_tols(dtype)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    dk_p, dv_p, _ = FA.flash_attention_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(m, m_p, rtol=rtol, atol=atol)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)
    if masked and causal:
        fill32 = torch.tensor(FA.FILL, dtype=torch.float32).item()
        assert float(m[0, 0, 3]) == fill32 and float(l[0, 0, 3]) == 4.0
    assert_grad_close(dk, dk_p, dtype)
    assert_grad_close(dv, dv_p, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [300, 1280])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 160, 192, 256, 320])
def test_bf16_fused_dkv_matches_plain_over_long_walks(cuda, d, n, masked,
                                                      causal):
    """Fused K2b in bfloat16 (dq, dk, dv in one pass): the tensor-core
    bodies at d 64 and 128 (16 and 96 padded to them) and at d 192 and
    256 (160 padded to 192), and the CUDA-core wide body at d 320, over
    a ragged walk of five tiles (n 300) and the north length (n 1280,
    twenty tiles: every stage of the query ring, and dq's shares from
    every key tile), each call launching the kernel ``kernel_body``
    names."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do, mask = flash_inputs(cuda, torch.bfloat16, n, d, masked,
                                     b=1, h=2)
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    out, m, l = FA.flash_attention_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, m, l, (do.float() * out.float()).sum(-1))
    dk_p, dv_p, dq_p = FA.flash_attention_bwd_dkv_plain(*args, with_dq=True,
                                                        **kw)
    before = FA.flash_attention_bwd_dkv.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dk, dv, dq = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
        torch.cuda.synchronize()
    assert FA.flash_attention_bwd_dkv.launches == before + 1
    ran = {name for e in prof.key_averages()
           for name in re.findall(r"(flash_\w+?_kernel)<", e.key)}
    assert ran <= {FA.kernel_body("fused", torch.bfloat16, d)}, ran
    assert dq.dtype == torch.float32 and bool(torch.isfinite(dq).all())
    for got, want in ((dk, dk_p), (dv, dv_p), (dq, dq_p)):
        assert_grad_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [300, 1280])
@pytest.mark.parametrize("d", [16, 64, 96, 128])
def test_f32_fused_dkv_matches_plain_over_long_walks(cuda, d, n, masked,
                                                     causal):
    """Fused K2b in float32 on its TF32 tensor-core body at d 64 and 128
    (16 and 96 padded to them) over a ragged walk (n 300) and the north
    length (n 1280: forty 32-row query tiles, and dq's shares from every
    key block), each call launching the kernel ``kernel_body`` names."""
    q, k, v, do, mask = flash_inputs(cuda, torch.float32, n, d, masked,
                                     b=1, h=2)
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    out, m, l = FA.flash_attention_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, m, l, (do.float() * out.float()).sum(-1))
    dk_p, dv_p, dq_p = FA.flash_attention_bwd_dkv_plain(*args, with_dq=True,
                                                        **kw)
    call = lambda: FA.flash_attention_bwd_dkv(  # noqa: E731
        *args, with_dq=True, **kw)
    before = FA.flash_attention_bwd_dkv.launches
    dk, dv, dq = call()
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd_dkv.launches == before + 1
    assert profiled_bodies(call, r"(flash_\w+?_kernel)<") == {
        FA.kernel_body("fused", torch.float32, d)}
    for got, want in ((dk, dk_p), (dv, dv_p), (dq, dq_p)):
        assert_grad_close(got, want, torch.float32)


def f64_attention(q, k, v, do, mask, scale, causal):
    """out, dq, dk and dv in float64 under the kernels' masking contract:
    the yardstick that says whether float32 itself resolves a case."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    n = q.shape[2]
    s = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    live = None
    if mask is not None:
        live = (mask[:, :, None] & mask[:, None, :])[:, None]
        s = torch.where(live, s, FA.FILL)
    if causal:
        future = torch.ones((n, n), dtype=torch.bool,
                            device=q.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    m = torch.clamp(s.amax(-1), min=FA.FILL)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    l = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhij,bhjd->bhid", p, v) / l[..., None]
    p = p / l[..., None]
    dp = torch.einsum("bhid,bhjd->bhij", do, v)
    ds = p * (dp - (do * out).sum(-1)[..., None]) * scale
    if live is not None:
        ds = torch.where(live, ds, 0.0)
    return {"out": out, "dq": torch.einsum("bhij,bhjd->bhid", ds, k),
            "dk": torch.einsum("bhij,bhid->bhjd", ds, q),
            "dv": torch.einsum("bhij,bhid->bhjd", p, do)}


# the wide-range cases of the float32 TF32 bodies, and the outputs each
# holds: "peaked_v_mix" (q scaled by 30, a peaked softmax, and v's
# entries of order 1e4 beside 1e-3, positive so that out, a weighted
# average, does not cancel) holds out, m, l and dv; its dq and dk run
# through dP - D, two values of order 1e4 that cancel under the peaked
# softmax, where float32 itself is off by more than 2e-4 (the plain f32
# version against float64: thousands of elements), so "q_mix" (q's
# entries of order 10 beside 1e-3, v as drawn; at 30 beside 1e-3 the
# plain f32 dk misses float64 on one element at d 128) holds every output
WIDE_RANGE_CASES = {"peaked_v_mix": ("out", "dv"),
                    "q_mix": ("out", "dq", "dk", "dv")}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(WIDE_RANGE_CASES))
def test_f32_tensor_core_bodies_hold_a_wide_dynamic_range(cuda, case, d,
                                                          masked, causal):
    """float32 K1 and K2b (split and fused) on their TF32 bodies where a
    hi/lo split goes wrong: operands whose entries span seven orders of
    magnitude (``WIDE_RANGE_CASES``). One TF32 product (2^-11 relative)
    puts tens of thousands of these outputs past the f32 tolerance of
    2e-4 (tests/test_torch_tf32x3.py emulates it); three hold them
    against the plain versions at 2e-4 unchanged. Each held output is
    first checked to be one float32 resolves: the plain version holds a
    float64 reference at the same tolerance."""
    q, k, v, do, mask = flash_inputs(cuda, torch.float32, 300, d, masked,
                                     b=1, h=2)
    rs = np.random.RandomState(d + 7)
    big = torch.tensor(rs.rand(*v.shape) < 0.5, device=cuda)
    if case == "peaked_v_mix":
        q = q * 30
        v = torch.where(big, v.abs() * 1e4, v.abs() * 1e-3).contiguous()
    else:
        q = torch.where(big, q * 10, q * 1e-3).contiguous()
    held = WIDE_RANGE_CASES[case]
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    dk_f, dv_f, dq_f = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
    dk_p, dv_p, dq_p = FA.flash_attention_bwd_dkv_plain(*args, with_dq=True,
                                                        **kw)
    torch.cuda.synchronize()
    plain = {"out": out_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    exact = f64_attention(q, k, v, do, mask, d ** -0.5, causal)
    for name in held:                 # float32 resolves what is held
        assert_flash_close(plain[name], exact[name], torch.float32)
    if case == "peaked_v_mix":
        assert float(out_p.abs().max()) > 1e3
    assert_flash_close(out, out_p, torch.float32)
    assert_flash_close(m, m_p, torch.float32)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)
    got = {"dk": (dk, dk_f), "dv": (dv, dv_f), "dq": (dq_f,)}
    for name in held[1:]:
        for x in got[name]:
            assert_grad_close(x, plain[name], torch.float32)
    for kind, call in (
            ("fwd", lambda: FA.flash_attention_fwd(q, k, v, **kw)),
            ("dkv", lambda: FA.flash_attention_bwd_dkv(*args, **kw)),
            ("fused", lambda: FA.flash_attention_bwd_dkv(
                *args, with_dq=True, **kw))):
        assert profiled_bodies(call, r"(flash_\w+?_kernel)<") == {
            FA.kernel_body(kind, torch.float32, d)}, kind


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["fwd", "dkv", "fused"])
def test_f32_tensor_core_calls_raise_rather_than_run_another_body(
        cuda, monkeypatch, kind, d):
    """No fallback: a float32 K1 or K2b call that its C entry refuses
    (here the wrappers are made to ask for a wide tensor-core route,
    which no float32 body has) raises and counts no launch, rather than
    returning a result from the CUDA-core bodies or the plain version."""
    q, k, v, do, mask = flash_inputs(cuda, torch.float32, 64, d, True)
    kw = dict(scale=d ** -0.5, causal=True, mask=mask)
    out, m, l = FA.flash_attention_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, m, l, (do.float() * out.float()).sum(-1))
    call, fn = {
        "fwd": (lambda: FA.flash_attention_fwd(q, k, v, **kw),
                FA.flash_attention_fwd),
        "dkv": (lambda: FA.flash_attention_bwd_dkv(*args, **kw),
                FA.flash_attention_bwd_dkv),
        "fused": (lambda: FA.flash_attention_bwd_dkv(*args, with_dq=True,
                                                     **kw),
                  FA.flash_attention_bwd_dkv)}[kind]
    monkeypatch.setattr(FA, "wide_tensor_cores", lambda dtype, d: True)
    before = fn.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        call()
    torch.cuda.synchronize()
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bwd_impl", ["pallas", "pallas_fused"])
def test_flash_attention_grads_match_blockwise_on_card(cuda, bwd_impl):
    q, k, v, do, mask = flash_inputs(cuda, torch.float32, 150, 64, True)
    grads = {}
    for impl in ("xla", bwd_impl):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = FA.flash_attention(*leaves, scale=0.125, causal=True,
                                 mask=mask, bwd_impl=impl)
        (out * do).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for got, want in zip(grads[bwd_impl], grads["xla"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 160, 192, 256, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_calls_launch_the_kernel_body_names(cuda, dtype, d):
    """Each wrapper launches the kernel ``kernel_body`` names, by its
    name in a torch.profiler trace: bfloat16 K1, K2a and K2b (split and
    fused) at d 160 (padded to 192), 192 and 256 the wide tensor-core
    bodies, bfloat16 at d 64 and 128 the narrow ones (fused K2b's own),
    float32 K1 and K2b (split and fused) at d 64 and 128 their TF32
    tensor-core bodies, float32 K2a, float32 above 128 and d 320 the
    CUDA-core ones."""
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = flash_inputs(cuda, dtype, 130, d, True)
    kw = dict(scale=d ** -0.5, causal=True, mask=mask)
    out, m, l = FA.flash_attention_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, m, l, (do.float() * out.float()).sum(-1))
    calls = {"fwd": lambda: FA.flash_attention_fwd(q, k, v, **kw),
             "dq": lambda: FA.flash_attention_bwd_dq(*args, **kw),
             "dkv": lambda: FA.flash_attention_bwd_dkv(*args, **kw),
             "fused": lambda: FA.flash_attention_bwd_dkv(*args, with_dq=True,
                                                         **kw)}
    for kind, call in calls.items():
        ran = profiled_bodies(call, r"(flash_\w+?_kernel)<")
        assert ran == {FA.kernel_body(kind, dtype, d)}, (kind, ran)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    """d 192 runs (the wide body); float16 and a strided q are
    refused."""
    q = torch.zeros((1, 1, 16, 192), device=cuda)
    out, m, l = FA.flash_attention_fwd(q, q, q, scale=1.0, causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and float(out.abs().max()) == 0.0
    assert torch.equal(l[0, 0].cpu(), torch.arange(1.0, 17.0))
    h = torch.zeros((1, 1, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        FA.flash_attention_fwd(h, h, h, scale=1.0, causal=True)
    t = torch.zeros((1, 1, 64, 16), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_fwd(t, t, t, scale=1.0, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,kind", [("float32", 256, "fwd"),
                                          ("bfloat16", 320, "fwd"),
                                          ("bfloat16", 128, "fwd"),
                                          ("float32", 192, "dkv"),
                                          ("bfloat16", 320, "dkv"),
                                          ("float32", 256, "fused"),
                                          ("bfloat16", 320, "fused"),
                                          ("bfloat16", 320, "dq"),
                                          ("float32", 256, "dq")])
def test_flash_entries_refuse_a_wide_tensor_core_route_without_a_body(
        cuda, dtype, d, kind):
    """The C entry points run the wide tensor-core bodies only where they
    are compiled (bfloat16 K1, K2a and K2b, split and fused, at d 192 and
    256): asked for one anywhere else, they launch nothing and return an
    error rather than run another body."""
    dtype = getattr(torch, dtype)
    b, h, n = 1, 1, 64
    q = torch.zeros((b, h, n, d), device=cuda, dtype=dtype)
    stat = torch.ones((b, h, n), device=cuda)
    st = stat.data_ptr()
    code = 0 if dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(cuda).cuda_stream
    p = q.data_ptr()
    if kind == "fwd":
        rc = FA._entry("flash_attention_fwd")(
            p, p, p, None, p, st, st, b, h, n, d, 1.0, 1, code, 1, stream)
    elif kind == "dq":
        rc = FA._entry("flash_attention_bwd_dq")(
            p, p, p, p, st, st, st, None, p, b, h, n, d, 1.0, 1, code, 1,
            stream)
    else:
        dq = torch.zeros((b, h, n, d), device=cuda) if kind == "fused" \
            else None
        rc = FA._entry("flash_attention_bwd_dkv")(
            p, p, p, p, st, st, st, None, p, p,
            None if dq is None else dq.data_ptr(), b, h, n, d, 1.0, 1, code,
            1, stream)
    torch.cuda.synchronize()
    assert rc != 0


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["none", "all_true", "pad"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [37, 64, 65, 200, 1280])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_bf16_dq_kernel_matches_plain(cuda, d, n, causal, mask_kind):
    """K2a's bfloat16 bodies on the tensor cores (d 64 and 128 the narrow
    one, d 192 and 256 the wide one) over walks of one tile (n 37, 64),
    one tile and one row (65), a ragged fourth tile (200) and the north
    length (1280, twenty tiles: every stage of the key ring); no mask,
    the all-True mask training builds, and text padding with fully
    padded query rows, as DALLE batches carry it."""
    q, k, v, do, _ = flash_inputs(cuda, torch.bfloat16, n, d, False, b=2,
                                  h=2)
    mask = None
    if mask_kind != "none":
        mask = torch.ones((2, n), dtype=torch.bool, device=cuda)
    if mask_kind == "pad":
        text = min(n, 40)
        mask[0, 1:text] = False        # caption of one token
        mask[1, text // 2:text] = False
    kw = dict(scale=d ** -0.5, causal=causal, mask=mask)
    out, m, l = FA.flash_attention_fwd_plain(q, k, v, **kw)
    dstat = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, m, l, dstat)
    before = FA.flash_attention_bwd_dq.launches
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    assert FA.flash_attention_bwd_dq.launches == before + 1
    dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and bool(torch.isfinite(dq).all())
    assert_grad_close(dq, dq_p, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dim_head", [16, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_dalle_train_step_on_card_matches_cpu(cuda, dtype, dim_head):
    """One training step of ``bench.py``'s tiny DALLE (a block-sparse
    layer then a dense one) on the card, through K1, K2a, K2b and K3 at
    dim_head 16 (the narrow bodies, padded) and 192 (the wide ones: in
    bfloat16 K1 and K2b split on the tensor cores), against the same step
    on the CPU (the kernels' plain versions), from the same weights and
    keys. float32 as the smoke holds the depth-2 step: loss rtol 1e-5,
    each gradient to 1e-4 of its largest element; bfloat16 to the flash
    kernels' 2e-2 of each."""
    import copy
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    dt = getattr(torch, dtype)
    vcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=dim_head,
                         sparse_attn=(True, False), attn_impl="flash",
                         attn_bwd_impl="pallas", sparse_impl="pallas")
    model = TD.dalle_init(cfg, seed=0, dtype=dt, device="cpu")
    enc = TV.vae_encoder_init(vcfg, seed=1, dtype=dt, device="cpu")
    rs = np.random.RandomState(3)
    mask = np.ones((4, 8), bool)
    mask[1, 5:] = False
    batch = {"text": torch.tensor(rs.randint(1, 64, (4, 8))),
             "mask": torch.tensor(mask),
             "image": torch.tensor(rs.uniform(-1, 1, (4, 16, 16, 3)),
                                   dtype=torch.float32)}
    got = {}
    for dev in ("cpu", cuda):
        m_ = copy.deepcopy(model).to(dev)
        e_ = copy.deepcopy(enc).to(dev)
        b_ = {k: v.to(dev) for k, v in batch.items()}
        launches = (FA.flash_attention_fwd.launches,
                    FA.flash_attention_bwd_dq.launches,
                    FA.flash_attention_bwd_dkv.launches,
                    BS.block_sparse_attention_fwd.launches)
        loss = dalle_loss_fn(e_)(m_, b_, prng.prng_key(5, device=dev))
        loss.backward()
        ran = tuple(a - b for a, b in zip(
            (FA.flash_attention_fwd.launches,
             FA.flash_attention_bwd_dq.launches,
             FA.flash_attention_bwd_dkv.launches,
             BS.block_sparse_attention_fwd.launches), launches))
        assert ran == ((0, 0, 0, 0) if dev == "cpu" else (1, 1, 1, 1))
        got[str(dev)] = (float(loss.detach()),
                         {n: p.grad.float().cpu()
                          for n, p in m_.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = got["cpu"], got[str(cuda)]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    grad_tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= rtol * abs(loss_c)
    for name, want in grads_c.items():
        largest = float(want.abs().max())
        err = float((grads_g[name] - want).abs().max())
        assert err <= grad_tol * max(largest, 1e-30), (name, err, largest)


def _card_against_cpu(cuda, make, loss_fn, batch, dtype, want_launches):
    """One loss and backward of ``make(dtype)`` on the CPU (the kernels'
    plain versions) and on the card (the kernels), from the same weights
    and keys: the card's launches of (K1, K2a, K2b, K3) equal
    ``want_launches``, the loss within rtol 1e-5 (float32) or 2e-2
    (bfloat16) and each gradient within 1e-4 or 2e-2 of its largest
    element, as ``test_tiny_dalle_train_step_on_card_matches_cpu``."""
    import copy
    from dalle_pytorch_tpu_torch.ops import prng
    dt = getattr(torch, dtype)
    model = make(dt)
    got = {}
    for dev in ("cpu", cuda):
        m_ = copy.deepcopy(model).to(dev)
        b_ = {k: v.to(dev) for k, v in batch.items()}
        if "images" in b_:
            b_["images"] = b_["images"].to(dt)
        counters = (FA.flash_attention_fwd, FA.flash_attention_bwd_dq,
                    FA.flash_attention_bwd_dkv, BS.block_sparse_attention_fwd)
        before = tuple(c.launches for c in counters)
        loss = loss_fn(m_, b_, prng.prng_key(5, device=dev))
        loss.backward()
        ran = tuple(c.launches - b for c, b in zip(counters, before))
        assert ran == ((0, 0, 0, 0) if dev == "cpu" else want_launches)
        got[str(dev)] = (float(loss.detach()),
                         {n: p.grad.float().cpu()
                          for n, p in m_.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = got["cpu"], got[str(cuda)]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    grad_tol = 1e-4 if dtype == "float32" else 2e-2
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= rtol * abs(loss_c)
    for name, want in grads_c.items():
        largest = float(want.abs().max())
        err = float((grads_g[name] - want).abs().max())
        assert err <= grad_tol * max(largest, 1e-30), (name, err, largest)


def _tiny_dalle(**kw):
    vcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16,
                         attn_impl="flash", attn_bwd_impl="pallas",
                         attn_dropout=0.1, ff_dropout=0.1, **kw)
    rs = np.random.RandomState(3)
    mask = np.ones((4, 8), bool)
    mask[1, 5:] = False
    batch = {"text": torch.tensor(rs.randint(1, 64, (4, 8))),
             "mask": torch.tensor(mask),
             "image": torch.tensor(rs.randint(0, 32, (4, 16)))}
    return cfg, batch


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_the_one_process_dp_step(cuda):
    """Two rank processes on the one card over gloo (each its own CUDA
    context): the tiny DALLE's dp step (flash attention, the split kernel
    backward, dropout 0.1 drawn as rows of the whole batch's masks) from
    the same seeded weights and key as this process's one-process step on
    the whole batch. float32: the loss to 1e-5 relative and each reduced
    gradient to 1e-4 of its largest element; each rank launched K1, K2a
    and K2b once a layer (depth 2), the one process the same."""
    import torch_parallel_ranks as R
    from dalle_pytorch_tpu_torch.parallel.launch import spawn
    loss, grads, ran = R.tiny_dp_grads({"dp": 1}, cuda)
    assert ran == (2, 2, 2)
    ranks = spawn(R.card_dp_case, 2, device=None, backend="gloo",
                  timeout_s=300)
    for r_loss, r_grads, r_ran in ranks:
        assert r_ran == (2, 2, 2)
        assert abs(r_loss - loss) <= 1e-5 * abs(loss)
        assert set(r_grads) == set(grads)
        for name, want in grads.items():
            largest = float(np.abs(want).max())
            err = float(np.abs(r_grads[name] - want).max())
            assert err <= 1e-4 * max(largest, 1e-30), (name, err, largest)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_at_a_tp_ranks_heads(cuda, dtype, masked):
    """K1, K2a and K2b (split) at the shapes a tensor-parallel rank of two
    gives them at the north width: its 4 of the 8 heads of 64 over the
    whole batch's 1,280 positions (b 2 here), against their plain
    versions, one launch each."""
    dtype = getattr(torch, dtype)
    q, k, v, do, mask = flash_inputs(cuda, dtype, 1280, 64, masked, b=2,
                                     h=4)
    kw = dict(scale=SCALE, causal=True, mask=mask)
    before = (FA.flash_attention_fwd.launches,
              FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    assert_flash_close(out, out_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
    dk_p, dv_p, _ = FA.flash_attention_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (FA.flash_attention_fwd.launches,
            FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert_grad_close(got, want, dtype)


@pytest.mark.cuda
def test_two_tp_ranks_on_the_card_match_the_one_process_step(cuda):
    """Two tensor-parallel rank processes on the one card over gloo: the
    tiny DALLE (4 heads; each rank 2) under ``dalle_param_specs(tp=)``,
    its step's gradients gathered whole, against this process's
    one-process step from the same seeded weights and key. float32: the
    loss to 1e-5 relative, each gradient to 1e-4 of its largest element;
    each rank launched K1, K2a and K2b once a layer (depth 2)."""
    import torch_parallel_ranks as R
    from dalle_pytorch_tpu_torch.parallel.launch import spawn
    loss, grads, ran = R.tiny_dp_grads({"dp": 1}, cuda, heads=4)
    assert ran == (2, 2, 2)
    ranks = spawn(R.card_tp_case, 2, device=None, backend="gloo",
                  timeout_s=300)
    for r_loss, r_grads, r_ran in ranks:
        assert r_ran == (2, 2, 2)
        assert abs(r_loss - loss) <= 1e-5 * abs(loss)
        assert set(r_grads) == set(grads)
        for name, want in grads.items():
            largest = float(np.abs(want).max())
            err = float(np.abs(r_grads[name] - want).max())
            assert err <= 1e-4 * max(largest, 1e-30), (name, err, largest)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reversible_dalle_step_on_card_matches_cpu(cuda, dtype):
    """The tiny reversible DALLE (depth 2, dropout 0.1): the backward
    inverts each layer and recomputes its attention, so K1 launches
    twice a layer and K2a and K2b once each; loss and gradients against
    the same step on the CPU."""
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg, batch = _tiny_dalle(reversible=True)
    _card_against_cpu(
        cuda, lambda dt: TD.dalle_init(cfg, seed=0, dtype=dt, device="cpu"),
        dalle_loss_fn(), batch, dtype, (4, 2, 2, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k1", [("full", 4), ("save_ln", 2),
                                     ("dots", 4)])
def test_remat_with_kernels_matches_none_on_card(cuda, mode, k1):
    """Each remat mode's loss and gradients with the kernels equal those
    of ``remat='none'`` with the kernels, on the card: the recompute of
    'full' and 'dots' relaunches K1 (the count says so), 'save_ln' keeps
    its outputs."""
    import copy
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg, batch = _tiny_dalle()
    model = TD.dalle_init(cfg, seed=0, device="cpu").to(cuda)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    got = {}
    for m in ("none", mode):
        m_ = copy.deepcopy(model)
        m_.cfg = TD.DALLEConfig(**{**{f: getattr(cfg, f) for f in
                                      cfg.__dataclass_fields__},
                                   "remat": m})
        before = FA.flash_attention_fwd.launches
        loss = dalle_loss_fn()(m_, batch, prng.prng_key(5, device=cuda))
        loss.backward()
        torch.cuda.synchronize()
        assert FA.flash_attention_fwd.launches - before == \
            (2 if m == "none" else k1)
        got[m] = (float(loss.detach()), {n: p.grad for n, p in
                                         m_.named_parameters()})
    assert got[mode][0] == got["none"][0]
    for name, g in got[mode][1].items():
        want = got["none"][1][name]
        largest = float(want.abs().max())
        assert float((g - want).abs().max()) <= 1e-4 * max(largest, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_train_step_through_noncausal_k3_matches_cpu(cuda, dtype):
    """A tiny CLIP with ``sparse_impl='pallas'`` (K3, causal=False, in
    each of its 1 + 1 layers; its plain blockwise backward) and padded
    captions: one InfoNCE loss and backward on the card against the CPU."""
    from dalle_pytorch_tpu_torch.models import clip as TC
    from dalle_pytorch_tpu_torch.parallel.train import clip_loss_fn
    cfg = TC.CLIPConfig(dim_text=64, dim_image=64, dim_latent=32,
                        num_text_tokens=64, text_enc_depth=1,
                        text_seq_len=40, text_heads=2, visual_enc_depth=1,
                        visual_heads=2, visual_image_size=32,
                        visual_patch_size=4, sparse_impl="pallas")
    rs = np.random.RandomState(4)
    mask = np.arange(40)[None] < np.array([[40], [17], [1], [33]])
    batch = {"text": torch.tensor(rs.randint(1, 64, (4, 40))),
             "mask": torch.tensor(mask),
             "images": torch.tensor(rs.uniform(-1, 1, (4, 32, 32, 3)),
                                    dtype=torch.float32)}
    _card_against_cpu(
        cuda, lambda dt: TC.clip_init(cfg, seed=0, dtype=dt, device="cpu"),
        clip_loss_fn(), batch, dtype, (0, 0, 0, 2))


# -- block-sparse attention: K3 ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,block", [(37, 16), (48, 16), (200, 16),
                                     (256, 16), (1000, 16), (1280, 16),
                                     (160, 8), (200, 8)])
@pytest.mark.parametrize("d", DIM_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_kernel_matches_plain(cuda, dtype, d, n, block, masked,
                                           causal):
    dtype = getattr(torch, dtype)
    q, k, v, _, mask = flash_inputs(cuda, dtype, n, d, masked)
    kw = dict(scale=d ** -0.5, causal=causal, block=block, mask=mask)
    before = BS.block_sparse_attention_fwd.launches
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    assert BS.block_sparse_attention_fwd.launches == before + 1
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(out, out_p, dtype)
    assert_flash_close(m, m_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [37, 200, 1280])
@pytest.mark.parametrize("d", WIDE_DIM_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_wide_kernel_matches_plain(cuda, dtype, d, n, masked,
                                                causal):
    """Heads wider than 128 through K3's wide bodies (160 padded to 192;
    bfloat16 at 192 and 256 on the tensor cores, the rest on CUDA cores),
    over one tile, a ragged walk and the north length (n 1280)."""
    dtype = getattr(torch, dtype)
    q, k, v, _, mask = flash_inputs(cuda, dtype, n, d, masked)
    kw = dict(scale=d ** -0.5, causal=causal, block=16, mask=mask)
    before = BS.block_sparse_attention_fwd.launches
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    assert BS.block_sparse_attention_fwd.launches == before + 1
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert_flash_close(out, out_p, dtype)
    assert_flash_close(m, m_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,masked", [(256, True), (64, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_noncausal_kernel_at_clip_shapes(cuda, dtype, n,
                                                      masked):
    """K3 with causal=False at the CLIP encoders' shapes: the text
    encoder's 256 tokens with a key-padding mask (captions of 1 to 256
    tokens), the visual encoder's 64 patches without one; d 64, 8
    heads."""
    dtype = getattr(torch, dtype)
    q, k, v, _, _ = flash_inputs(cuda, dtype, n, 64, False, b=8, h=8)
    mask = None
    if masked:
        lengths = torch.tensor([1, 17, 64, 100, 200, 255, 256, 30])
        mask = (torch.arange(n)[None] < lengths[:, None]).to(cuda)
    kw = dict(scale=512 ** -0.5, causal=False, block=16, mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(out, out_p, dtype)
    assert_flash_close(m, m_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,local,globals_", [
    (16, 3, (0,)), (16, 5, (0, 7)), (8, 4, (0, 9)), (32, 4, (1,)),
    (16, 4, (2, 3))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_kernel_other_layouts(cuda, dtype, block, local,
                                           globals_, causal):
    """Windows that straddle the 64-row tiles (48 and 80 tokens), windows
    that nest inside them (32), a window of two tiles (128) and global
    blocks off tile 0, with pad keys: every form of the per-tile layout
    decision (one window, global columns only, a window boundary cutting
    the pair) against the plain version."""
    dtype = getattr(torch, dtype)
    q, k, v, _, mask = flash_inputs(cuda, dtype, 300, 64, True)
    kw = dict(scale=0.125, causal=causal, block=block,
              num_local_blocks=local, global_blocks=globals_, mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(out, out_p, dtype)
    assert_flash_close(m, m_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block_qk", [(256, 128), (160, 128), (256, 96)])
def test_block_sparse_grads_match_autograd_of_ref(cuda, n, block_qk):
    """(256, 128) takes the static backward, the others the blockwise
    scan."""
    q, k, v, do, mask = flash_inputs(cuda, torch.float32, n, 64, True)
    mask = torch.ones_like(mask)
    mask[1, n - 20:] = False                   # pad keys at the tail
    grads = {}
    for impl in ("ref", "kernel"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if impl == "ref":
            out = SP.sparse_attention_ref(*leaves, scale=0.125, causal=True,
                                          block=16, mask=mask)
        else:
            out = BS.block_sparse_attention(*leaves, scale=0.125, causal=True,
                                            block=16, mask=mask,
                                            block_q=block_qk,
                                            block_k=block_qk)
        (out * do).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for got, want in zip(grads["kernel"], grads["ref"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,local,globals_", [
    (16, 3, (0,)), (16, 5, (0, 7)), (8, 4, (0, 9)), (32, 4, (1,)),
    (16, 4, (2, 3))])
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_wide_kernel_other_layouts(cuda, dtype, d, block,
                                                local, globals_, causal):
    """``test_block_sparse_kernel_other_layouts`` at d 192 and 256: every
    form of the per-tile layout decision on the wide bodies (bfloat16 on
    the tensor cores), with pad keys."""
    dtype = getattr(torch, dtype)
    q, k, v, _, mask = flash_inputs(cuda, dtype, 300, d, True)
    kw = dict(scale=d ** -0.5, causal=causal, block=block,
              num_local_blocks=local, global_blocks=globals_, mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_flash_close(out, out_p, dtype)
    assert_flash_close(m, m_p, dtype)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 160, 192, 256, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_calls_launch_the_kernel_body_names(cuda, dtype, d):
    """K3's wrapper launches the kernel ``BS.kernel_body`` names, by its
    name in a torch.profiler trace: bfloat16 at d 64 and 128 the narrow
    tensor-core body, at 160 (padded to 192), 192 and 256 the wide one,
    float32 and d 320 the CUDA-core ones."""
    dtype = getattr(torch, dtype)
    q, k, v, _, mask = flash_inputs(cuda, dtype, 130, d, True)
    kw = dict(scale=d ** -0.5, causal=True, block=16, mask=mask)
    ran = profiled_bodies(lambda: BS.block_sparse_attention_fwd(q, k, v,
                                                                **kw),
                          r"(block_sparse_\w+?_kernel)<")
    assert ran == {BS.kernel_body(dtype, d)}, ran


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 320), ("float32", 256),
                                     ("bfloat16", 128)])
def test_block_sparse_entry_refuses_a_wide_tensor_core_route_without_a_body(
        cuda, dtype, d):
    """K3's C entry point runs the wide tensor-core body only where it is
    compiled (bfloat16 at d 192 and 256): asked for it anywhere else, it
    launches nothing and returns an error rather than run another
    body."""
    import ctypes
    dtype = getattr(torch, dtype)
    b, h, n = 1, 1, 64
    q = torch.zeros((b, h, n, d), device=cuda, dtype=dtype)
    stat = torch.ones((b, h, n), device=cuda)
    p, st = q.data_ptr(), stat.data_ptr()
    code = 0 if dtype == torch.float32 else 1
    gbs = (ctypes.c_int * BS.MAX_GLOBAL_BLOCKS)(0)
    rc = BS._entry()(p, p, p, None, p, st, st, b, h, n, d, 1.0, 1, 16, 64,
                     gbs, 1, code, 1,
                     torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0


@pytest.mark.cuda
def test_block_sparse_kernel_rejects_what_it_does_not_take(cuda):
    """d 192 runs (the wide body); more than 8 global blocks are
    refused."""
    q = torch.zeros((1, 1, 16, 192), device=cuda)
    out, m, l = BS.block_sparse_attention_fwd(q, q, q, scale=1.0,
                                              causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and float(out.abs().max()) == 0.0
    assert torch.equal(l[0, 0].cpu(), torch.arange(1.0, 17.0))
    q = torch.zeros((1, 1, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="global blocks"):
        BS.block_sparse_attention_fwd(q, q, q, scale=1.0, causal=True,
                                      global_blocks=tuple(range(9)))


# -- K4's visible walk ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_visible_walk_matches_plain_and_prefix_walk(cuda, dtype):
    visible_walk_case(cuda, dtype, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [192, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wide_visible_walk_matches_plain_and_prefix_walk(cuda, dtype, dh):
    """A sparse layer's visible walk on the wide split body, and the
    prefix walk over the same fully masked rows."""
    visible_walk_case(cuda, dtype, dh)


def visible_walk_case(cuda, dtype, dh):
    rs = np.random.RandomState(5)
    page_size, heads, L = 16, 3, 1280
    mp = L // page_size
    pos = torch.tensor([0, 1, 15, 16, 17, 63, 64, 65, 1279],
                       dtype=torch.int32)
    slots = len(pos)
    P = slots * mp + 1
    bt = torch.tensor(rs.permutation(P - 1) + 1).reshape(slots, mp) \
        .to(torch.int32)
    vis, _, ccnt = SP.visible_pages_causal(L, page_size, 16)
    layout = torch.tensor(SP.token_layout_mask(L, 16))
    allowed = (torch.arange(L)[None] < pos[:, None]) & layout[pos.long()]
    allowed[4, 3] = False
    q = torch.tensor(rs.randn(slots, heads, dh), dtype=torch.float32)
    shape = (P, heads, page_size, dh)
    kw = {}
    if dtype == "int8":
        kp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        vp = torch.tensor(rs.randint(-127, 128, shape), dtype=torch.int8)
        kw = {"k_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32),
              "v_scales": torch.tensor(rs.uniform(0.01, 0.1, shape[:-1]),
                                       dtype=torch.float32)}
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, dtype)
        q = q.to(dt)
        kp = torch.tensor(rs.randn(*shape), dtype=torch.float32).to(dt)
        vp = torch.tensor(rs.randn(*shape), dtype=torch.float32).to(dt)
    args = [t.to(cuda) for t in (q, kp, vp, bt, pos, allowed)]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    walk = dict(visible=torch.tensor(vis[pos.numpy()]).to(cuda),
                visible_cnt=torch.tensor(ccnt[pos.numpy()]).to(cuda))
    before = (PA.paged_decode_attention.launches,
              PA.paged_decode_attention.visible_launches)
    got = PA.paged_decode_attention(*args, scale=SCALE, **kw, **walk)
    prefix = PA.paged_decode_attention(*args, scale=SCALE, **kw)
    assert (PA.paged_decode_attention.launches,
            PA.paged_decode_attention.visible_launches) == (
                before[0] + 1, before[1] + 1)
    want = PA.paged_decode_attention_plain(*args, scale=SCALE, **kw, **walk)
    mag = PA.paged_decode_attention_plain(args[0], args[1], args[2].abs(),
                                          *args[3:], scale=SCALE, **kw,
                                          **walk)[0]
    torch.cuda.synchronize()
    rtol = 1e-2 if dtype == "bfloat16" else 1e-5
    atol = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-4}[dtype]
    check_partials(got, want, mag, rtol, atol)
    check_partials(prefix, want, mag, rtol, atol)
    assert float(got[1][0, 0]) == PA.FILL
    assert float(got[2][0].abs().max()) == 0.0


@pytest.mark.cuda
def test_sparse_reads_step_kernel_matches_gather_on_card(cuda):
    vcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16,
                         sparse_attn=(True, False), sparse_block=4)
    model = TD.dalle_init(cfg, seed=0, device=cuda)
    L, ps = cfg.seq_len, 8
    mp = L // ps
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, 2 * mp + 1, 2, ps, 16)
    pool = {"k": torch.randn(shape, generator=g, device=cuda),
            "v": torch.randn(shape, generator=g, device=cuda)}
    bt = (torch.arange(2 * mp, device=cuda) + 1).reshape(2, mp) \
        .to(torch.int32)
    pos = torch.tensor([L - 1, 17], dtype=torch.int32, device=cuda)
    x = torch.randn((2, 32), generator=g, device=cuda)
    key_mask = torch.ones((2, L), dtype=torch.bool, device=cuda)
    kw = dict(cfg=cfg.transformer, key_mask=key_mask, block_tables=bt,
              sparse_reads=True)
    before = PA.paged_decode_attention.visible_launches
    with torch.no_grad():
        hk, _, _ = TDEC._decode_step_math(model.transformer, x, pos, pool,
                                          **kw)
        hg, _, _ = TDEC._decode_step_math(model.transformer, x, pos, pool,
                                          attn_impl="gather", **kw)
    assert PA.paged_decode_attention.visible_launches == before + 1
    torch.testing.assert_close(hk, hg, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_from_card_tensors_restores_on_the_card_bit_for_bit(
        cuda, tmp_path, dtype):
    """``checkpoint.save`` of a DALLE, its Adam state and its EMA living on
    the card, then ``restore_train`` into a fresh model and optimizer on
    the card: every parameter, moment and EMA entry bit-equal."""
    from dalle_pytorch_tpu_torch import checkpoint as TC
    from dalle_pytorch_tpu_torch.cli import common as TCOM
    import types
    dt = getattr(torch, dtype)
    vcfg = TV.VAEConfig(image_size=32, num_tokens=24, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=50,
                         text_seq_len=8, heads=2, dim_head=16)
    args = types.SimpleNamespace(lr=1e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=1.0, ema_decay=0.9)
    model = TD.dalle_init(cfg, seed=1, dtype=dt, device=cuda)
    opt = TCOM.make_optimizer(args, model.parameters())
    ema, update = TCOM.make_ema(args, model)
    for _ in range(2):
        sum((p.float() ** 2).sum() for p in model.parameters()).backward()
        opt.step()
        update(ema, model)
    path = str(tmp_path / "ck")
    TC.save(path, model, opt_state=opt, ema=ema, config=cfg, kind="dalle")
    fresh = TD.dalle_init(cfg, seed=2, dtype=dt, device=cuda)
    fopt = TCOM.make_optimizer(args, fresh.parameters())
    TC.restore_train(path, fresh, fopt)
    fema, _ = TCOM.make_ema(args, fresh, path)
    assert fopt.count == opt.count == 2
    old = dict(model.named_parameters())
    for n, p in fresh.named_parameters():
        assert p.device.type == "cuda" and p.dtype == dt
        assert torch.equal(p, old[n]), n
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fopt.adam.state[p][key],
                               opt.adam.state[old[n]][key]), (n, key)
        assert fema[n].device.type == "cuda"
        assert torch.equal(fema[n], ema[n]), n


@pytest.mark.cuda
def test_tiny_server_on_card_gives_the_cpu_tokens(cuda):
    """The tiny ``InferenceServer`` (paged, page 8, the kernel read, the
    prefix cache, previews) in float32 on the card, through K4, against
    the same server on the CPU (K4's plain version): identical tokens for
    a plain request, a stream (its token events end in the plain tokens,
    its last preview frame is its image) and a best-of-2 group."""
    import copy
    from dalle_pytorch_tpu_torch.serve import server as SRV
    from dalle_pytorch_tpu_torch.serve import stream as ST
    vcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    vae = TV.vae_init(vcfg, seed=1, device="cpu")
    model = TD.dalle_init(cfg, seed=2, vae=vae, device="cpu")
    got = {}
    for dev in ("cpu", cuda):
        srv = SRV.InferenceServer(
            copy.deepcopy(model).to(dev), copy.deepcopy(vae).to(dev),
            num_slots=4, chunk_steps=2, kv="paged", page_size=8,
            paged_attn="kernel", prefix_cache=True, preview_every=2,
            device=dev).start()
        launches = PA.paged_decode_attention.launches
        try:
            plain = srv.submit([3, 7, 9], seed=11).result(timeout=120)
            streamed = srv.submit([3, 7, 9], seed=11, stream=True)
            events = list(streamed.sink.events())
            sres = streamed.result(timeout=120)
            group = srv.submit([5, 2, 8], seed=4, n_samples=2)
            gres = group.result(timeout=120)
        finally:
            srv.close()
        ran = PA.paged_decode_attention.launches - launches
        assert plain.ok and sres.ok and gres.ok
        toks = [t for e in events if e["event"] == "tokens"
                for t in e["tokens"]]
        assert toks[-cfg.image_seq_len:] == list(plain.tokens)
        frames = [e for e in events if e["event"] == "preview"]
        assert frames[-1]["final"]
        np.testing.assert_array_equal(ST.unpack_image(frames[-1]["image"]),
                                      sres.image)
        if dev != "cpu":
            assert ran == cfg.depth * srv.engine.decode_steps
        got[str(dev)] = (list(plain.tokens), list(sres.tokens),
                         [list(s.tokens) for s in gres.samples])
    assert got["cuda"] == got["cpu"]


def _k4_case(seed, slots, cuda, heads=8, dh=64, page_size=16, L=1280):
    """The ``kernel`` phase's shapes (bfloat16 pages, 8 heads of 64, page
    16, L 1,280), ragged positions, one distinct page run a slot."""
    rs = np.random.RandomState(seed)
    mp = L // page_size
    P = slots * mp + 1
    pos = torch.tensor(rs.randint(0, L, slots), dtype=torch.int32)
    pos[0] = 1279
    bt = torch.tensor(rs.permutation(P - 1) + 1).reshape(slots, mp)
    need = (pos.long() + page_size - 1) // page_size
    bt = torch.where(torch.arange(mp)[None] < need[:, None], bt, 0) \
        .to(torch.int32)
    allowed = torch.arange(L)[None] < pos[:, None]
    shape = (P, heads, page_size, dh)
    q = torch.tensor(rs.randn(slots, heads, dh)).to(torch.bfloat16)
    kp = torch.tensor(rs.randn(*shape)).to(torch.bfloat16)
    vp = torch.tensor(rs.randn(*shape)).to(torch.bfloat16)
    return [t.to(cuda) for t in (q, kp, vp, bt, pos, allowed)]


@pytest.mark.cuda
def test_k4_from_two_threads_at_once_matches_plain(cuda):
    """Two threads launch K4 at the same time on ``cuda:0``, as two
    replica threads of a set do: one at 8 slots, one at 16, so the
    second grows the shared split-counter buffer while the first may be
    using the old one. Every output equals the plain version, and the
    launch count loses no increment."""
    import sys
    import threading
    PA._COUNTERS.clear()
    cases = {8: _k4_case(1, 8, cuda), 16: _k4_case(2, 16, cuda)}
    want = {n: PA.paged_decode_attention_plain(*args, scale=SCALE)
            for n, args in cases.items()}
    mags = {n: PA.paged_decode_attention_plain(
        args[0], args[1], args[2].abs(), *args[3:], scale=SCALE)[0]
        for n, args in cases.items()}
    iters = 64
    outs = {n: [] for n in cases}
    errors = []
    start = threading.Barrier(len(cases))

    def run(n):
        try:
            start.wait(timeout=60)
            for _ in range(iters):
                outs[n].append(PA.paged_decode_attention(*cases[n],
                                                         scale=SCALE))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    before = PA.paged_decode_attention.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and all(not t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == before + iters * len(cases)
    for n in cases:
        assert len(outs[n]) == iters
        for got in outs[n]:
            check_partials(got, want[n], mags[n], 1e-2, 1e-2)


@pytest.mark.cuda
def test_tiny_replica_set_on_card_gives_the_cpu_tokens(cuda):
    """A threaded set of 2 tiny replicas (paged, the kernel read) in
    float32 on the card against the same set on the CPU: identical
    tokens for 6 requests, through a drain of replica 0 with live
    migration mid-wave; K4 launched on the card."""
    import copy
    import time
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet
    vcfg = TV.VAEConfig(image_size=32, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    model = TD.dalle_init(cfg, seed=2, device="cpu")
    got = {}
    for dev in ("cpu", cuda):
        q = S.RequestQueue(max_depth=16)
        rs = ReplicaSet(copy.deepcopy(model).to(dev), q, replicas=2,
                        num_slots=4, chunk_steps=2, kv="paged",
                        page_size=8, paged_attn="kernel", device=dev)
        launches = PA.paged_decode_attention.launches
        rs.start()
        try:
            handles = [q.submit(S.Request(codes=(3, 7, i + 1), seed=i))
                       for i in range(6)]
            deadline = time.perf_counter() + 60
            while rs.replicas[0].engine.active_slots() == 0:
                assert time.perf_counter() < deadline
                time.sleep(0.001)
            rs.drain_replica(0)
            results = [h.result(timeout=120) for h in handles]
        finally:
            rs.close()
        assert all(r.ok for r in results)
        if dev != "cpu":
            assert PA.paged_decode_attention.launches > launches
        got[str(dev)] = [list(r.tokens) for r in results]
    assert got["cuda"] == got["cpu"]


@pytest.mark.cuda
def test_two_child_processes_decode_through_k4_at_once(cuda):
    """A process set of 2 tiny replicas (paged, the kernel read) in
    float32: two children, each with its own CUDA context, decode the
    same requests at once through K4; every result equals an in-process
    engine's on the card, and each child reports K4 launches of its own
    (``stats()``'s ``paged_decode_launches``, carried by its frames)."""
    import time
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet
    vcfg = TV.VAEConfig(image_size=32, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    model = TD.dalle_init(cfg, seed=2, device=cuda)
    kw = dict(num_slots=4, chunk_steps=2, kv="paged", page_size=8,
              paged_attn="kernel")
    reqs = [dict(codes=(3, 7, i + 1), seed=i) for i in range(4)] * 2
    q = S.RequestQueue(max_depth=16)
    eng = Engine(model, q, device=cuda, **kw)
    hs = [q.submit(S.Request(**r)) for r in reqs[:4]]
    eng.run_until_idle()
    want = [list(map(int, h.result(0).tokens)) for h in hs] * 2
    q = S.RequestQueue(max_depth=16)
    rs = ReplicaSet(model, q, replicas=2, isolation="process", device=cuda,
                    **kw)
    try:
        deadline = time.perf_counter() + 300
        while not all(r.engine.ready for r in rs.replicas):
            assert time.perf_counter() < deadline, "children not READY"
            rs.step_once()
        handles = [q.submit(S.Request(**r)) for r in reqs]
        deadline = time.perf_counter() + 300
        while not (all(h.done() for h in handles) and rs.idle()):
            assert time.perf_counter() < deadline, "the set did not finish"
            rs.step_once()
        got = [list(map(int, h.result(0).tokens)) for h in handles]
        per = rs.stats()["per_replica"]
    finally:
        rs.close()
    assert got == want
    assert all(p["completed"] > 0 and p["paged_decode_launches"] > 0
               for p in per), per


@pytest.mark.cuda
def test_tiny_gateway_on_card_gives_a_lone_engines_tokens_through_a_cell_down(
        cuda):
    """A started gateway over two tiny thread cells (paged, the kernel
    read, the prefix cache) in float32 on the card: the cell that takes
    the second routed request is killed (``gateway_cell_down_at_request``),
    its flights replay on the survivor, and every request's tokens equal
    a lone engine's on the card; K4 launched."""
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve import server as SRV
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.gateway import Gateway
    vcfg = TV.VAEConfig(image_size=32, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8)
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=vcfg, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    vae = TV.vae_init(vcfg, seed=1, device=cuda)
    model = TD.dalle_init(cfg, seed=2, vae=vae, device=cuda)
    kw = dict(num_slots=4, chunk_steps=2, kv="paged", page_size=8,
              paged_attn="kernel", prefix_cache=True)
    reqs = [dict(codes=(3, 7, i % 3 + 1), seed=i) for i in range(6)]
    q = S.RequestQueue(max_depth=16)
    eng = Engine(model, q, device=cuda, **kw)
    hs = [q.submit(S.Request(**r)) for r in reqs]
    eng.run_until_idle()
    want = [list(map(int, h.result(0).tokens)) for h in hs]
    cells = [SRV.InferenceServer(model, vae, decode_images=False,
                                 weights_version="v0", device=cuda,
                                 **kw).start() for _ in range(2)]
    gw = Gateway(cells, cfg=cfg, model_version="v0",
                 max_prompt_len=cfg.text_seq_len).start()
    launches = PA.paged_decode_attention.launches
    try:
        with faults.injected(gateway_cell_down_at_request=2):
            handles = [gw.submit(r["codes"], seed=r["seed"]) for r in reqs]
            results = [h.result(timeout=120) for h in handles]
    finally:
        gw.close(timeout=30.0)
    assert all(r.ok for r in results), [r.status for r in results]
    assert [list(map(int, r.tokens)) for r in results] == want
    assert gw.cell_downs == 1 and gw.replays >= 1
    assert PA.paged_decode_attention.launches > launches
