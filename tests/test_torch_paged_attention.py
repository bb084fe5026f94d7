"""Kernel K4 (paged-decode attention) and the page pool of the port.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_paged_attention.py runs it: the raw partials (acc, m, l) at
page_size 8 and 16, float32 and int8 pages, with a slot on its last
row, ragged slots, a slot parked at pos 0, padded rows, and random data
in every page including the trash page and unmapped ones. Tolerance
float32 rtol/atol 1e-5 on m, l and acc / l, and 1e-5 of the summands'
magnitude on the unnormalised acc (the two sum in different orders).

The CUDA kernel itself is held against the same plain version on the
card by tests/test_torch_kernels_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import paged_attention as JPA
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.serve import kv_pool as KV


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADS, DH, L = 2, 16, 24
SCALE = 32 ** -0.5


def make_inputs(page_size, quantized, seed=0, slots=4, dh=DH):
    """A pool with random content everywhere, block tables whose unmapped
    columns point at the trash page, and ragged positions: the last row,
    mid-sequence, three rows into the second page, parked at 0."""
    rs = np.random.RandomState(seed + page_size)
    mp = KV.pages_for(L, page_size)
    P = slots * mp + 1
    shape = (P, HEADS, page_size, dh)
    pos = np.array([L - 1, 5, page_size + 3, 0][:slots], np.int32)
    bt = (rs.permutation(P - 1) + 1)[:slots * mp].reshape(slots, mp)
    need = -(-pos // page_size)
    bt = np.where(np.arange(mp)[None, :] < need[:, None], bt, 0) \
        .astype(np.int32)
    allowed = np.arange(L)[None, :] < pos[:, None]
    allowed[1, 1] = False                     # a padded prompt row
    allowed[2, :page_size] = False            # a fully masked walked page
    q = rs.randn(slots, HEADS, dh).astype(np.float32)
    if quantized:
        kp = rs.randint(-127, 128, shape).astype(np.int8)
        vp = rs.randint(-127, 128, shape).astype(np.int8)
        sc = {"k_scales": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                  np.float32),
              "v_scales": rs.uniform(0.01, 0.1, shape[:-1]).astype(
                  np.float32)}
    else:
        kp = rs.randn(*shape).astype(np.float32)
        vp = rs.randn(*shape).astype(np.float32)
        sc = {}
    return q, kp, vp, bt, pos, allowed, sc


def check_partials(got, want, mag, rtol=1e-5, atol=1e-5):
    acc, m, l = (np.asarray(x, np.float64) for x in got)
    acc_w, m_w, l_w = (np.asarray(x, np.float64) for x in want)
    assert np.all(np.abs(acc - acc_w) <= rtol * np.asarray(mag) + atol)
    np.testing.assert_allclose(m, m_w, rtol=rtol, atol=atol)
    np.testing.assert_allclose(l, l_w, rtol=rtol, atol=atol)
    live = l_w > 0
    np.testing.assert_allclose(acc[live] / l[live][:, None],
                               acc_w[live] / l_w[live][:, None],
                               rtol=rtol, atol=atol)


def torch_args(q, kp, vp, bt, pos, allowed, sc):
    t = {k: torch.tensor(v) for k, v in sc.items()}
    return (torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
            torch.tensor(bt), torch.tensor(pos), torch.tensor(allowed)), t


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_matches_jax_kernel(page_size, quantized):
    q, kp, vp, bt, pos, allowed, sc = make_inputs(page_size, quantized)
    want = JPA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(allowed), scale=SCALE,
        **{k: jnp.asarray(v) for k, v in sc.items()})
    args, tsc = torch_args(q, kp, vp, bt, pos, allowed, sc)
    got = PA.paged_decode_attention(*args, scale=SCALE, **tsc)
    mag = PA.paged_decode_attention_plain(
        args[0], args[1], args[2].abs(), *args[3:], scale=SCALE, **tsc)[0]
    check_partials([g.numpy() for g in got], want, mag.numpy())
    # the JAX recurrence's corner cases, reproduced exactly
    assert float(got[1][3, 0]) == PA.FILL == JPA.FILL
    assert float(got[2][3].abs().max()) == 0.0
    assert float(got[0][3].abs().max()) == 0.0
    assert PA.paged_decode_attention.launches == 0     # CPU: no launch


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dh", [24, 48, 192, 320])
def test_plain_matches_jax_kernel_at_other_head_dims(dh, quantized,
                                                     page_size):
    """Head dims the CUDA kernel runs on the next compiled width (24 and
    48 on 32 and 64, with the real dh at run time) or on its wide body
    (192 and 320: slices of 128 acc columns, the last one partial): the
    plain version, its yardstick on the card, against the JAX kernel,
    which takes any dh."""
    q, kp, vp, bt, pos, allowed, sc = make_inputs(page_size, quantized,
                                                  seed=dh, dh=dh)
    want = JPA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(allowed), scale=dh ** -0.5,
        **{k: jnp.asarray(v) for k, v in sc.items()})
    args, tsc = torch_args(q, kp, vp, bt, pos, allowed, sc)
    got = PA.paged_decode_attention(*args, scale=dh ** -0.5, **tsc)
    mag = PA.paged_decode_attention_plain(
        args[0], args[1], args[2].abs(), *args[3:], scale=dh ** -0.5,
        **tsc)[0]
    assert got[0].shape == (4, HEADS, dh)
    check_partials([g.numpy() for g in got], want, mag.numpy())
    assert float(got[1][3, 0]) == PA.FILL == JPA.FILL


def test_masked_prefix_is_wiped_and_all_masked_walk_kept():
    """Slot 2's first page is fully masked: once a live row arrives the
    prefix carries weight exactly 0. A slot whose every walked row is
    masked keeps weight 1 per row (m = FILL, l = rows walked) — the TPU
    kernel's recurrence, not a 'fixed' one."""
    q, kp, vp, bt, pos, allowed, sc = make_inputs(8, False)
    allowed[0, :] = False
    args, _ = torch_args(q, kp, vp, bt, pos, allowed, sc)
    acc, m, l = PA.paged_decode_attention(*args, scale=SCALE)
    want = JPA.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, pos, allowed)),
        scale=SCALE)
    assert float(m[0, 0]) == PA.FILL
    assert float(l[0, 0]) == 24.0 == float(want[2][0, 0])
    np.testing.assert_allclose(acc[0].numpy(), np.asarray(want[0][0]),
                               rtol=1e-5, atol=1e-5)
    assert not allowed[2, :8].any() and float(m[2, 0]) > PA.FILL
    np.testing.assert_allclose(l[2].numpy(), np.asarray(want[2][2]),
                               rtol=1e-5)


# -- split walks (flash-decoding) and their merge ----------------------------

SPLIT_L = 88


@functools.lru_cache(maxsize=None)
def split_case(page_size, quantized):
    """Five slots over SPLIT_L rows: the last row, parked at pos 0, a
    fully masked prefix of 24 rows followed by live rows, every walked
    row masked, and one padded row; and JAX's partials (interpret)."""
    rs = np.random.RandomState(7 + page_size)
    mp = KV.pages_for(SPLIT_L, page_size)
    slots = 5
    P = slots * mp + 1
    shape = (P, HEADS, page_size, DH)
    pos = np.array([SPLIT_L - 1, 0, 40, 33, 20], np.int32)
    bt = (rs.permutation(P - 1) + 1)[:slots * mp].reshape(slots, mp)
    need = -(-pos // page_size)
    bt = np.where(np.arange(mp)[None, :] < need[:, None], bt, 0) \
        .astype(np.int32)
    allowed = np.arange(SPLIT_L)[None, :] < pos[:, None]
    allowed[2, :24] = False
    allowed[3, :] = False
    allowed[4, 7] = False
    q = rs.randn(slots, HEADS, DH).astype(np.float32)
    sc = {}
    if quantized:
        kp, vp = (rs.randint(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        sc = {n: rs.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)
              for n in ("k_scales", "v_scales")}
    else:
        kp, vp = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    want = JPA.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, pos, allowed)),
        scale=SCALE, **{k: jnp.asarray(v) for k, v in sc.items()})
    return (q, kp, vp, bt, pos, allowed, sc), [np.asarray(w) for w in want]


def split_walk(args, sc, pages_per_split):
    """The prefix walk cut into runs of ``pages_per_split`` pages, each
    run walked by the plain version (as a visible walk over its pages),
    stacked on a leading split axis."""
    q, kp, vp, bt, pos, allowed = args
    ps, mp = kp.shape[2], bt.shape[1]
    trips = (pos.long() + ps - 1) // ps
    parts = []
    for first in range(0, mp, pages_per_split):
        pages = torch.arange(first, first + pages_per_split).clamp(max=mp - 1)
        parts.append(PA.paged_decode_attention_plain(
            *args, scale=SCALE, **sc,
            visible=pages[None].expand(len(pos), -1).to(torch.int32),
            visible_cnt=(trips - first).clamp(0, pages_per_split)))
    return [torch.stack(x) for x in zip(*parts)]


@pytest.mark.parametrize("pages_per_split", [1, 3, 4])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_walk_merged_by_combine_partials(page_size, quantized,
                                               pages_per_split):
    """Splits that divide a slot's walk and splits that do not, merged,
    give the unsplit walk and JAX's kernel; the pos-0 slot's
    (0, FILL, 0), the wiped masked prefix and the all-masked walk's
    weight 1 per row come through every split size exactly."""
    raw, want = split_case(page_size, quantized)
    args, sc = torch_args(*raw)
    got = PA.combine_partials(*split_walk(args, sc, pages_per_split))
    whole = PA.paged_decode_attention_plain(*args, scale=SCALE, **sc)
    mag = PA.paged_decode_attention_plain(
        args[0], args[1], args[2].abs(), *args[3:], scale=SCALE, **sc)[0]
    check_partials([g.numpy() for g in got], [w.numpy() for w in whole],
                   mag.numpy())
    check_partials([g.numpy() for g in got], want, mag.numpy())
    acc, m, l = got
    assert float(m[1].max()) == PA.FILL == float(m[1].min())
    assert float(l[1].abs().max()) == 0.0 == float(acc[1].abs().max())
    assert float(m[3].max()) == PA.FILL
    walked = -(-33 // page_size) * page_size
    assert torch.equal(l[3], torch.full_like(l[3], float(walked)))
    assert float(m[2].min()) > PA.FILL


def test_combine_partials_of_one_split_is_identity():
    raw, _ = split_case(8, False)
    args, sc = torch_args(*raw)
    parts = PA.paged_decode_attention_plain(*args, scale=SCALE)
    got = PA.combine_partials(*(x[None] for x in parts))
    for g, w in zip(got, parts):
        assert torch.equal(g, w)


def test_wrapper_validates_inputs():
    q, kp, vp, bt, pos, allowed, sc = make_inputs(8, False)
    args, _ = torch_args(q, kp, vp, bt, pos, allowed, sc)
    with pytest.raises(KV.PageSizeError):
        PA.paged_decode_attention(args[0], args[1][:, :, :4],
                                  args[2][:, :, :4], *args[3:], scale=1.0)
    with pytest.raises(ValueError, match="int8"):
        PA.paged_decode_attention(*args, scale=1.0,
                                  k_scales=torch.ones(1),
                                  v_scales=torch.ones(1))
    with pytest.raises(ValueError, match="block tables map"):
        PA.paged_decode_attention(*args[:3], args[3][:, :1], args[4],
                                  args[5], scale=1.0)


# -- the page pool ----------------------------------------------------------

def test_validate_page_size_typed_record():
    KV.validate_page_size(8)
    KV.validate_page_size(16)
    for bad in (4, 12, 0):
        with pytest.raises(KV.PageSizeError) as e:
            KV.validate_page_size(bad)
        assert e.value.record["page_size"] == bad
        assert e.value.record["kind"] == "serve_page_size_invalid"


def test_allocator_trash_page_refcounts_and_exhaustion():
    a = KV.PageAllocator(5)
    assert a.capacity == 4 and a.free == 4
    got = a.alloc(3)
    assert got == [1, 2, 3] and KV.TRASH_PAGE not in got
    a.retain([2])
    a.release([2])
    assert a.refcount(2) == 1 and a.in_use == 3
    a.release(got)
    assert a.free == 4 and a.peak_in_use == 3
    with pytest.raises(KV.PageReleaseUnderflow):
        a.release([1])
    with pytest.raises(ValueError):
        a.retain([1])
    with pytest.raises(ValueError):
        a.release([0])
    with pytest.raises(KV.PagePoolExhausted):
        a.alloc(5)
    assert KV.pages_for(24, 16) == 2 and KV.pages_for(32, 16) == 2


def test_init_page_pool_layouts():
    from dalle_pytorch_tpu_torch.ops.transformer import TransformerConfig
    cfg = TransformerConfig(dim=32, depth=2, seq_len=24, heads=2,
                            dim_head=16)
    pool = KV.init_page_pool(cfg, 7, 8, dtype=torch.bfloat16, device="cpu")
    assert pool["k"].shape == (2, 7, 2, 8, 16)
    assert pool["k"].dtype == torch.bfloat16
    q = KV.init_page_pool(cfg, 7, 8, quantized=True, device="cpu")
    assert q["k"].dtype == torch.int8 and q["k_scale"].shape == (2, 7, 2, 8)
