"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where no CUDA device
is visible (the kernels have no CPU mode); on the H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports no JAX, so it also runs where only the port's
dependencies are installed. Tolerances: float32 rtol/atol 1e-5 and
bfloat16 1e-2 on m, l and acc / l; the unnormalised acc to the same rtol
of its summands' magnitude (sum_j p_j |v_j|), because the kernel sums
up to 1279 signed terms in another order than the plain version.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import paged_attention as PA

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
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_kernel_matches_plain(cuda, page_size, dtype, dh):
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
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 48), device=cuda)
    pages = torch.zeros((2, 1, 8, 48), device=cuda)
    bt = torch.zeros((1, 3), dtype=torch.int32, device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    allowed = torch.zeros((1, 24), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="dim_head"):
        PA.paged_decode_attention(q, pages, pages, bt, pos, allowed,
                                  scale=1.0)
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
