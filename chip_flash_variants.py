"""Where the time of the tensor-core flash bodies and of K4's wide split
body goes, on one H100.

    python3 chip_flash_variants.py          # every kernel below
    python3 chip_flash_variants.py k4       # K4's copies alone
    python3 chip_flash_variants.py f32      # float32 K1, K2b alone

Builds edited copies of ``dalle_pytorch_tpu_torch/csrc/flash_attention.cu``
side by side, each with one piece of the bfloat16 tensor-core bodies
taken out or changed, and times K1 (forward), K2a (dq) and K2b, split
(dk, dv) and fused (dq too), of each copy with CUDA events and
torch.profiler, with the all-True mask training passes and with no mask,
at three shapes (causal): ``north`` (b 8, h 8, n 1,280, d 64: the narrow
bodies), ``wide`` (b 8, h 2, n 1,280, d 256: the north width split as
heads=2, dim_head=256, where bfloat16 K1, K2a and K2b run the wide
tensor-core bodies) and ``d128`` (b 8, h 4, n 1,280, d 128: fused K2b
only, for its two d 128 designs). Then edited copies of
``csrc/block_sparse.cu`` time K3 at the wide shape (block 16, causal),
beside its bound and SDPA with the layout as a boolean mask. A copy
without a piece computes wrong values: only the ``CHECKED`` variants are
held against the plain versions, as ``chip_smoke.py`` holds them
(``held``: bf16 rtol/atol 2e-2, the gradients dq, dk and dv at
``grad_atol``). One copy carries a planted fault instead:
``dq_drop_tile``'s K2a leaves key tile 15 out of the sums of rows 960 on,
and the run fails unless ``chip_smoke.py``'s dq check rejects it (its
line also says whether the plain 2e-2 atol would have). Each shape's
first line gives the bounds (``chip_smoke.flash_bound``) and
``F.scaled_dot_product_attention``'s forward and backward alone, the
library yardstick. Prints one JSON line per variant, shape and mask, then
the card's name and power limit. Needs a CUDA card; imports nothing of
JAX.

The variants, at both shapes unless named for one: ``tree`` (north) and
``wide_tree`` (wide), the source as it is; ``no_exp`` (exponentials
replaced by their argument), ``no_score_products`` (S = Q K^T, K2a's
dP = dO V^T, and K2b's S^T and dP^T, not issued), ``no_output_products``
(O += P V, dQ += dS K, dV and dK not issued), ``no_copies`` (no key or
query tile copied after the first two); north only: ``stages3`` (K1's
narrow ring of 3 tiles filled one ahead instead of 4 filled two ahead:
less shared memory, so more blocks an SM; K2b shares the constant and
takes a query tile's 1 / l the iteration before it is used, so needs two
tiles ahead), ``dq_stages4`` (K2a's ring of 4 tiles filled two ahead, as
K1's, instead of its own 3 filled one ahead); wide only:
``wide_cuda_cores`` (the source as it is, its bf16 d 192 and 256 calls
sent back to the CUDA-core wide bodies: the wrappers ask the C entry
points for them, ``ROUTED_TO_CUDA_CORES``; the "before" of the wide
redesign of K1 and K2b split), ``wide_dq_cuda_cores`` (the same for K2a:
the "before" of its wide redesign), ``wide_dq_own_scores`` (the wide K2a
with each warpgroup computing S, P, dP and dS itself, 5 tile products a
key tile, nothing handed across) and ``wide_dq_g1`` (one warpgroup
holding the whole dQ, against two sharing the tile's work and splitting
dQ's columns), ``wide_fwd_g1`` (wide K1 as
one warpgroup of 64 query rows over a ring of three tiles filled one
ahead, its O += P V running under the next tile's S, against two
warpgroups sharing two tiles, each O += P V waited for within its
iteration), ``wide_fwd_split_ring`` (wide K1's two warpgroups with K and
V refilled at separate barriers, two a tile, so that O += P V runs
under the next S), ``wide_dkv_own_scores`` (wide K2b's dK warpgroup
computes S^T and P^T itself instead of taking P^T from the dV
warpgroup through shared memory: 5 tile products a query tile instead
of 4). ``wide_fwd_split_ring``, ``wide_dkv_own_scores``,
``wide_dq_own_scores`` and ``wide_dq_g1`` are designs the source left
behind; their edits write the code back into the copy. Fused K2b (north and wide unless
named): ``fused_cuda_cores`` (its bfloat16 calls sent back to the
CUDA-core bodies, the narrow ones by an edit of the C entry's dispatch:
the "before" of the fused redesign), its dQ flush as one scalar
``atomicAdd`` an element (``dq_flush_scalar``), one
``red.global.add.v2.f32`` a pair (``dq_flush_v2``), rows staged in
shared memory and added by the bulk asynchronous reduction
(``dq_flush_bulk``), or none (``no_dq_flush``, wrong dq: the flush's
cost), against the shipped 16-byte ``red.global.add.v4.f32`` after the
lanes' trade; its dQ product's blocks (wide and d128) into two
accumulators in turn, each block's product issued before the last is
flushed (``dq_two_accumulators``), or 128 columns wide
(``dq_block128``), against 64-column blocks one at a time; and at d128
``fused128_by_gradient`` (the wide body's split by gradient, one
warpgroup dV and dQ, one dK, against the narrow body's two warpgroups
each holding both). K3 (``BS_VARIANTS``, wide shape): ``k3_wide_tree``
(the source as it is), ``wide_k3_cuda_cores`` (its CUDA-core wide body,
``BS_ROUTED_TO_CUDA_CORES``: the "before"), ``k3_no_copies`` (no K or V
tile copied), ``k3_no_score_products``, ``k3_no_output_products``,
``k3_no_exp``, and two designs left behind: ``k3_pv_under_next_s``
(each tile's O += P V run under the next tile's S, P's fragments held
across it, against waiting for it within its iteration) and
``k3_one_group`` (at d 256 one warpgroup a query tile
holding all of O, against two each computing S and P themselves and
holding half of it). K4 (``K4_VARIANTS``, copies of
``csrc/paged_attention.cu``, timed by ``k4_records`` at the wide serving
shape, bf16 pages, 8 slots x 2 heads, dh 256, some at 8 heads and at a
late serve step too, ``K4_SHAPES``): ``k4_wide_tree`` (the source as it is),
``k4_wide_cuda_cores`` (bf16 and int8 pages above dh 128 routed back to
the CUDA-core wide body at its own split size,
``K4_ROUTED_TO_CUDA_CORES``: the "before" of the wide split body),
``k4_cp_async_ring`` (each chunk's K and V by 16-byte ``cp.async``
from every lane, as the narrow bodies copy theirs, instead of one
lane's ``cp.async.bulk`` against an mbarrier a stage: the copy design
the source left behind), ``k4_parallel_merge`` (the last block's merge
with m and l a split a thread and the columns four splits at a time,
against walking the splits in turn: no faster, left behind),
``k4_stages4`` (4 stages a warp, one block an SM), ``k4_no_copies``,
``k4_no_shuffles`` (the score's warp reduction) and ``k4_no_merge``
(the last block's merge of the splits), each taken out, and the tree at
other split sizes (``K4_SPLIT_ROWS``: 2, 8 and 16 pages of 16 a split,
against the shipped 4).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "flash_attention.cu"
MMA128 = """// d (64 x 128 f32) (+)= A B, A and B MN-major in shared memory
__device__ __forceinline__ void mma_ss_n128_mn(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

"""
# fused K2b's dQ flush as the source has it (add_dq_block's body): the
# lanes' trade and one red.global.add.v4.f32 per 4 columns of a row
DQ_FLUSH = """  const bool odd = t & 1;
  const int r = odd ? row + 8 : row;
  float* dst = dq + static_cast<size_t>(r) * D + 2 * (t & ~1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = __shfl_xor_sync(0xffffffffu,
                                    odd ? c[4 * j] : c[4 * j + 2], 1);
    const float y = __shfl_xor_sync(0xffffffffu,
                                    odd ? c[4 * j + 1] : c[4 * j + 3], 1);
    if (r >= n) continue;
    if (odd)
      wg::red_add_v4(dst + 8 * j, x, y, c[4 * j + 2], c[4 * j + 3]);
    else
      wg::red_add_v4(dst + 8 * j, c[4 * j], c[4 * j + 1], x, y);
  }
"""

# the wide K2a's warpgroups each computing S, P, dP and dS themselves:
# every row statistic and the pad flags in both, S and dP issued back to
# back, dS formed in registers, nothing handed across
WIDE_DQ_OWN_SCORES = {
    "    nml2[hh] = ok && !DS_GROUP ? ": "    nml2[hh] = ok ? ",
    "    cl[hh] = ok && !DS_GROUP ? ": "    cl[hh] = ok ? ",
    "    drow[hh] = ok && DS_GROUP ? ": "    drow[hh] = ok ? ",
    "      mask_row && !DS_GROUP ? wg::mask_flags(mask_row, 0, n, lane) : 3u;":
        "      mask_row ? wg::mask_flags(mask_row, 0, n, lane) : 3u;",
    "    if constexpr (!DS_GROUP) {\n      const uint64_t kbits":
        "    {\n      const uint64_t kbits",
    """      float s[32];
      zero(s);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(s, wg::desc_k(sQ, kk), wg::desc_k(tK, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::hold(s);
""": """      float s[32], dp[32];
      zero(s);
      zero(dp);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(s, wg::desc_k(sQ, kk), wg::desc_k(tK, kk), kk > 0);
      wg::mma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(dp, wg::desc_k(sO, kk), wg::desc_k(tV, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<1>();
      wg::hold(s);
""",
    """#pragma unroll
      for (int i = 0; i < 32; ++i) shared_p[i * wg::kThreads + r] = s[i];
      wg::bar_arrive(1, 2 * wg::kThreads);
      wg::bar_sync(2, 2 * wg::kThreads);     // warpgroup 1's dS is in
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          da[kk][j] = shared_ds[(4 * kk + j) * wg::kThreads + r];
    } else {
      float dp[32];
      zero(dp);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wg::mma_ss_n64(dp, wg::desc_k(sO, kk), wg::desc_k(tV, kk), kk > 0);
      wg::mma_commit();
      wg::bar_sync(1, 2 * wg::kThreads);     // warpgroup 0's P is in
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = shared_p[i * wg::kThreads + r];
      wg::mma_wait<0>();              // dP
""": """      float (&p)[32] = s;
      wg::mma_wait<0>();              // dP
""",
    """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          shared_ds[(4 * kk + j) * wg::kThreads + r] = da[kk][j];
      wg::bar_arrive(2, 2 * wg::kThreads);
    }
""": """    }
""",
}

# float32 fused K2b's dQ^T flush as the tree has it (dkv_tf32's atomics),
# and the staged flush ``f32_staged_flush`` writes after it
F32_ATOMIC_FLUSH = '          // dqt[4 j + 2 hh + e]: row of d 64 mh + 16 warp + g + 8 hh,\n          // query q0 + 8 j + 2 t + e\n#pragma unroll\n          for (int j = 0; j < QT / 8; ++j)\n#pragma unroll\n            for (int e = 0; e < 2; ++e) {\n              const int qr = q0 + 8 * j + 2 * t + e;\n              if (qr >= n) continue;\n#pragma unroll\n              for (int hh = 0; hh < 2; ++hh)\n                atomicAdd(dq + base + static_cast<size_t>(qr) * D + 64 * mh +\n                              16 * warp + g + 8 * hh,\n                          dqt[4 * j + 2 * hh + e]);\n            }\n        }\n      }\n'
F32_STAGED_FLUSH = '          // dqt[4 j + 2 hh + e]: row of d 64 mh + 16 warp + g + 8 hh,\n          // query q0 + 8 j + 2 t + e\n#pragma unroll\n          for (int j = 0; j < QT / 8; ++j)\n#pragma unroll\n            for (int e = 0; e < 2; ++e) {\n              const int qr = q0 + 8 * j + 2 * t + e;\n              if (qr >= n) continue;\n#pragma unroll\n              for (int hh = 0; hh < 2; ++hh)\n                atomicAdd(dq + base + static_cast<size_t>(qr) * D + 64 * mh +\n                              16 * warp + g + 8 * hh,\n                          dqt[4 * j + 2 * hh + e]);\n            }\n        }\n      }\n#pragma unroll\n      for (int mh = 0; mh < D / 64; ++mh) {\n        float dqt[QT / 2];\n        zero(dqt);\n        if (active) {\n#pragma unroll\n            for (int half = 0; half < 2; ++half) {\n              uint32_t ah[4][4], al[4][4];\n#pragma unroll\n              for (int s4 = 0; s4 < 4; ++s4) {\n                const int kk = 4 * half + s4;\n#pragma unroll\n                for (int f = 0; f < 4; ++f) {\n                  const int key = 8 * kk + t + 4 * (f >> 1);\n                  const int col = 64 * mh + 16 * warp + g + 8 * (f & 1);\n                  const uint32_t at =\n                      wg::swz32<wg::kRows>(key, col >> 2) + (col & 3) * 4;\n                  asm volatile("ld.shared.b32 %0, [%1];\\n"\n                               : "=r"(ah[s4][f])\n                               : "r"(tKhi + at)\n                               : "memory");\n                  asm volatile("ld.shared.b32 %0, [%1];\\n"\n                               : "=r"(al[s4][f])\n                               : "r"(tKlo + at)\n                               : "memory");\n                }\n              }\n              wg::mma_fence();\n#pragma unroll\n              for (int s4 = 0; s4 < 4; ++s4)\n                wg::mma3_rs<QT>(dqt, ah[s4], al[s4],\n                                wg::desc_k32<QT>(aShi, 4 * half + s4),\n                                wg::desc_k32<QT>(aSlo, 4 * half + s4));\n              wg::mma_commit();\n              wg::mma_wait<0>();\n              wg::hold(dqt);\n              wg::hold_u(ah);\n              wg::hold_u(al);\n            }\n        }\n        __syncthreads();\n        float* stage = reinterpret_cast<float*>(\n            smem_raw + (sStage + grp * kStage - wg::smem_addr(smem_raw)));\n#pragma unroll\n        for (int j = 0; j < QT / 8; ++j)\n#pragma unroll\n          for (int e = 0; e < 2; ++e)\n#pragma unroll\n            for (int hh = 0; hh < 2; ++hh)\n              stage[(8 * j + 2 * t + e) * kStageRow + 16 * warp + g +\n                    8 * hh] = dqt[4 * j + 2 * hh + e];\n        __syncthreads();\n        const float* st0 = reinterpret_cast<const float*>(\n            smem_raw + (sStage - wg::smem_addr(smem_raw)));\n        for (int i = tid; i < QT * 16; i += kNT) {\n          const int qr = i / 16, c4 = i % 16;\n          float4 x = *reinterpret_cast<const float4*>(\n              st0 + qr * kStageRow + 4 * c4);\n#pragma unroll\n          for (int gi = 1; gi < G; ++gi) {\n            const float4 y = *reinterpret_cast<const float4*>(\n                st0 + gi * (kStage / 4) + qr * kStageRow + 4 * c4);\n            x.x += y.x;\n            x.y += y.y;\n            x.z += y.z;\n            x.w += y.w;\n          }\n          if (q0 + qr < n)\n            wg::red_add_v4(dq + base + static_cast<size_t>(q0 + qr) * D +\n                               64 * mh + 4 * c4,\n                           x.x, x.y, x.z, x.w);\n        }\n      }\n'

VARIANTS = {
    "tree": {},
    "wide_tree": {},
    # float32 K1 and K2b (split and fused) at d 64 and 128 back on their
    # CUDA-core bodies (flash_fwd_kernel, flash_bwd_dkv_kernel<float>), by
    # an edit of the C entries' dispatch: the "before" of the TF32
    # tensor-core bodies (timed by ``f32_records``)
    "f32_cuda_cores": {
        "launch_fwd_tf32<": "launch_fwd<",
        "FA_DKV_TF32(64, ": "FA_DKV(float, 64, ",
        "FA_DKV_TF32(128, ": "FA_DKV(float, 128, "},
    # float32 fused K2b's dQ^T flush as the design the tree left behind:
    # each group's dQ^T staged as query rows in shared memory,
    # the groups' shares summed there and added by 16-byte vector
    # reductions (an eighth of the atomic operations at d 64), against
    # one f32 atomic an element a group. The edit turns the tree's loop
    # off and writes the staged one after it
    "f32_staged_flush": {
        F32_ATOMIC_FLUSH: F32_STAGED_FLUSH,
        "      if (active) {\n        // dQ^T (64 rows of d at a time x QT "
        "queries) = K^T dS^T: K^T's A":
            "      if (false) {\n        // dQ^T (64 rows of d at a time x "
            "QT queries) = K^T dS^T: K^T's A",
        '  static_assert(2 * G * kS <= 4 * kQT, "dS fits in the area");':
            '  static_assert(2 * G * kS <= 4 * kQT, "dS fits in the area");\n'
            '  constexpr int kStageRow = wg::kRows + 4;\n'
            '  constexpr uint32_t kStage = QT * kStageRow * sizeof(float);\n'
            '  constexpr bool kStagePast = 2 * G * kS + G * kStage <= 4 * kQT;',
        "  const uint32_t aShi = sA + grp * 2 * kS, aSlo = aShi + kS;":
            "  const uint32_t aShi = sA + grp * 2 * kS, aSlo = aShi + kS;\n"
            "  const uint32_t sStage = sA + (kStagePast ? 2 * G * kS : 0);"},
    "no_exp": {
        "x = wg::exp2_approx((x - m_new) * kLog2e);":
            "x = (x - m_new) * kLog2e;",
        ": wg::exp2_approx((x - sm[c]) * kLog2e) *":
            ": ((x - sm[c]) * kLog2e) *",
        "x = wg::exp2_approx((x * scale - mq) * kLog2e) * inv_l;":
            "x = ((x * scale - mq) * kLog2e) * inv_l;",
        "x = keep ? wg::exp2_approx(fmaf(x, sl2, nml2[hh])) * cl[hh]":
            "x = keep ? fmaf(x, sl2, nml2[hh]) * cl[hh]",
        "x = wg::exp2_approx(fmaf(x, sl2, nml2[hh])) * cl[hh];":
            "x = fmaf(x, sl2, nml2[hh]) * cl[hh];"},
    "no_score_products": {
        "wg::mma_ss_n64(s, wg::desc_k(tQ, kk), wg::desc_k(tK, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(st, wg::desc_k(tK, kk), wg::desc_k(tQ, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dpt, wg::desc_k(tV, kk), wg::desc_k(tO, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dp, wg::desc_k(tO, kk), wg::desc_k(tV, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(st, wg::desc_k(sK, kk), wg::desc_k(tQ, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dpt, wg::desc_k(sV, kk), wg::desc_k(tO, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(s, wg::desc_k(sQ, kk), wg::desc_k(tK, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dp, wg::desc_k(sO, kk), wg::desc_k(tV, kk), kk > 0);":
            ";"},
    "no_output_products": {
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, pa[kk], "
        "wg::desc_mn(tV, kk));": "",
        "mma_rs<D>(dv_acc, pa[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(dk_acc, da[kk], wg::desc_mn(tQ, kk));": ";",
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(acc, da[kk], "
        "wg::desc_mn(tK, kk));": "",
        "mma_rs<D>(acc, frag[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(acc, frag[kk], wg::desc_mn(tQ, kk));": ";",
        "      wg::mma_ss_n64_mn(acc, wg::desc_mn(tS, kk),\n"
        "                        wg::desc_mn(tK + c * wg::kBlockBytes, kk), "
        "kk > 0);": "      ;",
        "      mma_rs<COLS>(acc, da[kk],\n"
        "                   wg::desc_mn(tK + kCol0 / 64 * wg::kBlockBytes, "
        "kk));": "      ;"},
    "no_copies": {
        "    if (it < num_k) {": "    if (it < 2) {",
        "    if (iq < num_q) {\n      const int q0 = iq * kTile;":
            "    if (iq < iq0 + 2) {\n      const int q0 = iq * kTile;"},
    "stages3": {"constexpr int kStages = 4;": "constexpr int kStages = 3;"},
    "dq_stages4": {"constexpr int kDqStages = 3;":
                   "constexpr int kDqStages = 4;"},
    "wide_cuda_cores": {},
    "wide_fwd_g1": {"constexpr int kWideFwdGroups = 2;":
                    "constexpr int kWideFwdGroups = 1;",
                    "constexpr int kWideFwdStages = 2;":
                    "constexpr int kWideFwdStages = 3;"},
    # K1's body takes SPLIT (two stages filled one ahead), the wide kernel
    # sets it: K and V in separate copy groups, K of tile it + 1 after the
    # barrier that opens tile it, V of tile it + 1 (load_values) after a
    # second barrier (turn_values) once every warpgroup's O += P V of tile
    # it - 1 has completed, so that O += P V runs under the next S
    "wide_fwd_split_ring": {
        "template <int D, int G, int STAGES, int AHEAD>\n__device__":
            "template <int D, int G, int STAGES, int AHEAD, bool SPLIT = "
            "false>\n__device__",
        "      const uint32_t at = (it % STAGES) * kT;\n"
        "      wg::load_tile<D, kNT>(sK + at, kh, it * kTile, n, tid);\n"
        "      wg::load_tile<D, kNT>(sV + at, vh, it * kTile, n, tid);\n"
        "    }\n    wg::cp_async_commit();\n  };\n":
            "      const uint32_t at = (it % STAGES) * kT;\n"
            "      wg::load_tile<D, kNT>(sK + at, kh, it * kTile, n, tid);\n"
            "      if constexpr (!SPLIT)\n"
            "        wg::load_tile<D, kNT>(sV + at, vh, it * kTile, n, tid);\n"
            "    }\n    wg::cp_async_commit();\n  };\n"
            "  auto load_values = [&](int it) {\n"
            "    if (it < num_k)\n"
            "      wg::load_tile<D, kNT>(sV + (it % STAGES) * kT, vh, "
            "it * kTile, n, tid);\n"
            "    wg::cp_async_commit();\n  };\n"
            "  auto turn_values = [&](int it) {\n"
            "    wg::cp_async_wait<1>();\n    wg::fence_async_shared();\n"
            "    __syncthreads();\n    load_values(it + 1);\n  };\n",
        "  for (int it = 0; it < AHEAD; ++it) load_keys(it);\n":
            "  for (int it = 0; it < AHEAD; ++it) load_keys(it);\n"
            "  if constexpr (SPLIT) load_values(0);\n",
        "    wg::cp_async_wait<AHEAD - 1>();   // key tile `it` has landed":
            "    wg::cp_async_wait<SPLIT ? 1 : AHEAD - 1>();",
        "      wg::mma_wait<0>();              // the last O += P V frees "
        "its V stage\n":
            "      wg::mma_wait<0>();\n"
            "      if constexpr (SPLIT) turn_values(it);\n",
        "    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);\n":
            "    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);\n"
            "    if constexpr (SPLIT) turn_values(it);\n",
        "    if constexpr (STAGES - AHEAD == 1) {":
            "    if constexpr (STAGES - AHEAD == 1 && !SPLIT) {",
        "  fwd_wgmma<D, kWideFwdGroups, kWideFwdStages, kWideFwdAhead>(":
            "  fwd_wgmma<D, kWideFwdGroups, kWideFwdStages, kWideFwdAhead, "
            "true>("},
    # the dV warpgroup hands nothing across; the dK warpgroup issues S^T
    # before its dP^T and takes P^T and the keep bits from it
    "wide_dkv_own_scores": {
        "#pragma unroll\n"
        "      for (int i = 0; i < 32; ++i) shared_p[i * wg::kThreads + tid] "
        "= st[i];\n"
        "      shared_keep[tid] = keep;\n"
        "      wg::bar_arrive(1, 2 * wg::kThreads);\n": "",
        "      wg::mma_fence();\n#pragma unroll\n"
        "      for (int kk = 0; kk < D / 16; ++kk)\n"
        "        wg::mma_ss_n64(dpt,":
            "      wg::mma_fence();\n#pragma unroll\n"
            "      for (int kk = 0; kk < D / 16; ++kk)\n"
            "        wg::mma_ss_n64(st, wg::desc_k(sK, kk), "
            "wg::desc_k(tQ, kk), kk > 0);\n"
            "      wg::mma_commit();\n#pragma unroll\n"
            "      for (int kk = 0; kk < D / 16; ++kk)\n"
            "        wg::mma_ss_n64(dpt,",
        "      wg::bar_sync(1, 2 * wg::kThreads);     // warpgroup 0's P^T "
        "is in\n"
        "      const int r = tid - wg::kThreads;\n#pragma unroll\n"
        "      for (int i = 0; i < 32; ++i) st[i] = shared_p[i * "
        "wg::kThreads + r];\n"
        "      const uint32_t keep = shared_keep[r];\n":
            "      wg::mma_wait<1>();            // S^T (dP^T may still run)\n"
            "      wg::hold(st);\n"
            "      const uint32_t keep = probs(st);\n",
        "      33 * wg::kThreads * sizeof(float) + 1024;        // P^T, keep "
        "bits": "      1024;"},
    # fused K2b, the body it replaces: bf16 fused calls back on the
    # CUDA-core bodies (narrow by this edit of the C entry's dispatch,
    # wide through ROUTED_TO_CUDA_CORES)
    "fused_cuda_cores": {
        "  } else if (dtype == 1) {\n    err = d == 64 ? "
        "FA_DKV_WGMMA(launch_dkv_wgmma, 64)":
            "  } else if (dtype == 1 && dq == nullptr) {\n    err = d == 64 ? "
            "FA_DKV_WGMMA(launch_dkv_wgmma, 64)",
        "    err = d == 64 ? FA_DKV_TF32(64, true) : "
        "FA_DKV_TF32(128, true);":
            "    err = dtype == 0 ? (d == 64 ? FA_DKV_TF32(64, true) : "
            "FA_DKV_TF32(128, true)) : (d == 64 ? FA_DKV(bf16, 64, true) "
            ": FA_DKV(bf16, 128, true));"},
    # fused K2b's dQ flush: one scalar atomicAdd an element, or one
    # red.global.add.v2.f32 a pair without the lanes' trade, against the
    # shipped v4 reduction after it; none at all (wrong dq: its cost)
    "dq_flush_scalar": {DQ_FLUSH: """#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        atomicAdd(dq + static_cast<size_t>(r) * D + 8 * j + 2 * t + e,
                  c[4 * j + 2 * hh + e]);
  }
"""},
    "dq_flush_v2": {DQ_FLUSH: """#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\\n" ::"l"(
                       dq + static_cast<size_t>(r) * D + 8 * j + 2 * t),
                   "f"(c[4 * j + 2 * hh]), "f"(c[4 * j + 2 * hh + 1])
                   : "memory");
  }
"""},
    "no_dq_flush": {"    add_dq_block<D>(dq + 64 * c, acc, row, n, t);\n": ""},
    # fused K2b's dQ blocks into two accumulators in turn (the spent S^T
    # and dP^T), block c + 1's product issued before block c is flushed,
    # against one accumulator and one block at a time
    "dq_two_accumulators": {
        "                                       float (&acc)[32], int row, "
        "int n,\n                                       int t) {\n"
        "#pragma unroll\n  for (int c = 0; c < D / 64; ++c) {\n"
        "    wg::mma_fence();\n#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      wg::mma_ss_n64_mn(acc, wg::desc_mn(tS, kk),\n"
        "                        wg::desc_mn(tK + c * wg::kBlockBytes, kk), "
        "kk > 0);\n    wg::mma_commit();\n    wg::mma_wait<0>();\n"
        "    wg::hold(acc);\n"
        "    add_dq_block<D>(dq + 64 * c, acc, row, n, t);\n  }\n}\n":
            """                                       float (&a)[32], float (&b)[32],
                                       int row, int n, int t) {
  constexpr int kBlocks = D / 64;
  auto issue = [&](float (&acc)[32], int c) {
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss_n64_mn(acc, wg::desc_mn(tS, kk),
                        wg::desc_mn(tK + c * wg::kBlockBytes, kk), kk > 0);
    wg::mma_commit();
  };
  issue(a, 0);
#pragma unroll
  for (int c = 0; c < kBlocks; ++c) {
    float (&cur)[32] = c % 2 ? b : a;
    if (c + 1 < kBlocks) {
      issue(c % 2 ? a : b, c + 1);
      wg::mma_wait<1>();
    } else {
      wg::mma_wait<0>();
    }
    wg::hold(cur);
    add_dq_block<D>(dq + 64 * c, cur, row, n, t);
  }
}
""",
        "      add_dq<D>(dq + base, tS, tK, st, q0 + 16 * warp + g, n, t);":
            "      add_dq<D>(dq + base, tS, tK, st, dpt, q0 + 16 * warp + g, n, "
            "t);",
        "        add_dq<D>(dq + base, sS, sK, st, q0 + 16 * warp + g, n, t);":
            "        add_dq<D>(dq + base, sS, sK, st, dpt, q0 + 16 * warp + g, n, "
            "t);"},
    # d 128 fused on the wide body's split by gradient (one warpgroup dV
    # and dQ, one dK, 64 key rows a block) instead of the narrow body's
    # two warpgroups of 64 key rows, each holding dK and dV
    "fused128_by_gradient": {
        "                  : FA_DKV_WGMMA(launch_dkv_wgmma, 128);":
            "                  : dq ? FA_DKV_WGMMA(launch_dkv_wide_wgmma, 128)"
            "\n                       : FA_DKV_WGMMA(launch_dkv_wgmma, 128);"},
    # fused K2b's dQ flush by the bulk asynchronous reduction (FA3's
    # dQ): each warp stages its 16 rows of a 64-column block in shared
    # memory (the narrow body: 16 KB a warpgroup more, so d 128 no longer
    # fits; the wide body: the P^T hand-off buffer, read by then), and 16
    # lanes each add one 256-byte row into dq by
    # cp.reduce.async.bulk ... .add.f32, waited for before the next block
    "dq_flush_bulk": {
        "__device__ __forceinline__ void add_dq_block(float* dq, "
        "const float (&c)[32],\n"
        "                                             int row, int n, "
        "int t) {\n":
            "__device__ __forceinline__ void add_dq_block(float* dq, "
            "const float (&c)[32],\n"
            "                                             int row, int n, "
            "int t, float* stage) {\n",
        DQ_FLUSH: """  const int lane = threadIdx.x % 32, g = lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(stage + (g + 8 * hh) * 64 + 8 * j + 2 * t) =
          make_float2(c[4 * j + 2 * hh], c[4 * j + 2 * hh + 1]);
  wg::fence_async_shared();
  __syncwarp();
  if (lane < 16) {
    const int r = row - g + lane;
    if (r < n)
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
          "[%0], [%1], 256;\\n" ::"l"(dq + static_cast<size_t>(r) * D),
          "r"(wg::smem_addr(stage + 64 * lane))
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
  }
  __syncwarp();
""",
        "                                       float (&acc)[32], int row, "
        "int n,\n                                       int t) {\n":
            "                                       float (&acc)[32], int row, "
            "int n,\n                                       int t, "
            "float* stage) {\n",
        "    add_dq_block<D>(dq + 64 * c, acc, row, n, t);\n":
            "    add_dq_block<D>(dq + 64 * c, acc, row, n, t, stage);\n",
        "      add_dq<D>(dq + base, tS, tK, st, q0 + 16 * warp + g, n, t);":
            "      add_dq<D>(dq + base, tS, tK, st, q0 + 16 * warp + g, n, "
            "t,\n                reinterpret_cast<float*>(smem_raw + (sS + G "
            "* wg::kBlockBytes - wg::smem_addr(smem_raw))) + (grp * 4 + warp) "
            "* 1024);",
        "      sS + (WITH_DQ ? G * wg::kBlockBytes : 0);":
            "      sS + (WITH_DQ ? G * (wg::kBlockBytes + 16384) : 0);",
        "                      (dq ? G * wg::kBlockBytes : 0) +":
            "                      (dq ? G * (wg::kBlockBytes + 16384) : 0) +",
        "        add_dq<D>(dq + base, sS, sK, st, q0 + 16 * warp + g, n, t);":
            "        add_dq<D>(dq + base, sS, sK, st, q0 + 16 * warp + g, n, "
            "t,\n                  shared_p + warp * 1024);"},
    # fused K2b's dQ in 128-column blocks (one m64n128k16 accumulator of
    # 64 registers, each block waited for and flushed in turn) at the
    # widths that are multiples of 128, against 64-column blocks in turn
    "dq_block128": {
        "template <int D>\n__device__ __forceinline__ void add_dq(":
            MMA128 + "template <int D>\n__device__ __forceinline__ void "
            "add_dq(",
        "                                       int t) {\n#pragma unroll\n"
        "  for (int c = 0; c < D / 64; ++c) {\n":
            """                                       int t) {
  if constexpr (D % 128 == 0) {
#pragma unroll
    for (int c = 0; c < D / 128; ++c) {
      float w[64], lo[32], hi[32];
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss_n128_mn(w, wg::desc_mn(tS, kk),
                       wg::desc_mn(tK + 2 * c * wg::kBlockBytes, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::hold(w);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        lo[i] = w[i];
        hi[i] = w[32 + i];
      }
      add_dq_block<D>(dq + 128 * c, lo, row, n, t);
      add_dq_block<D>(dq + 128 * c + 64, hi, row, n, t);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
"""},
    "wide_dq_cuda_cores": {},
    # the wide K2a with each warpgroup computing S, P, dP and dS itself (5
    # tile products a key tile instead of 3, nothing handed across)
    "wide_dq_own_scores": WIDE_DQ_OWN_SCORES,
    # the wide K2a as one warpgroup of 64 query rows holding the whole dQ
    # (the own-scores body with one warpgroup: 3 tile products a key tile,
    # dQ's 128 accumulator registers beside S's and dP's 64)
    "wide_dq_g1": {**WIDE_DQ_OWN_SCORES, **{
        "  static_assert(COLS % 64 == 0 && COLS <= 128, "
        "\"dQ shares of 64 or 128\");":
            "  static_assert(COLS % 64 == 0, \"dQ columns\");",
        "  constexpr int kNT = 2 * wg::kThreads;\n"
        "  // this warpgroup's first dQ column":
            "  constexpr int kNT = wg::kThreads;\n"
            "  // this warpgroup's first dQ column",
        "    // from its own branch); tile it - 1's stage is free\n"
        "    wg::bar_sync(0, 2 * wg::kThreads);":
            "    // from its own branch); tile it - 1's stage is free\n"
            "    wg::bar_sync(0, wg::kThreads);",
        "__global__ void __launch_bounds__(2 * wg::kThreads)\n"
        "    flash_bwd_dq_wide_wgmma_kernel(":
            "__global__ void __launch_bounds__(wg::kThreads)\n"
            "    flash_bwd_dq_wide_wgmma_kernel(",
        "  if (threadIdx.x < wg::kThreads)\n"
        "    dq_wide_wgmma<D, 128, false>(q, k, v, dout, m, l, dstat, mask, "
        "dq, h, n,\n                                 scale, causal);\n"
        "  else\n"
        "    dq_wide_wgmma<D, D - 128, true>(q, k, v, dout, m, l, dstat, "
        "mask, dq, h,\n                                    n, scale, "
        "causal);":
            "  dq_wide_wgmma<D, D, false>(q, k, v, dout, m, l, dstat, mask, "
            "dq, h, n, scale, causal);",
        "  auto kernel = flash_bwd_dq_wide_wgmma_kernel<D>;\n"
        "  cudaError_t err = allow_smem(kernel, smem);\n"
        "  if (err != cudaSuccess) return err;\n"
        "  dim3 grid(bh, (n + kTile - 1) / kTile);\n"
        "  kernel<<<grid, 2 * wg::kThreads, smem, stream>>>(":
            "  auto kernel = flash_bwd_dq_wide_wgmma_kernel<D>;\n"
            "  cudaError_t err = allow_smem(kernel, smem);\n"
            "  if (err != cudaSuccess) return err;\n"
            "  dim3 grid(bh, (n + kTile - 1) / kTile);\n"
            "  kernel<<<grid, wg::kThreads, smem, stream>>>("}},
    "dq_drop_tile": {
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1)) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees":
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1) ||\n"
        "        it == 15) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees"},
}
CHECKED = ("tree", "wide_tree", "stages3", "dq_stages4", "wide_cuda_cores",
           "wide_dq_cuda_cores", "wide_dq_own_scores", "wide_dq_g1",
           "wide_fwd_g1", "wide_fwd_split_ring", "wide_dkv_own_scores",
           "fused_cuda_cores", "dq_flush_scalar", "dq_flush_v2",
           "dq_two_accumulators", "fused128_by_gradient", "dq_flush_bulk",
           "dq_block128")
# variants whose wrappers ask the C entry points for the CUDA-core wide
# bodies where the tree runs the wide tensor-core ones
ROUTED_TO_CUDA_CORES = ("wide_cuda_cores", "wide_dq_cuda_cores",
                        "fused_cuda_cores")
# K3 (csrc/block_sparse.cu) at the wide shape: edited copies of its
# source, each timed as the flash copies are; wide_k3_cuda_cores edits
# nothing and has the wrapper ask for the CUDA-core wide body (the "before"
# of the wide K3's redesign)
BS_SOURCE = "block_sparse.cu"
BS_VARIANTS = {
    "k3_wide_tree": {},
    "wide_k3_cuda_cores": {},
    # no K or V tile copied (Q still is)
    "k3_no_copies": {
        "    wg::load_tile<D, kNT>(sK + stage * kT, kh, ik * kTile, n, tid);\n"
        "    wg::load_tile<D, kNT>(sV + stage * kT, vh, ik * kTile, n, tid);\n":
            ""},
    "k3_no_score_products": {
        "wg::mma_ss_n64(s, wg::desc_k(sQ, kk), wg::desc_k(tK, kk), kk > 0);":
            ";"},
    "k3_no_output_products": {
        "      mma_rs<kCols>(o, pa[kk], wg::desc_mn(tV + grp * (kCols / 64) *\n"
        "                                                    wg::kBlockBytes, "
        "kk));": "      ;"},
    "k3_no_exp": {"x = wg::exp2_approx((x - shift) * kLog2e);":
                  "x = (x - shift) * kLog2e;"},
    # each tile's O += P V run under the next tile's S, P's fragments held
    # across it, as the narrow body runs it, against waiting for it within
    # its iteration
    "k3_pv_under_next_s": {"  constexpr bool kWaitPV = D > 128;":
                           "  constexpr bool kWaitPV = false;"},
    # at d 256 one warpgroup a query tile holding all of O (m64n256k16
    # output products, 204 bytes of spill), against two warpgroups each
    # computing S and P and holding half of it
    "k3_one_group": {"constexpr int kGroups = D == 256 ? 2 : 1;":
                     "constexpr int kGroups = 1;"},
}
BS_CHECKED = ("k3_wide_tree", "wide_k3_cuda_cores", "k3_pv_under_next_s",
              "k3_one_group")
BS_ROUTED_TO_CUDA_CORES = ("wide_k3_cuda_cores",)
# K4 (csrc/paged_attention.cu) at the wide serving shape: edited copies
# of its source, timed by k4_records; k4_wide_cuda_cores edits nothing
# and has the wrapper route bf16 and int8 pages back to the CUDA-core wide
# body (the "before" of the wide split body), the split sizes edit nothing
# and set the wrapper's WIDE_SPLIT_ROWS
K4_SOURCE = "paged_attention.cu"
# the last block's merge with m and l a split a thread, reduced across
# the block, and each thread's columns four splits at a time, against the
# source's walk over the splits in turn (no faster: a design left behind)
K4_PARALLEL_MERGE = {
    """  const float* all = a.part + static_cast<size_t>(bhid) * splits * (dh + 2);
  float gbig = kFill;
  for (int sp = 0; sp < nlive; ++sp)
    gbig = fmaxf(gbig, __ldcg(all + sp * (dh + 2) + dh));
  float gacc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) gacc[j] = 0.f;
  float gl = 0.f;
  for (int sp = 0; sp < nlive; ++sp) {
    const float* p = all + sp * (dh + 2);
    const float fs = expf(__ldcg(p + dh) - gbig);
    gl += __ldcg(p + dh + 1) * fs;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (tid + kThreads * j < dh)
        gacc[j] += __ldcg(p + tid + kThreads * j) * fs;
  }
""": """  // the splits' m and l, a split a thread, reduced across the block (sM
  // and sL are free again: every thread read them before the barriers
  // above); then each thread's columns over the splits, the loads of four
  // splits in flight
  const float* all = a.part + static_cast<size_t>(bhid) * splits * (dh + 2);
  float gbig = kFill;
  for (int sp = tid; sp < nlive; sp += kThreads)
    gbig = fmaxf(gbig, __ldcg(all + sp * (dh + 2) + dh));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    gbig = fmaxf(gbig, __shfl_xor_sync(kAll, gbig, o));
  if (lane == 0) sM[warp] = gbig;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) gbig = fmaxf(gbig, sM[w]);
  float gl = 0.f;
  for (int sp = tid; sp < nlive; sp += kThreads) {
    const float* p = all + sp * (dh + 2);
    gl += __ldcg(p + dh + 1) * expf(__ldcg(p + dh) - gbig);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gl += __shfl_xor_sync(kAll, gl, o);
  if (lane == 0) sL[warp] = gl;
  float gacc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) gacc[j] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < nlive; ++sp) {
    const float* p = all + sp * (dh + 2);
    const float fs = expf(__ldcg(p + dh) - gbig);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (tid + kThreads * j < dh)
        gacc[j] += __ldcg(p + tid + kThreads * j) * fs;
  }
  __syncthreads();
  gl = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) gl += sL[w];
"""}
K4_VARIANTS = {
    "k4_wide_tree": {},
    "k4_wide_cuda_cores": {},
    # a chunk's K and V by 16-byte cp.async from every lane, as the narrow
    # bodies take theirs, instead of one lane's bulk copies against an
    # mbarrier a stage: the copy design the source left behind
    "k4_cp_async_ring": {
        "  const bool bulk = DH > 128 && kv_bytes % 16 == 0;":
            "  const bool bulk = false;"},
    "k4_parallel_merge": K4_PARALLEL_MERGE,
    # 4 stages a warp at dh 256 (128 KB a block, one block an SM) instead
    # of 2 (64 KB, three)
    "k4_stages4": {"  static constexpr int kStages = kKVBytes <= 1024 ? 4 : 2;":
                   "  static constexpr int kStages = kKVBytes <= 1024 || "
                   "kKVBytes == 4096 ? 4 : 2;"},
    # the pieces, each taken out (wrong values; their cost): the K and V
    # copies (each stage's barrier armed for no bytes, so the wait still
    # passes), the score's warp reduction, the last block's merge of the
    # splits (the counter still reset)
    "k4_no_copies": {
        "          mbar_expect(bar, 2 * kv_bytes + (QUANT ? 2 * kChunk * 4 : 0));\n"
        "          bulk_copy(dst, ksrc, kv_bytes, bar);\n"
        "          bulk_copy(dst + S::kKVBytes, vsrc, kv_bytes, bar);\n"
        "          if (QUANT) {\n":
            "          mbar_expect(bar, 0);\n"
            "          if (false) {\n"},
    "k4_no_shuffles": {
        "      for (int o = S::kLanes / 2; o > 0; o >>= 1)\n"
        "        part += __shfl_xor_sync(kAll, part, o);\n":
            "      for (int o = S::kLanes / 2; o > S::kLanes; o >>= 1)\n"
            "        part += __shfl_xor_sync(kAll, part, o);\n"},
    "k4_no_merge": {
        "  if (!sLast) return;\n  __threadfence();\n"
        "  const float* all = a.part + static_cast<size_t>(bhid) * splits * "
        "(dh + 2);\n":
            "  if (!sLast) return;\n"
            "  if (tid == 0) a.counters[bhid] = 0;\n"
            "  if (tid >= 0) return;\n"
            "  const float* all = a.part + static_cast<size_t>(bhid) * splits "
            "* (dh + 2);\n"},
}
K4_CHECKED = ("k4_wide_tree", "k4_wide_cuda_cores", "k4_cp_async_ring",
              "k4_parallel_merge", "k4_stages4", "k4_split2", "k4_split8",
              "k4_split16")
K4_ROUTED_TO_CUDA_CORES = ("k4_wide_cuda_cores",)
# the tree's library at other wide split sizes: rows a split
K4_SPLIT_ROWS = {"k4_split2": 32, "k4_split8": 128, "k4_split16": 256}
# (heads, the 8 slots' positions) of each K4 shape: the smoke's timed
# serving case at 2 heads and at 8, and a late serve step at 2 heads (6
# live slots near pos 1,100, the case WIDE_SPLIT_ROWS is sized for)
K4_SHAPES = {"serving": (2, (0, 1, 15, 16, 17, 1279, 640, 1000)),
             "heads8": (8, (0, 1, 15, 16, 17, 1279, 640, 1000)),
             "late": (2, (1100, 1101, 1102, 1103, 1104, 1105, 0, 0))}
# the variants timed at a shape other than "serving" (all of them there)
K4_SHAPE_VARIANTS = {
    "heads8": ("k4_wide_tree", "k4_wide_cuda_cores", "k4_cp_async_ring",
               "k4_parallel_merge"),
    "late": ("k4_wide_tree", "k4_wide_cuda_cores", "k4_cp_async_ring",
             "k4_parallel_merge", "k4_split2", "k4_split8", "k4_split16")}
# planted faults K2a's dq check must reject; not timed
REJECTED = ("dq_drop_tile",)
# (b, h, n, d) of each shape; d128: the north width as heads=4,
# dim_head=128, for fused K2b's two d 128 designs only
SHAPES = {"north": (8, 8, 1280, 64), "wide": (8, 2, 1280, 256),
          "d128": (8, 4, 1280, 128)}
# the kernels each variant computes right (if CHECKED) or times at all, by
# shape; at the wide shape K2a runs its CUDA-core body in every variant
# but wide_cuda_cores, where it stands beside the other two
DEFAULT_KERNELS = {"north": ("k1", "k2a", "k2b_split", "k2b_fused"),
                   "wide": ("k1", "k2a", "k2b_split", "k2b_fused")}
FUSED = ("k2b_fused",)
KERNELS = {"tree": {"north": DEFAULT_KERNELS["north"], "d128": FUSED},
           "f32_cuda_cores": {},
           "wide_tree": {"wide": DEFAULT_KERNELS["wide"]},
           "stages3": {"north": ("k1",)}, "dq_stages4": {"north": ("k2a",)},
           "dq_drop_tile": {"north": ("k2a",)},
           "wide_cuda_cores": {"wide": ("k1", "k2b_split")},
           "wide_dq_cuda_cores": {"wide": ("k2a",)},
           "wide_dq_own_scores": {"wide": ("k2a",)},
           "wide_dq_g1": {"wide": ("k2a",)},
           "wide_fwd_g1": {"wide": ("k1",)},
           "wide_fwd_split_ring": {"wide": ("k1",)},
           "wide_dkv_own_scores": {"wide": ("k2b_split",)},
           "fused_cuda_cores": {"north": FUSED, "wide": FUSED},
           "dq_flush_scalar": {"north": FUSED, "wide": FUSED},
           "dq_flush_v2": {"north": FUSED, "wide": FUSED},
           "no_dq_flush": {"north": FUSED, "wide": FUSED},
           "dq_two_accumulators": {"wide": FUSED, "d128": FUSED},
           "fused128_by_gradient": {"d128": FUSED},
           "dq_flush_bulk": {"north": FUSED, "wide": FUSED},
           "dq_block128": {"wide": FUSED, "d128": FUSED}}


def build_variants(build, source=SOURCE, variants=None) -> dict:
    """{variant: loaded library} of the edited copies ``variants`` (by
    default ``VARIANTS``) of ``source``, all nvcc processes started
    together."""
    variants = VARIANTS if variants is None else variants
    src = (build.CSRC / source).read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {source}")
            text = text.replace(old, new)
        copy = build.CSRC / f"_variant_{name}.cu"      # includes resolve
        copy.write_text(text)
        lib = out_dir / f"{name}.so"
        running[name] = (copy, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(copy)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (copy, lib, proc) in running.items():
        log, _ = proc.communicate()
        copy.unlink()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        lib.with_suffix(".log").write_text(log)    # ptxas: registers, spills
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def events_us(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def rejected_by_dq_check(chip_smoke, dq, dq_p) -> dict:
    """Holds a faulty dq as ``chip_smoke.py`` holds K2a's; fails the run
    if the check passes it. Also says whether the 2e-2 atol alone would
    have passed it."""
    err = (dq.float() - dq_p.float()).abs()
    atol = chip_smoke.grad_atol(torch.bfloat16, dq_p, 2e-2)
    try:
        chip_smoke.held("planted fault dq", dq, dq_p, 2e-2, atol)
    except chip_smoke.SmokeFailure:
        pass
    else:
        raise SystemExit(f"K2a's dq check passed a planted fault (max abs "
                         f"{float(err.max()):.3e}, atol {atol:.3e})")
    bound = 2e-2 + 2e-2 * dq_p.float().abs()
    return {"max_abs_err": float(err.max()), "dq_atol": atol,
            "rejected": True,
            "passes_atol_2e-2": bool((err <= bound).all())}


def library_record(chip_smoke, shape, q, k, v, do) -> dict:
    """The bounds of the three kernels in q's dtype (float32 at three TF32
    products a product and at the CUDA cores' rate) and SDPA's forward
    and backward alone (causal, no padding) at one shape: CUDA events us
    per call and profiler device us per call."""
    import torch.nn.functional as F
    b, h, n, d = q.shape
    rec = {"shape": shape, "dtype": str(q.dtype).split(".")[-1], "b": b,
           "h": h, "n": n, "d": d}
    for kernel, kind in (("k1", "fwd"), ("k2a", "dq"), ("k2b_split", "dkv"),
                         ("k2b_fused", "fused")):
        ms, by = chip_smoke.flash_bound(kind, q.dtype, b, h, n, d)
        rec[f"{kernel}_bound_us"] = ms * 1e3
        rec[f"{kernel}_bound_by"] = by
        if q.dtype == torch.float32:
            ms, by = chip_smoke.flash_bound(kind, q.dtype, b, h, n, d,
                                            f32_rate=chip_smoke.FP32_FLOPS)
            rec[f"{kernel}_bound_cuda_cores_us"] = ms * 1e3
            rec[f"{kernel}_bound_cuda_cores_by"] = by
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, scale=512 ** -0.5)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       scale=512 ** -0.5)
    sdpa_bwd = lambda: torch.autograd.grad(   # noqa: E731
        o, leaves, do, retain_graph=True)
    rec.update(sdpa_fwd_us=events_us(sdpa),
               sdpa_fwd_device_us=chip_smoke.all_device_us(sdpa),
               sdpa_bwd_us=events_us(sdpa_bwd),
               sdpa_bwd_device_us=chip_smoke.all_device_us(sdpa_bwd))
    return rec


def k3_records(chip_smoke, libs) -> None:
    """K3's copies at the wide shape (bf16, b 8, h 2, n 1,280, d 256,
    block 16, causal), all-True mask and none: held against the plain
    version where ``BS_CHECKED`` (chip_smoke's K3 tolerances), CUDA events
    and profiler device us a call; first a line with the bound and SDPA
    with the layout as a boolean mask."""
    import torch.nn.functional as F
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    b, h, n, d = SHAPES["wide"]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, h, n, d), generator=g,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    layout = chip_smoke.sparse_layout(n)
    ms, by = chip_smoke.sparse_bound(torch.bfloat16, b, h, n, d,
                                     int(layout.sum()))
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, attn_mask=layout, scale=512 ** -0.5)
    print(json.dumps({"shape": "wide", "kernel": "k3", "bound_us": ms * 1e3,
                      "bound_by": by, "sdpa_layout_us": events_us(sdpa),
                      "sdpa_layout_device_us":
                          chip_smoke.all_device_us(sdpa)}), flush=True)
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    entry, wide_tc = BS._entry, FA.wide_tensor_cores
    try:
        for mask_name, mask in (("all_true", torch.ones(
                (b, n), dtype=torch.bool, device="cuda")), ("none", None)):
            kw = dict(scale=512 ** -0.5, causal=True,
                      block=chip_smoke.SPARSE_BLOCK, mask=mask)
            want = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
            for name, lib in libs.items():
                fn = lib.block_sparse_attention_fwd
                fn.argtypes, fn.restype = BS._ARGTYPES, ctypes.c_int
                BS._entry = lambda fn=fn: fn
                FA.wide_tensor_cores = (
                    (lambda dtype, d: False)
                    if name in BS_ROUTED_TO_CUDA_CORES else wide_tc)
                call = lambda: BS.block_sparse_attention_fwd(   # noqa: E731
                    q, k, v, **kw)
                record = {"variant": name, "shape": "wide", "kernel": "k3",
                          "mask": mask_name}
                if name in BS_CHECKED:
                    got = call()
                    rtol, atol = chip_smoke.flash_tolerances(torch.bfloat16)
                    record["max_abs_err"] = max(
                        chip_smoke.held(f"{name} K3 {part}", x, y, rtol,
                                        atol if part != "l" else 1e-4)
                        for part, x, y in zip(("out", "m", "l"), got, want))
                    record["body"] = chip_smoke.sparse_bodies(call)
                record["k3_us"] = events_us(call)
                record["k3_device_us"] = chip_smoke.all_device_us(call)
                print(json.dumps(record), flush=True)
    finally:
        BS._entry, FA.wide_tensor_cores = entry, wide_tc


def k4_records(chip_smoke, libs) -> None:
    """K4's copies at the wide serving shape (bf16 pages, 8 slots x 2
    heads, dh 256, page 16, L 1,280, ``chip_smoke.kernel_inputs``'
    positions) and some of them at the other ``K4_SHAPES``
    (``K4_SHAPE_VARIANTS``): held against the plain version where
    ``K4_CHECKED`` (chip_smoke's K4 tolerances, bf16 1e-2), CUDA events
    and profiler device us a launch of the K4 kernel the call ran; first
    a line with each shape's bound."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    entry, wide_split, rows = PA._entry, PA.wide_split, PA.WIDE_SPLIT_ROWS
    variants = {**{name: name for name in libs},
                **{name: "k4_wide_tree" for name in K4_SPLIT_ROWS}}
    try:
        for shape, (heads, positions) in K4_SHAPES.items():
            q, kp, vp, bt, pos, allowed, sc = chip_smoke.kernel_inputs(
                torch.bfloat16, heads=heads, dh=256, positions=positions)
            kw = dict(scale=512 ** -0.5, **sc)
            args = (q, kp, vp, bt, pos, allowed)
            want = PA.paged_decode_attention_plain(*args, **kw)
            mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), *args[3:],
                                                  **kw)[0]
            ms, by = chip_smoke.bound_ms(q, kp, pos, sc)
            print(json.dumps({"kernel": "k4", "shape": shape,
                              "heads": heads, "positions": positions,
                              "bound_us": ms * 1e3, "bound_by": by}),
                  flush=True)
            for name, lib_name in variants.items():
                if name not in K4_SHAPE_VARIANTS.get(shape, variants):
                    continue
                fn = libs[lib_name].paged_decode_attention
                fn.argtypes, fn.restype = PA._ARGTYPES, ctypes.c_int
                PA._entry = lambda fn=fn: fn
                PA._COUNTERS.clear()
                PA.wide_split = ((lambda kv_dtype, dh: False)
                                 if name in K4_ROUTED_TO_CUDA_CORES
                                 else wide_split)
                PA.WIDE_SPLIT_ROWS = K4_SPLIT_ROWS.get(name, rows)
                call = lambda: PA.paged_decode_attention(   # noqa: E731
                    *args, **kw)
                body = chip_smoke.launched_bodies(call, chip_smoke.K4_NAME)
                record = {"variant": name, "kernel": "k4", "shape": shape,
                          "body": body, "split_rows": PA.WIDE_SPLIT_ROWS}
                if name in K4_CHECKED:
                    record["max_abs_err"] = chip_smoke.partials_held(
                        f"{name} K4", call(), want, mag, 1e-2, 1e-2)
                record["k4_us"] = events_us(call, iters=200)
                record["k4_device_us"] = chip_smoke.named_device_us(
                    call, body[0] + "<", iters=50) if body else \
                    "not measured"
                print(json.dumps(record), flush=True)
    finally:
        PA._entry, PA.wide_split, PA.WIDE_SPLIT_ROWS = entry, wide_split, rows
        PA._COUNTERS.clear()


# float32: the TF32 tensor-core bodies of K1 and K2b (split and fused)
# against their CUDA-core bodies (``f32_cuda_cores``) and fused K2b's
# staged dq flush (``f32_staged_flush``), in turns, at the north shape
# and at d 128 (the north width as heads=4, dim_head=128)
F32_SHAPES = {"north": SHAPES["north"], "d128": SHAPES["d128"]}
F32_TURNS = ("tree", "f32_cuda_cores", "f32_staged_flush",
             "f32_staged_flush", "f32_cuda_cores", "tree")


def bind(lib) -> None:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    for fn in ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv"):
        getattr(lib, fn).argtypes = FA._ARGTYPES[fn]
        getattr(lib, fn).restype = ctypes.c_int


def f32_records(chip_smoke, libs) -> None:
    """float32 K1, K2b split and K2b fused of the tree and of
    ``f32_cuda_cores`` in the turns ``F32_TURNS`` at ``F32_SHAPES``, the
    all-True mask training passes: each held against the plain versions
    at the smoke's float32 tolerances (2e-4), timed with CUDA events and
    with the profiler (device us a launch of the flash kernel, and its
    name); first each shape's bounds (both float32 rates) and float32
    SDPA's forward and backward alone."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    entry = FA._entry
    try:
        for shape, (b, h, n, d) in F32_SHAPES.items():
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn((b, h, n, d), generator=g,
                                       device="cuda") for _ in range(4))
            print(json.dumps(library_record(chip_smoke, shape, q, k, v, do)),
                  flush=True)
            mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
            kw = dict(scale=512 ** -0.5, causal=True, mask=mask)
            out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
            args = (q, k, v, do, m_p, l_p,
                    (do.float() * out_p.float()).sum(-1))
            dk_p, dv_p, dq_p = FA.flash_attention_bwd_dkv_plain(
                *args, with_dq=True, **kw)
            calls = {
                "fwd": (lambda: FA.flash_attention_fwd(q, k, v, **kw)[:1],
                        (out_p,)),
                "dkv": (lambda: FA.flash_attention_bwd_dkv(*args,
                                                           **kw)[:2],
                        (dk_p, dv_p)),
                "fused": (lambda: FA.flash_attention_bwd_dkv(
                    *args, with_dq=True, **kw), (dk_p, dv_p, dq_p))}
            for turn, name in enumerate(F32_TURNS):
                FA._entry = lambda fn, lib=libs[name]: getattr(lib, fn)
                record = {"variant": name, "turn": turn, "shape": shape,
                          "dtype": "float32", "mask": "all_true"}
                record["max_abs_err"] = {
                    kind: max(chip_smoke.held(
                        f"{name} {shape} f32 {kind}", got, want, 2e-4, 2e-4)
                        for got, want in zip(fn(), wants))
                    for kind, (fn, wants) in calls.items()}
                device_us, names = chip_smoke.flash_device_us(calls)
                record["device_us"] = device_us
                record["bodies"] = {kind: chip_smoke.flash_body(k)
                                    for kind, k in names.items()}
                record["events_us"] = {kind: events_us(fn)
                                       for kind, (fn, _) in calls.items()}
                print(json.dumps(record), flush=True)
            del dk_p, dv_p, dq_p, out_p
    finally:
        FA._entry = entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dalle_pytorch_tpu_torch.ops import build
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    if sys.argv[1:] == ["f32"]:
        libs = build_variants(build, variants={
            name: VARIANTS[name] for name in set(F32_TURNS)})
        for lib in libs.values():
            bind(lib)
        f32_records(chip_smoke, libs)
        return card_line()
    k4_libs = build_variants(build, K4_SOURCE, K4_VARIANTS)
    if sys.argv[1:] == ["k4"]:
        k4_records(chip_smoke, k4_libs)
        return card_line()
    libs = build_variants(build)
    bs_libs = build_variants(build, BS_SOURCE, BS_VARIANTS)
    for lib in libs.values():
        bind(lib)
    entry, wide_tc = FA._entry, FA.wide_tensor_cores
    try:
        for shape, (b, h, n, d) in SHAPES.items():
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn((b, h, n, d), generator=g,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            print(json.dumps(library_record(chip_smoke, shape, q, k, v, do)),
                  flush=True)
            masks = {"all_true": torch.ones((b, n), dtype=torch.bool,
                                            device="cuda"), "none": None}
            for mask_name, mask in masks.items():
                kw = dict(scale=512 ** -0.5, causal=True, mask=mask)
                out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
                dstat = (do.float() * out_p.float()).sum(-1)
                args = (q, k, v, do, m_p, l_p, dstat)
                dk_p, dv_p, dq32_p = FA.flash_attention_bwd_dkv_plain(
                    *args, with_dq=True, **kw)
                dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
                for name, lib in libs.items():
                    kernels = KERNELS.get(name, DEFAULT_KERNELS).get(shape)
                    if not kernels:
                        continue
                    FA._entry = lambda fn, lib=lib: getattr(lib, fn)
                    FA.wide_tensor_cores = (
                        (lambda dtype, d: False)
                        if name in ROUTED_TO_CUDA_CORES else wide_tc)
                    record = {"variant": name, "shape": shape,
                              "mask": mask_name}
                    calls = {
                        "k1": (lambda: FA.flash_attention_fwd(q, k, v,
                                                              **kw)[:1],
                               (out_p,)),
                        "k2a": (lambda: (FA.flash_attention_bwd_dq(*args,
                                                                   **kw),),
                                (dq_p,)),
                        "k2b_split": (
                            lambda: FA.flash_attention_bwd_dkv(*args,
                                                               **kw)[:2],
                            (dk_p, dv_p)),
                        "k2b_fused": (
                            lambda: FA.flash_attention_bwd_dkv(
                                *args, with_dq=True, **kw),
                            (dk_p, dv_p, dq32_p))}
                    calls = {k_: c for k_, c in calls.items()
                             if k_ in kernels}
                    if name in REJECTED:
                        (dq,) = calls["k2a"][0]()
                        record.update(rejected_by_dq_check(chip_smoke, dq,
                                                           dq_p))
                        print(json.dumps(record), flush=True)
                        continue
                    if name in CHECKED:
                        record["max_abs_err"] = max(
                            chip_smoke.held(
                                f"{name} {shape} {kernel}", got, want, 2e-2,
                                chip_smoke.grad_atol(torch.bfloat16, want,
                                                     2e-2)
                                if kernel != "k1" else 2e-2)
                            for kernel, (fn, wants) in calls.items()
                            for got, want in zip(fn(), wants))
                    for kernel, (fn, _) in calls.items():
                        record[f"{kernel}_us"] = events_us(fn)
                        record[f"{kernel}_device_us"] = \
                            chip_smoke.all_device_us(fn)
                    print(json.dumps(record), flush=True)
                del dk_p, dv_p, dq_p, dq32_p, out_p
    finally:
        FA._entry, FA.wide_tensor_cores = entry, wide_tc
    f32_records(chip_smoke, libs)
    k3_records(chip_smoke, bs_libs)
    k4_records(chip_smoke, k4_libs)
    return card_line()


def card_line() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
