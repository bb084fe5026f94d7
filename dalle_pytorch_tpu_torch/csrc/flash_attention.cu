// Exact causal + pad flash attention, forward (K1) and backward (K2a, K2b),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dalle_pytorch_tpu/ops/flash_attention.py:
//   K1  flash_fwd_wgmma_kernel (bf16), flash_fwd_kernel (f32)
//       <- _fwd_kernel :88 (launched by _flash_fwd)
//   K2a flash_bwd_dq_kernel   <- _bwd_dq_kernel :322 (_pallas_attention_bwd)
//   K2b <- _bwd_keygrid_kernel :367, both of its launch sites: split mode
//       (_bwd_dkv_kernel, dk and dv: flash_bwd_dkv_wgmma_kernel in bf16,
//       flash_bwd_dkv_kernel<float, D, false> in f32) and fused mode
//       (_bwd_fused_kernel, dq too: flash_bwd_dkv_kernel<T, D, true>).
//
// What they compute, with the TPU kernels' masking contract:
//   * s = (q . k) * scale in f32; a pad pair (mask[i] & mask[j] false)
//     scores the finite FILL = -3.0e38; a causal (j > i) or ragged
//     (j >= n) pair is left out, as the -inf fill leaves it out;
//   * K1 runs the online softmax from m = FILL, l = 0 and writes out in
//     the input dtype, and the row statistics m and l (a zero l becomes 1)
//     SEPARATELY in f32: m + log(l) would lose log(l) when m is FILL;
//   * K2a / K2b recompute p = exp(s - m) / l, dp = dout . v,
//     ds = p (dp - D) scale with D = sum(dout * out) from the caller, and
//     zero ds where the pad fill replaced the score;
//     dq = ds k, dk = ds^T q, dv = p^T dout;
//   * p and ds are rounded to the input dtype before the second product
//     of each pair (out = p v, dq, dk, dv), as the Pallas bodies round
//     them (p.astype(v.dtype), ds.astype(k.dtype)); a no-op in f32.
//   * inputs f32 or bf16, every product accumulated in f32 (the Pallas
//     bodies' preferred_element_type=f32); d in {64, 128}; mask optional.
//
// Bound: operations. At the north training shapes (b 8, h 8, n 1280,
// d 64, causal) K1 does 13.4 GFLOP of tile products (the causal pairs'
// S = Q K^T and O = P V) against ~42 MB moved in bf16, some 320 flops per
// byte: just above the ~295 at which the H100's bf16 tensor cores, not
// its memory, become the limit (13.6 us at 989 TFLOP/s). K2b split does
// twice that, 26.9 GFLOP (S^T, dP^T, dV, dK); K2a 1.5x and fused K2b
// 2.5x K1.
//
// Two designs:
//
// bf16 K1 and bf16 K2b split: tensor cores (wgmma.cuh). What held the
// first, CUDA-core bodies to ~2 % of the bound, and what these do:
//   1. products: every tile product is wgmma.mma_async (m64n64k16 for
//      scores, m64n{d}k16 for outputs) with f32 accumulators in
//      registers, instead of CUDA-core FMAs at the 67 TFLOP/s f32 rate;
//   2. staging: Q, K, V, dO stay bf16 and arrive by 16-byte cp.async
//      copies (zero-fill past n) into wgmma's 128-byte-swizzled layout,
//      through a 4-stage ring filled two tiles ahead of the products,
//      with one block barrier a tile instead of two plus a synchronous
//      load;
//   3. shared memory: a bf16 tile is 8 KB at d 64 (16 at 128) against
//      16.6 KB in f32 with its padded stride, and P and dS never go
//      through it: the f32 accumulator layout of a score product is,
//      element for element, the register A operand of the next product
//      (FA3's arrangement), so they are rounded to bf16 in registers.
// With products and copies this cheap, the elementwise work between them
// sets the time (a warpgroup waits on its own chain; few fit an SM), so
// only the diagonal, the ragged last and pad-carrying tiles run the
// per-pair mask tests, exponentials take the special-function unit
// (ex2.approx), and K2b takes each query tile's 1 / l once.
//   K1:  a block of G warpgroups (G = 1 at d 64, 2 at d 128), each 64
//        query rows (Q resident), walking key tiles up to the block's
//        causal diagonal; online softmax in registers, row reductions by
//        shuffles within the quad of lanes that shares a row; a tile's
//        S product is issued while the last tile's O += P V still runs.
//        73 KB of shared memory at d 64, so three blocks fit an SM.
//   K2b: G warpgroups, each 64 key rows (K and V resident), walking
//        query tiles from the diagonal on, in the transposed
//        orientation: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T per
//        (key row, query column) in registers, then dV += P^T dO and
//        dK += dS^T Q with the f32 dK, dV written once; P^T is computed
//        under dP^T's product, dS^T under dV's. 84 KB at d 64.
//
// float32 (all three), K2a and fused K2b: CUDA cores (tile.cuh, shared
// with block_sparse.cu). 256 threads as a 16 x 16 grid; thread (ty, tx)
// owns rows ty + 16 i (i < 4) and columns tx + 16 j of every 64 x 64
// score tile and every 64 x d accumulator. Tiles are staged through
// shared memory as f32 with a padded row stride (d + 1); products are
// CUDA-core FMAs, so float32 keeps full f32 products (TF32 would break
// its contracts). P and dS go through shared memory, rounded to the
// input type first, as the tensor-core bodies and JAX round them.
//
// The TPU's sequential grid becomes a loop inside each block:
//   K1, K2a: one block per (b*h, query tile), walking key tiles up to
//            the causal diagonal; nothing crosses blocks.
//   K2b:     one block per (b*h, key tile), walking query tiles from the
//            diagonal on; each block writes its own dk and dv rows.
//            In fused mode the dq rows of one query tile get a share from
//            every key-tile block, and those run in parallel, in no order
//            (the TPU kernel relied on its grid running in order to
//            revisit one VMEM block): they atomicAdd into an f32 buffer
//            the caller zeroed and casts afterwards, so the fused dq's
//            summation order changes from run to run.
// Heavy tiles are scheduled first: under causal masking the last query
// tiles (K1, K2a) and the first key tiles (K2b) walk the most.

#include <math.h>
#include <stdint.h>

#include "tile.cuh"
#include "wgmma.cuh"

namespace {

// per-row statistics of rows [row0, row0 + 64): m, 1 / l, D and the pad
// flag; rows past n get (0, 1, 0, 0)
__device__ __forceinline__ void load_stats(float* sM, float* sInvL, float* sD,
                                           int* sMask, const float* m,
                                           const float* l, const float* dstat,
                                           const uint8_t* mask_row, int row0,
                                           int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int g = row0 + r;
    const bool ok = g < n;
    sM[r] = ok ? m[g] : 0.f;
    sInvL[r] = ok ? 1.f / l[g] : 1.f;
    sD[r] = ok ? dstat[g] : 0.f;
    sMask[r] = ok && (mask_row == nullptr || mask_row[g]);
  }
}

__device__ __forceinline__ void load_mask(int* sMask, const uint8_t* mask_row,
                                          int row0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int g = row0 + r;
    sMask[r] = g < n && (mask_row == nullptr || mask_row[g]);
  }
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int h, int n,
    float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  __shared__ int sQm[kTile];
  __shared__ int sKm[kTile];

  const int bh = blockIdx.x;
  const int num_tiles = (n + kTile - 1) / kTile;
  const int iq = num_tiles - 1 - blockIdx.y;
  const int q0 = iq * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;

  load_tile<T, D>(sQ, q + base, q0, n);
  load_mask(sQm, mask_row, q0, n);

  float m_i[4], l_i[4], o[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kFill;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[i][j] = 0.f;
  }

  const int num_k = causal ? min(num_tiles, iq + 1) : num_tiles;
  for (int ik = 0; ik < num_k; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(sK, k + base, k0, n);
    load_tile<T, D>(sV, v + base, k0, n);
    load_mask(sKm, mask_row, k0, n);
    __syncthreads();

    float s[4][4];
    dot_nt<D>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        float x = s[i][j] * scale;
        if (mask && !(sQm[r] && sKm[c])) x = kFill;
        if (col >= n || (causal && col > row)) x = -INFINITY;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m_i[i], row_max(rmax));
      const float alpha = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        psum += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(psum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[r * kPStride + tx + 16 * j] = to_f(from_f<T>(s[i][j]));
    }
    __syncthreads();
    dot_nn<D>(sP, sV, o, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      out[base + static_cast<size_t>(row) * D + tx + 16 * j] =
          from_f<T>(o[i][j] / l_safe);
    if (tx == 0) {
      m_out[static_cast<size_t>(bh) * n + row] = m_i[i];
      l_out[static_cast<size_t>(bh) * n + row] = l_safe;
    }
  }
}

// p and ds of one (query tile, key tile) pair for the rows and columns this
// thread owns; excluded pairs (causal, ragged, rows past n) give 0 and 0
__device__ __forceinline__ void probs_and_ds(
    float s[4][4], float dp[4][4], const float* sM, const float* sInvL,
    const float* sD, const int* sQm, const int* sKm, bool has_mask, int q0,
    int k0, int n, float scale, int causal, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      const bool live = !has_mask || (sQm[r] && sKm[c]);
      const bool out = row >= n || col >= n || (causal && col > row);
      const float x = live ? s[i][j] * scale : kFill;
      const float p = out ? 0.f : expf(x - sM[r]) * sInvL[r];
      s[i][j] = p;
      dp[i][j] = (out || !live) ? 0.f : p * (dp[i][j] - sD[r]) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K2a: dq over key tiles up to the diagonal
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dstat,
    const uint8_t* __restrict__ mask, T* __restrict__ dq, int h, int n,
    float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);
  __shared__ float sM[kTile], sInvL[kTile], sD[kTile];
  __shared__ int sQm[kTile], sKm[kTile];

  const int bh = blockIdx.x;
  const int num_tiles = (n + kTile - 1) / kTile;
  const int iq = num_tiles - 1 - blockIdx.y;
  const int q0 = iq * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t sbase = static_cast<size_t>(bh) * n;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;

  load_tile<T, D>(sQ, q + base, q0, n);
  load_tile<T, D>(sdO, dout + base, q0, n);
  load_stats(sM, sInvL, sD, sQm, m + sbase, l + sbase, dstat + sbase,
             mask_row, q0, n);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int num_k = causal ? min(num_tiles, iq + 1) : num_tiles;
  for (int ik = 0; ik < num_k; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k + base, k0, n);
    load_tile<T, D>(sV, v + base, k0, n);
    load_mask(sKm, mask_row, k0, n);
    __syncthreads();

    float s[4][4], ds[4][4];
    dot_nt<D>(sQ, sK, s, ty, tx);
    dot_nt<D>(sdO, sV, ds, ty, tx);
    probs_and_ds(s, ds, sM, sInvL, sD, sQm, sKm, mask != nullptr, q0, k0, n,
                 scale, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sS[(ty + 16 * i) * kPStride + tx + 16 * j] =
            to_f(from_f<T>(ds[i][j]));
    __syncthreads();
    dot_nn<D>(sS, sK, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + static_cast<size_t>(row) * D + tx + 16 * j] =
          from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K2b: dk, dv (and in fused mode dq) over query tiles from the diagonal on
// ---------------------------------------------------------------------------

template <typename T, int D, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ dstat,
    const uint8_t* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dq, int h, int n, float scale, int causal) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sS = sP + kTile * kPStride;
  __shared__ float sM[kTile], sInvL[kTile], sD[kTile];
  __shared__ int sQm[kTile], sKm[kTile];

  const int bh = blockIdx.x;
  const int num_tiles = (n + kTile - 1) / kTile;
  const int ik = blockIdx.y;
  const int k0 = ik * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t sbase = static_cast<size_t>(bh) * n;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;

  load_tile<T, D>(sK, k + base, k0, n);
  load_tile<T, D>(sV, v + base, k0, n);
  load_mask(sKm, mask_row, k0, n);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // causal: query tiles before this key tile see none of it
  for (int iq = causal ? ik : 0; iq < num_tiles; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q + base, q0, n);
    load_tile<T, D>(sdO, dout + base, q0, n);
    load_stats(sM, sInvL, sD, sQm, m + sbase, l + sbase, dstat + sbase,
               mask_row, q0, n);
    __syncthreads();

    // rows: this query tile; columns: this key tile
    float s[4][4], ds[4][4];
    dot_nt<D>(sQ, sK, s, ty, tx);
    dot_nt<D>(sdO, sV, ds, ty, tx);
    probs_and_ds(s, ds, sM, sInvL, sD, sQm, sKm, mask != nullptr, q0, k0, n,
                 scale, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = to_f(from_f<T>(s[i][j]));
        sS[(ty + 16 * i) * kPStride + tx + 16 * j] =
            to_f(from_f<T>(ds[i][j]));
      }
    __syncthreads();
    dot_tn<D>(sP, sdO, dv_acc, ty, tx);
    dot_tn<D>(sS, sQ, dk_acc, ty, tx);
    if (WITH_DQ) {
      float dq_t[4][D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) dq_t[i][j] = 0.f;
      dot_nn<D>(sS, sK, dq_t, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          atomicAdd(dq + base + static_cast<size_t>(row) * D + tx + 16 * j,
                    dq_t[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const size_t at = base + static_cast<size_t>(row) * D + tx + 16 * j;
      dk[at] = from_f<T>(dk_acc[i][j]);
      dv[at] = from_f<T>(dv_acc[i][j]);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 bodies on the tensor cores (wgmma.cuh): K1 and K2b split
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using wg::aligned_smem;
using wg::hold_frags;
using wg::kLog2e;
using wg::mma_rs;
using wg::zero;
// warpgroups (64 query or key rows each) a block: at d 64 one, so that
// more blocks fit an SM; at d 128 two, sharing each staged tile
template <int D>
constexpr int groups() { return D == 64 ? 1 : 2; }
// a ring of kStages tiles in shared memory, filled kAhead tiles ahead of
// the one the products read: the tile two back may still be read by an
// output product in flight, so kAhead = kStages - 2
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;

// K1: G warpgroups of 64 query rows (Q resident); key tiles through the
// ring. Each warpgroup issues tile it's S = Q K^T while its O += P V of
// tile it - 1 is still in flight.
template <int D, int G>
__global__ void __launch_bounds__(G * wg::kThreads) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int h, int n, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kT = wg::tile_bytes<D>();
  constexpr int kNT = G * wg::kThreads;
  constexpr int kBlockRows = G * wg::kRows;
  const uint32_t sQ = aligned_smem(smem_raw);     // G tiles
  const uint32_t sK = sQ + G * kT;                // kStages tiles
  const uint32_t sV = sK + kStages * kT;          // kStages tiles

  const int tid = threadIdx.x;
  const int grp = tid / wg::kThreads;
  const int warp = tid % wg::kThreads / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int num_blocks = (n + kBlockRows - 1) / kBlockRows;
  const int q0 = (num_blocks - 1 - blockIdx.y) * kBlockRows;  // heavy first
  const int wq0 = q0 + grp * wg::kRows;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;
  const int last_row = min(q0 + kBlockRows, n) - 1;
  const int num_k = causal ? last_row / kTile + 1 : (n + kTile - 1) / kTile;

  auto load_keys = [&](int it) {            // one copy group, maybe empty
    if (it < num_k) {
      const uint32_t at = (it % kStages) * kT;
      wg::load_tile<D, kNT>(sK + at, kh, it * kTile, n, tid);
      wg::load_tile<D, kNT>(sV + at, vh, it * kTile, n, tid);
    }
    wg::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G; ++i)
    wg::load_tile<D, kNT>(sQ + i * kT, q + base, q0 + i * wg::kRows, n, tid);
#pragma unroll
  for (int it = 0; it < kAhead; ++it) load_keys(it);

  int row[2];
  bool qm[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = wq0 + 16 * warp + g + 8 * hh;
    qm[hh] = row[hh] < n && (mask_row == nullptr || mask_row[row[hh]]);
  }
  const bool live_group = wq0 < n;
  const uint32_t tQ = sQ + grp * kT;
  float o[D / 2];
  zero(o);
  float m_i[2] = {kFill, kFill}, l_i[2] = {0.f, 0.f};   // l_i: this lane's
  uint32_t pa[4][4];                                     // P of the last tile
  uint32_t kflags = mask_row ? wg::mask_flags(mask_row, 0, n, lane) : 3u;

  for (int it = 0; it < num_k; ++it) {
    wg::cp_async_wait<kAhead - 1>();  // key tile `it` has landed
    wg::fence_async_shared();
    __syncthreads();                  // ... for all; tile it - 2's stage is free
    load_keys(it + kAhead);
    const int k0 = it * kTile;
    const uint64_t kbits = mask_row ? wg::mask_bits(kflags) : ~0ull;
    if (mask_row) kflags = wg::mask_flags(mask_row, k0 + kTile, n, lane);
    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1)) {
      wg::mma_wait<0>();              // the last O += P V frees its V stage
      continue;
    }
    const uint32_t tK = sK + (it % kStages) * kT;
    const uint32_t tV = sV + (it % kStages) * kT;

    float s[32];
    zero(s);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k(tQ, kk), wg::desc_k(tK, kk), kk > 0);
    wg::mma_commit();
    wg::mma_wait<0>();                // S, and the last tile's O += P V
    wg::hold(s);
    wg::hold(o);
    hold_frags(pa);

    // masks: only the diagonal tile is causal-tested, only the last tile
    // ragged-tested, and pad pairs only where a pad is in view; other
    // tiles take a path without a select (the condition is warp-uniform)
    const bool diag = causal && k0 + kTile - 1 > wq0;
    const bool ragged = k0 + kTile > n;
    const bool pad = mask_row != nullptr &&
                     __any_sync(0xffffffffu, !(qm[0] && qm[1])) |
                         (kbits != ~0ull);
    if (diag || ragged || pad) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;
            float& x = s[4 * j + 2 * hh + e];
            x *= scale;
            if (pad && !(qm[hh] && (kbits >> c & 1))) x = kFill;
            if (k0 + c >= n || (diag && k0 + c > row[hh])) x = -INFINITY;
          }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rmax = fmaxf(rmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      const float m_new = fmaxf(m_i[hh], wg::quad_max(rmax));
      const float alpha = wg::exp2_approx((m_i[hh] - m_new) * kLog2e);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = wg::exp2_approx((x - m_new) * kLog2e);
          psum += x;
        }
      l_i[hh] = l_i[hh] * alpha + psum;
      m_i[hh] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hh] *= alpha;
        o[4 * j + 2 * hh + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 in registers as the A operand; waited
    // for at the next tile's S
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, pa[kk], wg::desc_mn(tV, kk));
    wg::mma_commit();
  }
  wg::mma_wait<0>();
  wg::hold(o);
  hold_frags(pa);

  if (!live_group) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = wg::quad_sum(l_i[hh]);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    if (row[hh] >= n) continue;
    bf16* dst = out + base + static_cast<size_t>(row[hh]) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (t == 0) {
      m_out[static_cast<size_t>(bh) * n + row[hh]] = m_i[hh];
      l_out[static_cast<size_t>(bh) * n + row[hh]] = l_safe;
    }
  }
}

// K2b split: G warpgroups of 64 key rows, K and V resident; query tiles
// (Q, dO and their rows' m, l, D) through the ring. Transposed
// orientation: S^T = K Q^T and dP^T = V dO^T put P^T and dS^T in the
// accumulator layout, which is the A operand of dV += P^T dO and
// dK += dS^T Q. P^T is computed while dP^T's product runs, and dS^T while
// dV's does. A tile's 1 / l is taken once, by 64 threads, the iteration
// before the tile is used.
template <int D, int G>
__global__ void __launch_bounds__(G * wg::kThreads)
    flash_bwd_dkv_wgmma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ m, const float* __restrict__ l,
        const float* __restrict__ dstat, const uint8_t* __restrict__ mask,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int n,
        float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kT = wg::tile_bytes<D>();
  constexpr int kNT = G * wg::kThreads;
  constexpr int kBlockRows = G * wg::kRows;
  constexpr uint32_t kStatBytes = 3 * kTile * sizeof(float);   // m, l, D
  const uint32_t sK = aligned_smem(smem_raw);     // G tiles
  const uint32_t sV = sK + G * kT;                // G tiles
  const uint32_t sQ = sV + G * kT;                // kStages tiles
  const uint32_t sO = sQ + kStages * kT;          // kStages tiles (dO)
  const uint32_t sStat = sO + kStages * kT;       // kStages x (m, l, D)
  float* stat = reinterpret_cast<float*>(
      smem_raw + (sStat - wg::smem_addr(smem_raw)));

  const int tid = threadIdx.x;
  const int grp = tid / wg::kThreads;
  const int warp = tid % wg::kThreads / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int kv0 = blockIdx.y * kBlockRows;        // heavy (causal) first
  const int wk0 = kv0 + grp * wg::kRows;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const size_t sbase = static_cast<size_t>(bh) * n;
  const bf16* qh = q + base;
  const bf16* oh = dout + base;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;
  const int num_q = (n + kTile - 1) / kTile;
  const int iq0 = causal ? kv0 / kTile : 0;

  auto load_queries = [&](int iq) {         // one copy group, maybe empty
    if (iq < num_q) {
      const int q0 = iq * kTile;
      const int stage = (iq - iq0) % kStages;
      wg::load_tile<D, kNT>(sQ + stage * kT, qh, q0, n, tid);
      wg::load_tile<D, kNT>(sO + stage * kT, oh, q0, n, tid);
      for (int i = tid; i < 3 * kTile; i += kNT) {
        const float* src = i < kTile ? m : i < 2 * kTile ? l : dstat;
        const int r = q0 + i % kTile;
        wg::cp_async4(sStat + stage * kStatBytes + 4 * i,
                      src + sbase + (r < n ? r : 0), r < n);
      }
    }
    wg::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G; ++i) {
    wg::load_tile<D, kNT>(sK + i * kT, k + base, kv0 + i * wg::kRows, n, tid);
    wg::load_tile<D, kNT>(sV + i * kT, v + base, kv0 + i * wg::kRows, n, tid);
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) load_queries(iq0 + i);

  int krow[2];
  bool km[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    krow[hh] = wk0 + 16 * warp + g + 8 * hh;
    km[hh] = krow[hh] < n && (mask_row == nullptr || mask_row[krow[hh]]);
  }
  const bool live_group = wk0 < n;
  const uint32_t tK = sK + grp * kT;
  const uint32_t tV = sV + grp * kT;
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  uint32_t qflags =
      mask_row ? wg::mask_flags(mask_row, iq0 * kTile, n, lane) : 3u;

  // l -> 1 / l in place, for query tile iq (landed and visible)
  auto invert_l = [&](int iq) {
    if (iq < num_q && tid < kTile) {
      float* sl = stat + ((iq - iq0) % kStages) * 3 * kTile + kTile + tid;
      *sl = 1.f / *sl;
    }
  };
  wg::cp_async_wait<0>();
  __syncthreads();
  invert_l(iq0);

  for (int iq = iq0; iq < num_q; ++iq) {
    const int stage = (iq - iq0) % kStages;
    wg::cp_async_wait<0>();           // query tiles `iq`, `iq + 1` have landed
    wg::fence_async_shared();
    __syncthreads();                  // ... for all; tile iq - 2's stage is free
    invert_l(iq + 1);                 // read after the next barrier
    load_queries(iq + kAhead);
    const int q0 = iq * kTile;
    const uint64_t qbits = mask_row ? wg::mask_bits(qflags) : ~0ull;
    if (mask_row) qflags = wg::mask_flags(mask_row, q0 + kTile, n, lane);
    // causal: a query tile wholly before this group's keys sees none
    if (!live_group || (causal && q0 + kTile - 1 < wk0)) continue;
    const uint32_t tQ = sQ + stage * kT;
    const uint32_t tO = sO + stage * kT;
    const float* sm = stat + stage * 3 * kTile;

    float st[32], dpt[32];            // S^T, dP^T: rows keys, columns queries
    zero(st);
    zero(dpt);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(st, wg::desc_k(tK, kk), wg::desc_k(tQ, kk), kk > 0);
    wg::mma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(dpt, wg::desc_k(tV, kk), wg::desc_k(tO, kk), kk > 0);
    wg::mma_commit();
    wg::mma_wait<1>();                // S^T (dP^T may still run)
    wg::hold(st);

    // P^T (sm[kTile + c] holds 1 / l). Pairs are tested only in a tile
    // that has some left out or pad-filled (warp-uniform); `keep` bit i:
    // pair i is neither
    const bool edge = (causal && q0 < wk0 + wg::kRows - 1) ||
                      q0 + kTile > n || wk0 + wg::kRows > n ||
                      (mask_row != nullptr &&
                       __any_sync(0xffffffffu, !(km[0] && km[1])) |
                           (qbits != ~0ull));
    uint32_t keep = ~0u;
    if (edge) {
      keep = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const bool qlive = qbits >> c & 1;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh + e;
            const bool live = mask_row == nullptr || (km[hh] && qlive);
            const bool excl = q0 + c >= n || krow[hh] >= n ||
                              (causal && q0 + c < krow[hh]);
            const float x = live ? st[i] * scale : kFill;
            st[i] = excl ? 0.f
                         : wg::exp2_approx((x - sm[c]) * kLog2e) *
                               sm[kTile + c];
            keep |= static_cast<uint32_t>(live && !excl) << i;
          }
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float mq = sm[c], inv_l = sm[kTile + c];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& x = st[4 * j + 2 * hh + e];
            x = wg::exp2_approx((x * scale - mq) * kLog2e) * inv_l;
          }
        }
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::a_frag(st, kk, pa[kk]);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<D>(dv_acc, pa[kk], wg::desc_mn(tO, kk));   // dV += P^T dO
    wg::mma_commit();
    wg::mma_wait<1>();                // dP^T (dV may still run)
    wg::hold(dpt);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float drow = sm[2 * kTile + 8 * j + 2 * t + e];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float ds = st[i] * (dpt[i] - drow) * scale;
          dpt[i] = !edge || keep >> i & 1 ? ds : 0.f;
        }
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::a_frag(dpt, kk, da[kk]);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<D>(dk_acc, da[kk], wg::desc_mn(tQ, kk));   // dK += dS^T Q
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::hold(dv_acc);
    wg::hold(dk_acc);
    hold_frags(pa);
    hold_frags(da);
  }

  if (!live_group) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (krow[hh] >= n) continue;
    const size_t at = base + static_cast<size_t>(krow[hh]) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
constexpr size_t tiles_bytes(int tiles, int p_tiles) {
  return sizeof(float) *
         (static_cast<size_t>(tiles) * kTile * (D + 1) +
          static_cast<size_t>(p_tiles) * kTile * kPStride);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* m, void* l, int bh,
                       int h, int n, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = tiles_bytes<D>(3, 1);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), h,
      n, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* m, const void* l,
                      const void* dstat, const void* mask, void* dq, int bh,
                      int h, int n, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = tiles_bytes<D>(4, 1);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dstat), static_cast<const uint8_t*>(mask),
      static_cast<T*>(dq), h, n, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D, bool WITH_DQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* m, const void* l,
                       const void* dstat, const void* mask, void* dk,
                       void* dv, void* dq, int bh, int h, int n, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = tiles_bytes<D>(4, 2);
  auto kernel = flash_bwd_dkv_kernel<T, D, WITH_DQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dstat), static_cast<const uint8_t*>(mask),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq), h, n,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* m, void* l,
                             int bh, int h, int n, float scale, int causal,
                             cudaStream_t stream) {
  constexpr int G = groups<D>();
  const size_t smem = (G + 2 * kStages) * wg::tile_bytes<D>() + 1024;
  auto kernel = flash_fwd_wgmma_kernel<D, G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + G * wg::kRows - 1) / (G * wg::kRows));
  kernel<<<grid, G * wg::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l),
      h, n, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* dstat, const void* mask, void* dk,
                             void* dv, int bh, int h, int n, float scale,
                             int causal, cudaStream_t stream) {
  constexpr int G = groups<D>();
  const size_t smem = (2 * G + 2 * kStages) * wg::tile_bytes<D>() +
                      kStages * 3 * kTile * sizeof(float) + 1024;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + G * wg::kRows - 1) / (G * wg::kRows));
  kernel<<<grid, G * wg::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dstat), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, n, scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int b, int h, int n, int d, int dtype) {
  return b > 0 && h > 0 && n > 0 && (d == 64 || d == 128) &&
         (dtype == 0 || dtype == 1) && (n + kTile - 1) / kTile <= 65535;
}

}  // namespace

// dtype codes shared with ops/flash_attention.py: 0 float32, 1 bfloat16.
// Pointers are device pointers to contiguous arrays: q, k, v, dout, out,
// dq, dk, dv (b, h, n, d) in that dtype; m, l, dstat (b, h, n) float32;
// mask (b, n) uint8 or null; the fused dq (b, h, n, d) float32, zeroed by
// the caller. Each returns the CUDA error of its launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* m,
                                   void* l, int b, int h, int n, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (!shape_ok(b, h, n, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  cudaError_t err;
  if (dtype == 0)
    err = d == 64 ? launch_fwd<float, 64>(q, k, v, mask, out, m, l, bh, h, n,
                                          scale, causal, s)
                  : launch_fwd<float, 128>(q, k, v, mask, out, m, l, bh, h, n,
                                           scale, causal, s);
  else
    err = d == 64 ? launch_fwd_wgmma<64>(q, k, v, mask, out, m, l, bh, h, n,
                                         scale, causal, s)
                  : launch_fwd_wgmma<128>(q, k, v, mask, out, m, l, bh, h, n,
                                          scale, causal, s);
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* m, const void* l,
                                      const void* dstat, const void* mask,
                                      void* dq, int b, int h, int n, int d,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (!shape_ok(b, h, n, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  cudaError_t err;
  if (dtype == 0)
    err = d == 64 ? launch_dq<float, 64>(q, k, v, dout, m, l, dstat, mask, dq,
                                         bh, h, n, scale, causal, s)
                  : launch_dq<float, 128>(q, k, v, dout, m, l, dstat, mask,
                                          dq, bh, h, n, scale, causal, s);
  else
    err = d == 64
              ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, m, l, dstat, mask,
                                             dq, bh, h, n, scale, causal, s)
              : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, m, l, dstat,
                                              mask, dq, bh, h, n, scale,
                                              causal, s);
  return static_cast<int>(err);
}

// dq null selects split mode (dk, dv); non-null selects fused mode
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* m, const void* l,
                                       const void* dstat, const void* mask,
                                       void* dk, void* dv, void* dq, int b,
                                       int h, int n, int d, float scale,
                                       int causal, int dtype, void* stream) {
  if (!shape_ok(b, h, n, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  cudaError_t err;
#define FA_DKV(T, D, F)                                                      \
  launch_dkv<T, D, F>(q, k, v, dout, m, l, dstat, mask, dk, dv, dq, bh, h, n, \
                      scale, causal, s)
  if (dq == nullptr) {
    if (dtype == 0)
      err = d == 64 ? FA_DKV(float, 64, false) : FA_DKV(float, 128, false);
    else
      err = d == 64 ? launch_dkv_wgmma<64>(q, k, v, dout, m, l, dstat, mask,
                                           dk, dv, bh, h, n, scale, causal, s)
                    : launch_dkv_wgmma<128>(q, k, v, dout, m, l, dstat, mask,
                                            dk, dv, bh, h, n, scale, causal,
                                            s);
  } else {
    if (dtype == 0)
      err = d == 64 ? FA_DKV(float, 64, true) : FA_DKV(float, 128, true);
    else
      err = d == 64 ? FA_DKV(__nv_bfloat16, 64, true)
                    : FA_DKV(__nv_bfloat16, 128, true);
  }
#undef FA_DKV
  return static_cast<int>(err);
}
