// Exact causal + pad flash attention, forward (K1) and backward (K2a, K2b),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dalle_pytorch_tpu/ops/flash_attention.py:
//   K1  flash_fwd_kernel      <- _fwd_kernel          (launched by _flash_fwd)
//   K2a flash_bwd_dq_kernel   <- _bwd_dq_kernel       (_pallas_attention_bwd)
//   K2b flash_bwd_dkv_kernel  <- _bwd_keygrid_kernel, both of its launch
//       sites: split mode (_bwd_dkv_kernel, dk and dv) and fused mode
//       (_bwd_fused_kernel, dq too), chosen by the WITH_DQ template flag.
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
//     dq = ds k, dk = ds^T q, dv = p^T dout.
//   * inputs f32 or bf16, every product accumulated in f32 (the Pallas
//     bodies' preferred_element_type=f32); d in {64, 128}; mask optional.
//
// Bound: operations. At the north training shapes (b 8, h 8, n 1280,
// d 64, causal) K1 does ~13.4 GFLOP of tile products against ~42 MB
// moved in bf16, some 320 flops per byte: just above the ~295 at which
// the H100's bf16 tensor cores, not its memory, become the limit. K2a
// and K2b do 1.5x and 2x K1's products.
//
// Design (simple and correct first; wgmma, TMA and tensor cores come
// later; the staging and products live in tile.cuh, shared with
// block_sparse.cu): 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16 i (i < 4) and columns tx + 16 j of every 64 x 64 score tile
// and every 64 x d accumulator, so a row's reductions are shuffles
// within 16 lanes of one warp. Tiles are staged through shared memory
// as f32 with a padded row stride (d + 1, 65), which keeps the column
// reads of every product free of bank conflicts; products are CUDA-core
// FMAs. The TPU's sequential grid becomes a loop inside each block:
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
      for (int j = 0; j < 4; ++j) sP[r * kPStride + tx + 16 * j] = s[i][j];
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
        sS[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
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
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
        sS[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
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
    err = d == 64 ? launch_fwd<__nv_bfloat16, 64>(q, k, v, mask, out, m, l,
                                                  bh, h, n, scale, causal, s)
                  : launch_fwd<__nv_bfloat16, 128>(q, k, v, mask, out, m, l,
                                                   bh, h, n, scale, causal, s);
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
      err = d == 64 ? FA_DKV(__nv_bfloat16, 64, false)
                    : FA_DKV(__nv_bfloat16, 128, false);
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
