// Block-sparse attention forward (K3) for the VariableSparsity layout, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dalle_pytorch_tpu/ops/block_sparse.py
// ::_kernel (launched by _bs_fwd). It computes what that kernel computes,
// for q, k, v of shape (b, h, n, d):
//   * the layout is procedural: pair (row, col) is allowed when
//     row / W == col / W (W = num_local_blocks * block tokens, the local
//     window) or col / block is one of the global blocks; when causal also
//     col <= row; and col < n (the ragged tail);
//   * s = (q . k) * scale in f32; a pad KEY (mask[col] false) scores the
//     finite FILL = -3.0e38, queries are never masked (the reference's
//     key-padding contract); pairs the layout leaves out are -inf;
//   * the online softmax starts from m = -inf, l = 0 and shifts by 0 while
//     the running max is not finite; out = acc / l with a zero l taken as
//     1; m is written as 0 where it is not finite; m and l are f32.
// This contract differs from the flash kernels' (K1): there the max starts
// at FILL and pad queries are masked too.
//
// Bound: bytes. At the north training shapes (b 8, h 8, n 1280, d 64,
// block 16, window 4 blocks, global block 0, causal) a row sees at most
// 80 keys: ~61 k allowed pairs per (b, h), ~1.0 GFLOP of products against
// ~42.6 MB of q, k, v, out, m and l in bf16 — ~24 flops per byte, far below
// the ~295 at which the tensor cores would set the pace.
//
// Design (simple and correct first; tensor cores, wgmma and TMA come
// later): one block of 256 threads per (b*h, 64-row query tile), the tile,
// staging and products of tile.cuh, shared with flash_attention.cu's
// forward (a 16 x 16 thread grid, each
// thread owning 4 rows and 4 columns of every 64 x 64 score tile, tiles in
// shared memory as f32 with a padded row stride, CUDA-core FMAs). The TPU
// kernel's two schedules (a static global-tiles-then-diagonal list, or a
// scan that skips tiles) both visit the allowed key tiles in ascending
// order; here one ascending walk over the key tiles skips every tile that
// tile_any proves empty for the whole query tile, so at the default layout
// a query tile reads the global tile 0 and its diagonal tile: 2 of up to
// 20 tiles. The layout is then applied per element.

#include <math.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int kMaxGlobals = 8;             // ops/block_sparse.py agrees

struct Layout {
  int block;                  // tokens per logical block
  int window;                 // tokens per local window
  int causal;
  int num_globals;
  int globals[kMaxGlobals];   // global block ids
};

// is pair (row, col) in the layout (and inside the sequence)?
__device__ __forceinline__ bool allowed(const Layout& L, int row, int col,
                                        int n) {
  if (col >= n || (L.causal && col > row)) return false;
  if (row / L.window == col / L.window) return true;
  const int cb = col / L.block;
  for (int g = 0; g < L.num_globals; ++g)
    if (cb == L.globals[g]) return true;
  return false;
}

// false only when no pair of query rows [q0, q0 + 64) and key columns
// [k0, k0 + 64) can be allowed: the key tile lies wholly in the causal
// future, or shares no window with the query tile and holds no token of a
// global block (the TPU kernel's tile_any, with the global block's whole
// token range rather than its first token)
__device__ __forceinline__ bool tile_any(const Layout& L, int q0, int k0,
                                         int n) {
  const int q_hi = min(q0 + kTile, n) - 1;
  const int k_hi = min(k0 + kTile, n) - 1;
  if (L.causal && k0 > q_hi) return false;
  if (k0 / L.window <= q_hi / L.window && q0 / L.window <= k_hi / L.window)
    return true;
  for (int g = 0; g < L.num_globals; ++g) {
    const int lo = L.globals[g] * L.block;
    if (lo <= k_hi && lo + L.block - 1 >= k0) return true;
  }
  return false;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int h, int n,
    float scale, Layout layout) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  __shared__ int sKm[kTile];

  const int bh = blockIdx.x;
  const int num_tiles = (n + kTile - 1) / kTile;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;

  load_tile<T, D>(sQ, q + base, q0, n);

  float m_i[4], l_i[4], o[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) o[i][j] = 0.f;
  }

  for (int ik = 0; ik < num_tiles; ++ik) {
    const int k0 = ik * kTile;
    if (!tile_any(layout, q0, k0, n)) continue;   // the same for the block
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, D>(sK, k + base, k0, n);
    load_tile<T, D>(sV, v + base, k0, n);
    for (int c = threadIdx.x; c < kTile; c += kThreads)
      sKm[c] = k0 + c < n && (mask_row == nullptr || mask_row[k0 + c]);
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
        float x = s[i][j] * scale;
        if (mask_row != nullptr && !sKm[c]) x = kFill;
        if (!allowed(layout, row, k0 + c, n)) x = -INFINITY;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m_i[i], row_max(rmax));
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - shift);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - shift);
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
      m_out[static_cast<size_t>(bh) * n + row] =
          m_i[i] == -INFINITY ? 0.f : m_i[i];
      l_out[static_cast<size_t>(bh) * n + row] = l_safe;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* m, void* l, int bh,
                   int h, int n, float scale, const Layout& layout,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(kTile) * (D + 1)
                                       + static_cast<size_t>(kTile) * kPStride);
  auto kernel = block_sparse_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), h,
      n, scale, layout);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/block_sparse.py: 0 float32, 1 bfloat16.
// q, k, v, out: device pointers to contiguous (b, h, n, d) arrays in that
// dtype; m, l: (b, h, n) float32; mask: (b, n) uint8 key-padding mask or
// null. block and window (= num_local_blocks * block) are in tokens;
// globals: a host array of num_globals (<= 8) global block ids. Returns the
// CUDA error of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* m, void* l, int b, int h, int n, int d, float scale, int causal,
    int block, int window, const int* globals, int num_globals, int dtype,
    void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 || (d != 64 && d != 128) || block <= 0 ||
      window <= 0 || num_globals < 0 || num_globals > kMaxGlobals ||
      (num_globals > 0 && globals == nullptr) || (dtype != 0 && dtype != 1) ||
      (n + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout layout{};
  layout.block = block;
  layout.window = window;
  layout.causal = causal;
  layout.num_globals = num_globals;
  for (int g = 0; g < num_globals; ++g) layout.globals[g] = globals[g];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b * h;
  cudaError_t err;
  if (dtype == 0)
    err = d == 64 ? launch<float, 64>(q, k, v, mask, out, m, l, bh, h, n,
                                      scale, layout, s)
                  : launch<float, 128>(q, k, v, mask, out, m, l, bh, h, n,
                                       scale, layout, s);
  else
    err = d == 64 ? launch<__nv_bfloat16, 64>(q, k, v, mask, out, m, l, bh,
                                              h, n, scale, layout, s)
                  : launch<__nv_bfloat16, 128>(q, k, v, mask, out, m, l, bh,
                                               h, n, scale, layout, s);
  return static_cast<int>(err);
}
