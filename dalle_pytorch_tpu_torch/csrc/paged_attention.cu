// Ragged paged-decode attention over a KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dalle_pytorch_tpu/ops/paged_attention.py
// ::_kernel (launched by paged_decode_attention). It computes exactly what
// that kernel computes: for each slot, the online-softmax partials
// (acc, m, l) of its single decode query against the cached K/V rows it
// reaches through its block table. The caller (ops/decode.py::_kernel_read)
// merges the current token's self-logit into those partials.
//
// What it reproduces, line for line with the TPU kernel:
//   * a slot walks ceil(pos / page_size) pages, so a slot at pos 0 walks
//     none and never reads the trash page 0;
//   * the visible walk (the TPU kernel with visible=True; launched as
//     paged_decode_visible_kernel): trip p reads LOGICAL page
//     visible[slot][p] for p < visible_cnt[slot], through the same block
//     table, instead of page p — a sparse layer's pages of its local
//     window and global blocks, in ascending order. The caller passes the
//     token-causal count, so a listed page never starts at or past pos;
//     entries past the count are padding and are never read;
//   * a masked row gets the finite FILL = -finfo(f32).max, and the
//     recurrence runs as written: an all-masked slot returns (0, FILL, 0),
//     a walked all-masked prefix is wiped by alpha = 0 once a live row
//     arrives (and is kept, weight 1 per row, if none ever does);
//   * int8 pages: the per-row f32 scales apply outside the dot products
//     (scores times k_scale, weights times v_scale);
//   * scores and accumulation in f32.
//
// Bound: bytes. Per layer it must read the walked pages of K and V,
// about sum over slots of ceil(pos/16)*16 * heads * dh * 2 * itemsize
// (some 21 MB at the north config's 8 slots near the end of a sequence),
// against ~2 flops per byte read — far below the ~295 flops per byte at
// which the H100 stops being bound by memory.
//
// Design (simple and correct first): one block of 128 threads (4 warps)
// per (slot, head). Warps take the slot's pages round-robin; each warp
// stages a tile of its page's K and V rows through its own slice of
// shared memory, computes the tile's scores (lanes split dh, a warp
// reduction per row), and keeps its own online softmax (m, l, acc). At
// the end the four warps' partials are merged with the usual two-estimate
// rescale. At the smoke's 8 slots x 8 heads = 64 blocks this leaves half
// of the 132 SMs idle; splitting a slot's pages across blocks
// (flash-decoding) fixes that in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kFill = -3.4028234663852886e+38f;   // -finfo(float32).max
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// rows staged per warp and tile: 1024 / dh, clamped to [8, 32], so the
// two staged tiles take 8 KB of shared memory per warp at every dh
template <int DH>
struct Tile {
  static constexpr int kRows = (1024 / DH) < 8 ? 8 : ((1024 / DH) > 32 ? 32 : (1024 / DH));
};

// the body of both walks; VISIBLE selects the visible-page list
template <typename TQ, typename TKV, int DH, bool QUANT, bool VISIBLE>
__device__ __forceinline__ void paged_decode_body(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ pos, const uint8_t* __restrict__ allowed,
    const int* __restrict__ visible, const int* __restrict__ visible_cnt,
    int width, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int heads, int page_size, int max_pages, int L,
    float scale) {
  constexpr int E = (DH + 31) / 32;              // dims held per lane
  constexpr int TR = Tile<DH>::kRows;
  __shared__ float sK[kWarps][TR][DH];
  __shared__ float sV[kWarps][TR][DH];
  __shared__ float sAcc[kWarps][DH];
  __shared__ float sM[kWarps];
  __shared__ float sL[kWarps];

  const int slot = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_pages = VISIBLE ? visible_cnt[slot]
                              : (pos[slot] + page_size - 1) / page_size;
  const int* vis_row =
      VISIBLE ? visible + static_cast<size_t>(slot) * width : nullptr;
  const int* bt_row = block_tables + static_cast<size_t>(slot) * max_pages;
  const uint8_t* allow_row = allowed + static_cast<size_t>(slot) * L;
  const size_t qh = (static_cast<size_t>(slot) * heads + h) * DH;

  float qr[E];
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    qr[e] = d < DH ? to_f(q[qh + d]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kFill;
  float l = 0.f;

  for (int p = warp; p < n_pages; p += kWarps) {
    const int lp = VISIBLE ? vis_row[p] : p;      // logical page of trip p
    // first K/V row of (page, head): the pool is (P, heads, page_size, DH)
    const size_t base =
        (static_cast<size_t>(bt_row[lp]) * heads + h) * page_size;
    for (int r0 = 0; r0 < page_size; r0 += TR) {
      const int rows = min(TR, page_size - r0);
      for (int i = lane; i < rows * DH; i += 32) {
        const int r = i / DH;
        const int d = i % DH;
        const size_t g = (base + r0 + r) * DH + d;
        sK[warp][r][d] = to_f(k_pages[g]);
        sV[warp][r][d] = to_f(v_pages[g]);
      }
      __syncwarp();

      // lane r keeps row r's score; lanes past the tile keep -inf, which
      // takes no part in the max and gets exp() = 0
      float s_mine = -INFINITY;
      for (int r = 0; r < rows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < DH) part += qr[e] * sK[warp][r][d];
        }
        float s = warp_sum(part) * scale;
        if (QUANT) s *= k_scales[base + r0 + r];
        const int j = lp * page_size + r0 + r;
        if (j >= L || !allow_row[j]) s = kFill;
        if (lane == r) s_mine = s;
      }

      const float m_new = fmaxf(m, warp_max(s_mine));
      const float pexp = expf(s_mine - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(pexp);
      float w = pexp;
      if (QUANT) w *= lane < rows ? v_scales[base + r0 + lane] : 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
      for (int r = 0; r < rows; ++r) {
        const float wr = __shfl_sync(kAll, w, r);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < DH) acc[e] += wr * sV[warp][r][d];
        }
      }
      m = m_new;
      __syncwarp();      // the next tile overwrites this warp's stage
    }
  }

  if (lane == 0) {
    sM[warp] = m;
    sL[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < DH) sAcc[warp][d] = acc[e];
  }
  __syncthreads();
  if (warp != 0) return;

  // merge the warps' partials; a warp that walked no page holds
  // (FILL, 0, 0) and contributes nothing
  float big = kFill;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sM[w]);
  float f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) f[w] = expf(sM[w] - big);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < DH) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sAcc[w][d] * f[w];
      acc_out[qh + d] = a;
    }
  }
  if (lane == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sL[w] * f[w];
    m_out[static_cast<size_t>(slot) * heads + h] = big;
    l_out[static_cast<size_t>(slot) * heads + h] = total;
  }
}

#define PDA_PARAMS                                                          \
  const TQ *__restrict__ q, const TKV *__restrict__ k_pages,                \
      const TKV *__restrict__ v_pages, const float *__restrict__ k_scales,  \
      const float *__restrict__ v_scales,                                   \
      const int *__restrict__ block_tables, const int *__restrict__ pos,    \
      const uint8_t *__restrict__ allowed, const int *__restrict__ visible, \
      const int *__restrict__ visible_cnt, int width,                       \
      float *__restrict__ acc_out, float *__restrict__ m_out,               \
      float *__restrict__ l_out, int heads, int page_size, int max_pages,   \
      int L, float scale
#define PDA_ARGS                                                           \
  q, k_pages, v_pages, k_scales, v_scales, block_tables, pos, allowed,     \
      visible, visible_cnt, width, acc_out, m_out, l_out, heads, page_size, \
      max_pages, L, scale

// the prefix walk and the visible walk, as two kernels so that a profile
// tells them apart
template <typename TQ, typename TKV, int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PDA_PARAMS) {
  paged_decode_body<TQ, TKV, DH, QUANT, false>(PDA_ARGS);
}

template <typename TQ, typename TKV, int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_visible_kernel(PDA_PARAMS) {
  paged_decode_body<TQ, TKV, DH, QUANT, true>(PDA_ARGS);
}

#undef PDA_PARAMS
#undef PDA_ARGS

template <typename TQ, typename TKV, int DH, bool QUANT>
void launch(const void* q, const void* kp, const void* vp, const void* ksc,
            const void* vsc, const void* bt, const void* pos,
            const void* allowed, const void* vis, const void* vis_cnt,
            int width, void* acc, void* m, void* l, int b, int heads,
            int page_size, int max_pages, int L, float scale,
            cudaStream_t stream) {
  auto kernel = vis ? paged_decode_visible_kernel<TQ, TKV, DH, QUANT>
                    : paged_decode_kernel<TQ, TKV, DH, QUANT>;
  kernel<<<b * heads, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(bt),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(allowed),
      static_cast<const int*>(vis), static_cast<const int*>(vis_cnt), width,
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      heads, page_size, max_pages, L, scale);
}

template <typename TQ, typename TKV, bool QUANT>
int by_dim(int dh, const void* q, const void* kp, const void* vp,
           const void* ksc, const void* vsc, const void* bt, const void* pos,
           const void* allowed, const void* vis, const void* vis_cnt,
           int width, void* acc, void* m, void* l, int b, int heads,
           int page_size, int max_pages, int L, float scale,
           cudaStream_t stream) {
#define PDA_CASE(D)                                                          \
  case D:                                                                    \
    launch<TQ, TKV, D, QUANT>(q, kp, vp, ksc, vsc, bt, pos, allowed, vis,    \
                              vis_cnt, width, acc, m, l, b, heads,           \
                              page_size, max_pages, L, scale, stream);       \
    return 0;
  switch (dh) {
    PDA_CASE(16)
    PDA_CASE(32)
    PDA_CASE(64)
    PDA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDA_CASE
}

}  // namespace

// dtype codes shared with ops/paged_attention.py: 0 float32, 1 bfloat16,
// 2 int8. Pointers are device pointers; every array is contiguous:
// q (b, heads, dh); k/v pages (P, heads, page_size, dh); scales
// (P, heads, page_size) float32 (int8 pages only, else null);
// block_tables (b, max_pages) int32; pos (b,) int32; allowed (b, L) uint8;
// visible (b, width) int32 logical page ids and visible_cnt (b,) int32,
// both null for the prefix walk; acc (b, heads, dh), m and l (b, heads)
// float32. Returns the CUDA error of the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* pos, const void* allowed, const void* visible,
    const void* visible_cnt, void* acc, void* m, void* l, int b, int heads,
    int dh, int page_size, int max_pages, int L, int width, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if ((visible == nullptr) != (visible_cnt == nullptr) ||
      (visible != nullptr && (width < 1 || width > max_pages)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == 0 && kv_dtype == 0) {
    rc = by_dim<float, float, false>(dh, q, k_pages, v_pages, k_scales,
                                     v_scales, block_tables, pos, allowed,
                                     visible, visible_cnt, width, acc, m, l, b,
                                     heads, page_size, max_pages, L, scale, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    rc = by_dim<__nv_bfloat16, __nv_bfloat16, false>(
        dh, q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
        allowed, visible, visible_cnt, width, acc, m, l, b, heads, page_size,
        max_pages, L, scale, s);
  } else if (q_dtype == 0 && kv_dtype == 2) {
    rc = by_dim<float, int8_t, true>(dh, q, k_pages, v_pages, k_scales,
                                     v_scales, block_tables, pos, allowed,
                                     visible, visible_cnt, width, acc, m, l, b,
                                     heads, page_size, max_pages, L, scale, s);
  } else if (q_dtype == 1 && kv_dtype == 2) {
    rc = by_dim<__nv_bfloat16, int8_t, true>(
        dh, q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
        allowed, visible, visible_cnt, width, acc, m, l, b, heads, page_size,
        max_pages, L, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
