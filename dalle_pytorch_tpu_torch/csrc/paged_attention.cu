// Ragged paged-decode attention over a KV page pool (K4), for Hopper
// (sm_90a).
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
// Bound: bytes. A launch must read the walked pages of K and V, about
// sum over slots of ceil(pos/16)*16 * heads * dh * 2 * itemsize (6.2 MB,
// 1.85 us at 3.35 TB/s, at the smoke's 8 slots with one at pos 1279;
// some 21 MB at the north config's 8 slots near the end of a sequence),
// against ~2 flops per byte read — far below the ~295 flops per byte at
// which the H100 stops being bound by memory.
//
// Design: split each slot's walk across blocks (flash-decoding), so that
// the longest slot no longer walks its pages serially on one SM:
//   * grid = (slot x head, split); a split is a run of pages_per_split
//     trips (256 rows: 16 pages of 16), the number of splits comes from
//     the block tables' width on the host (pos is never read there); a
//     split past its slot's walk returns at once, having read no page;
//   * inside a block, 4 warps take the split's 8-row chunks round-robin
//     (page sizes are multiples of 8). Each chunk's K and V rows, one
//     contiguous run of the pool each, and its int8 scales arrive by
//     16-byte cp.async copies into the warp's ring of stages (4 stages at
//     bf16 dh 64: half of a split's chunks in flight at once); the split's
//     page ids and allowed bytes are read once by the block, beside the
//     walk's length and q, so that no load waits on another before the
//     copies start;
//   * a row is read as 16-byte pieces (8 bf16 lanes cover a 64-wide row,
//     4 rows a pass), its score reduced over those lanes only; the max is
//     reduced across the warp once per chunk, and l and acc stay per lane
//     until the warp's walk ends;
//   * combine: the warps' partials merge in shared memory, the splits'
//     through a scratch buffer; the last block of a (slot, head) to finish
//     (counted by an atomic on a counter the wrapper keeps zeroed, which
//     that block resets) merges them with the same two-estimate rescale,
//     so one launch still does the whole walk. A slot whose walk fits one
//     split writes its partials directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;                           // rows a warp stages
constexpr float kFill = -3.4028234663852886e+38f;   // -finfo(float32).max
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the 16 bytes at `p` as 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack(const uint8_t* p,
                                       float (&f)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
    }
  }
}

template <typename TKV, int DH>
struct Shape {
  static constexpr int kVec = 16 / sizeof(TKV);      // elements a lane loads
  static constexpr int kLanes = DH / kVec;           // lanes a row
  static constexpr int kRows = 32 / kLanes;          // rows a pass
  static constexpr int kPasses = (kChunk + kRows - 1) / kRows;
  static constexpr int kRowBytes = DH * sizeof(TKV);
  static constexpr int kKVBytes = kChunk * kRowBytes;  // K (or V) of a chunk
  // a stage: K rows, V rows, then (int8) 8 K scales and 8 V scales
  static constexpr int kStageBytes = 2 * kKVBytes + 2 * kChunk * 4;
  // stages a warp: every chunk of a bf16 dh-64 split in flight at once
  static constexpr int kStages = kKVBytes <= 1024 ? 4 : 2;
  static_assert(kLanes >= 1 && kLanes <= 32, "row of 16 .. 512 bytes");
};

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* pos;
  const uint8_t* allowed;
  const int* visible;
  const int* visible_cnt;
  float* acc;
  float* m;
  float* l;
  float* part;       // (b * heads, splits, dh + 2) f32 scratch, or null
  int* counters;     // (b * heads,) int32, zero between launches
  int heads, page_size, max_pages, L, width, pages_per_split;
  float scale;
};

// the body of both walks; VISIBLE selects the visible-page list
template <typename TQ, typename TKV, int DH, bool QUANT, bool VISIBLE>
__device__ __forceinline__ void paged_decode_body(const Args& a) {
  using S = Shape<TKV, DH>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sAcc[kWarps][DH];
  __shared__ float sM[kWarps];
  __shared__ float sL[kWarps];
  __shared__ int sLast;

  const int bhid = blockIdx.x;
  const int slot = bhid / a.heads;
  const int h = bhid % a.heads;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ps = a.page_size;
  const int pps = a.pages_per_split;

  // loaded at once, none waiting on another: the walk's length; this
  // lane's 16 bytes of q; the split's page ids, thread i <
  // pages_per_split taking trip first + i; a prefix walk's allowed bytes
  // (its block-table entries and allowed bytes are valid past its
  // length; a visible list's entries past its count are not, and wait
  // for it)
  const int walk_len = VISIBLE ? a.visible_cnt[slot] : a.pos[slot];
  const int sub = lane % S::kLanes;       // this lane's 16 bytes of a row
  const int rg = lane / S::kLanes;        // this lane's row of a pass
  const size_t qh = (static_cast<size_t>(slot) * a.heads + h) * DH;
  const TQ* q = static_cast<const TQ*>(a.q) + qh + sub * S::kVec;
  float qr[S::kVec];
#pragma unroll
  for (int e = 0; e < S::kVec; ++e) qr[e] = to_f(q[e]);
  const int first = split * pps;
  const int* vis_row =
      VISIBLE ? a.visible + static_cast<size_t>(slot) * a.width : nullptr;
  const int* bt_row = a.block_tables + static_cast<size_t>(slot) * a.max_pages;
  const bool has_trip = tid < pps && first + tid < (VISIBLE ? a.width
                                                            : a.max_pages);
  const int lp = has_trip ? (VISIBLE ? vis_row[first + tid] : first + tid)
                          : 0;
  int page = has_trip && !VISIBLE ? bt_row[lp] : 0;

  // shared memory: the warps' rings, then the split's page ids (physical,
  // logical) and allowed bytes
  uint8_t* ring = smem + warp * S::kStages * S::kStageBytes;
  int* sPage = reinterpret_cast<int*>(smem + kWarps * S::kStages *
                                                 S::kStageBytes);
  int* sLogical = sPage + pps;
  uint8_t* sAllow = reinterpret_cast<uint8_t*>(sLogical + pps);
  const uint8_t* allow_row = a.allowed + static_cast<size_t>(slot) * a.L;
  auto load_allowed = [&](int rows) {
    for (int i = tid; i < rows; i += kThreads) {
      const int j = (VISIBLE ? sLogical[i / ps] * ps + i % ps
                             : first * ps + i);
      sAllow[i] = j < a.L && allow_row[j];
    }
  };
  if (!VISIBLE) load_allowed(pps * ps);

  const int trips = VISIBLE ? walk_len : (walk_len + ps - 1) / ps;
  const int nlive = max(1, (trips + pps - 1) / pps);
  if (split >= nlive) return;                 // past the walk: reads no page
  const int npages = max(0, min(pps, trips - first));
  if (tid < npages) {
    if (VISIBLE) page = bt_row[lp];
    sLogical[tid] = lp;
    sPage[tid] = page;
  }
  __syncthreads();

  const int per_page = ps / kChunk;
  const int nchunks = npages * per_page;
  const uint8_t* kp = static_cast<const uint8_t*>(a.k_pages);
  const uint8_t* vp = static_cast<const uint8_t*>(a.v_pages);
  // chunk c of the split into stage `stage` of this warp's ring: one copy
  // group, maybe empty
  auto load_chunk = [&](int c, int stage) {
    if (c < nchunks) {
      // first row of the chunk in the pool (P, heads, page_size, DH)
      const size_t row0 =
          (static_cast<size_t>(sPage[c / per_page]) * a.heads + h) * ps +
          (c % per_page) * kChunk;
      const uint32_t dst = wg::smem_addr(ring + stage * S::kStageBytes);
      for (int i = lane; i < S::kKVBytes / 16; i += 32) {
        wg::cp_async16(dst + 16 * i, kp + row0 * S::kRowBytes + 16 * i, true);
        wg::cp_async16(dst + S::kKVBytes + 16 * i,
                       vp + row0 * S::kRowBytes + 16 * i, true);
      }
      if (QUANT && lane < 4) {
        const float* src = (lane < 2 ? a.k_scales : a.v_scales) + row0 +
                           4 * (lane % 2);
        wg::cp_async16(dst + 2 * S::kKVBytes + 16 * lane, src, true);
      }
    }
    wg::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S::kStages; ++i) load_chunk(warp + kWarps * i, i);

  // a visible walk's allowed bytes, read under the copies
  if (VISIBLE) {
    load_allowed(npages * ps);
    __syncthreads();
  }

  float acc[S::kVec];
#pragma unroll
  for (int e = 0; e < S::kVec; ++e) acc[e] = 0.f;
  float m = kFill;
  float l = 0.f;     // this lane's rows' share

  for (int i = 0, c = warp; c < nchunks; ++i, c += kWarps) {
    wg::cp_async_wait<S::kStages - 1>();   // chunk c has landed
    __syncwarp();                          // ... for every lane
    const uint8_t* st = ring + (i % S::kStages) * S::kStageBytes;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * S::kKVBytes);
    const uint8_t* allow = sAllow + c * kChunk;

    float s[S::kPasses];
    float cmax = -INFINITY;
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const int r = p * S::kRows + rg;
      const bool live = r < kChunk;
      float part = 0.f;
      if (live) {
        float kf[S::kVec];
        unpack<TKV>(st + r * S::kRowBytes + 16 * sub, kf);
#pragma unroll
        for (int e = 0; e < S::kVec; ++e) part += qr[e] * kf[e];
      }
#pragma unroll
      for (int o = S::kLanes / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kAll, part, o);
      float x = part * a.scale;
      if (QUANT && live) x *= ksc[r];
      if (live && !allow[r]) x = kFill;
      s[p] = live ? x : -INFINITY;         // -inf: no part in max or sums
      cmax = fmaxf(cmax, s[p]);
    }
#pragma unroll
    for (int o = 16; o >= S::kLanes; o >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(kAll, cmax, o));
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < S::kVec; ++e) acc[e] *= alpha;
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const int r = p * S::kRows + rg;
      if (r >= kChunk) continue;
      const float w = expf(s[p] - m_new);
      l += w;
      const float wv = QUANT ? w * ksc[kChunk + r] : w;
      float vf[S::kVec];
      unpack<TKV>(st + S::kKVBytes + r * S::kRowBytes + 16 * sub, vf);
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) acc[e] += wv * vf[e];
    }
    m = m_new;
    __syncwarp();                          // every lane is done with it
    load_chunk(c + kWarps * S::kStages, i % S::kStages);
  }
  wg::cp_async_wait<0>();

  // the warp's partials: sum l and acc over its row groups
#pragma unroll
  for (int o = 16; o >= S::kLanes; o >>= 1) {
    l += __shfl_xor_sync(kAll, l, o);
#pragma unroll
    for (int e = 0; e < S::kVec; ++e)
      acc[e] += __shfl_xor_sync(kAll, acc[e], o);
  }
  if (lane == 0) {
    sM[warp] = m;
    sL[warp] = l;
  }
  if (lane < S::kLanes) {
#pragma unroll
    for (int e = 0; e < S::kVec; ++e) sAcc[warp][sub * S::kVec + e] = acc[e];
  }
  __syncthreads();

  // merge the warps' partials; a warp that walked nothing holds
  // (FILL, 0, 0) and contributes nothing
  float big = kFill;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sM[w]);
  float f[kWarps];
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(sM[w] - big);
    total += sL[w] * f[w];
  }
  float out = 0.f;
  if (tid < DH) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) out += sAcc[w][tid] * f[w];
  }
  const size_t so = static_cast<size_t>(slot) * a.heads + h;
  if (nlive == 1) {
    if (tid < DH) a.acc[qh + tid] = out;
    if (tid == 0) {
      a.m[so] = big;
      a.l[so] = total;
    }
    return;
  }

  // several splits: this one's partials to the scratch; the last block of
  // the (slot, head) to finish merges them all
  float* mine = a.part + (static_cast<size_t>(bhid) * splits + split) *
                             (DH + 2);
  if (tid < DH) mine[tid] = out;
  if (tid == 0) {
    mine[DH] = big;
    mine[DH + 1] = total;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(a.counters + bhid, 1) == nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const float* all = a.part + static_cast<size_t>(bhid) * splits * (DH + 2);
  float gbig = kFill;
  for (int sp = 0; sp < nlive; ++sp)
    gbig = fmaxf(gbig, __ldcg(all + sp * (DH + 2) + DH));
  float gacc = 0.f, gl = 0.f;
  for (int sp = 0; sp < nlive; ++sp) {
    const float* p = all + sp * (DH + 2);
    const float fs = expf(__ldcg(p + DH) - gbig);
    gl += __ldcg(p + DH + 1) * fs;
    if (tid < DH) gacc += __ldcg(p + tid) * fs;
  }
  if (tid < DH) a.acc[qh + tid] = gacc;
  if (tid == 0) {
    a.m[so] = gbig;
    a.l[so] = gl;
    a.counters[bhid] = 0;           // zero again for the next launch
  }
}

// the prefix walk and the visible walk, as two kernels so that a profile
// tells them apart
template <typename TQ, typename TKV, int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  paged_decode_body<TQ, TKV, DH, QUANT, false>(a);
}

template <typename TQ, typename TKV, int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_visible_kernel(Args a) {
  paged_decode_body<TQ, TKV, DH, QUANT, true>(a);
}

template <typename TQ, typename TKV, int DH, bool QUANT>
cudaError_t launch(const Args& a, int b, int splits, cudaStream_t stream) {
  using S = Shape<TKV, DH>;
  auto kernel = a.visible ? paged_decode_visible_kernel<TQ, TKV, DH, QUANT>
                          : paged_decode_kernel<TQ, TKV, DH, QUANT>;
  const size_t smem = kWarps * S::kStages * S::kStageBytes +
                      2 * sizeof(int) * a.pages_per_split +
                      static_cast<size_t>(a.pages_per_split) * a.page_size;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(b * a.heads, splits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t by_dim(int dh, const Args& a, int b, int splits,
                   cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<TQ, TKV, 16, QUANT>(a, b, splits, stream);
    case 32: return launch<TQ, TKV, 32, QUANT>(a, b, splits, stream);
    case 64: return launch<TQ, TKV, 64, QUANT>(a, b, splits, stream);
    case 128: return launch<TQ, TKV, 128, QUANT>(a, b, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with ops/paged_attention.py: 0 float32, 1 bfloat16,
// 2 int8. Pointers are device pointers; every array is contiguous:
// q (b, heads, dh); k/v pages (P, heads, page_size, dh), 16-byte aligned;
// scales (P, heads, page_size) float32, 16-byte aligned (int8 pages only,
// else null); block_tables (b, max_pages) int32; pos (b,) int32; allowed
// (b, L) uint8; visible (b, width) int32 logical page ids and visible_cnt
// (b,) int32, both null for the prefix walk; acc (b, heads, dh), m and l
// (b, heads) float32. A split covers pages_per_split trips; the walk
// takes splits = ceil(max_pages (or width) / pages_per_split) of them,
// and when that is more than one, part is a (b, heads, splits, dh + 2)
// float32 scratch and counters a (b, heads) int32 array of zeros, which
// the launch leaves zero (launches sharing it must be ordered on one
// stream). Returns the CUDA error of the launch (0 on success); the launch
// is asynchronous on `stream`.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* pos, const void* allowed, const void* visible,
    const void* visible_cnt, void* acc, void* m, void* l, void* part,
    void* counters, int b, int heads, int dh, int page_size, int max_pages,
    int L, int width, int pages_per_split, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if ((visible == nullptr) != (visible_cnt == nullptr) ||
      (visible != nullptr && (width < 1 || width > max_pages)) ||
      page_size < kChunk || page_size % kChunk != 0 || pages_per_split < 1 ||
      pages_per_split > kThreads ||
      b < 1 || heads < 1 || max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int walk = visible ? width : max_pages;
  const int splits = (walk + pages_per_split - 1) / pages_per_split;
  if (splits > 65535 || (splits > 1 && (part == nullptr ||
                                        counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
         static_cast<const float*>(v_scales),
         static_cast<const int*>(block_tables), static_cast<const int*>(pos),
         static_cast<const uint8_t*>(allowed),
         static_cast<const int*>(visible),
         static_cast<const int*>(visible_cnt), static_cast<float*>(acc),
         static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(part), static_cast<int*>(counters), heads,
         page_size, max_pages, L, width, pages_per_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = by_dim<float, float, false>(dh, a, b, splits, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = by_dim<__nv_bfloat16, __nv_bfloat16, false>(dh, a, b, splits, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = by_dim<float, int8_t, true>(dh, a, b, splits, s);
  else if (q_dtype == 1 && kv_dtype == 2)
    err = by_dim<__nv_bfloat16, int8_t, true>(dh, a, b, splits, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
