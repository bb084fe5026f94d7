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
//   * scores and accumulation in f32;
//   * any dh from 1 to 128: the body is compiled for dh 16, 32, 64 and
//     128, and another dh runs on the next of those widths with the real
//     dh passed at run time (the EXACT = false bodies): rows are read at
//     stride dh, lanes past dh hold zero, acc is written at width dh. A
//     chunk's K (or V) rows are one contiguous run of 8 dh elements, so
//     they still arrive by 16-byte copies when that run's length is a
//     multiple of 16 bytes, by 8-byte copies otherwise;
//   * dh 129 to 256 with bfloat16 or int8 pages: the same body compiled
//     for dh 256 (paged_decode_wide_split_kernel and its visible twin,
//     paged_decode_visible_wide_split_kernel; dh below 256 read at stride
//     dh, as above), with shorter splits (see "Wide heads" below);
//   * float32 pages above dh 128, and any dh above 256: the CUDA-core wide
//     body (paged_decode_wide_kernel, below), one slice of 128 acc columns
//     a block.
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
//
// Wide heads (128 < dh <= 256, bfloat16 or int8 pages). The TPU kernel's
// block is one (slot, head) over the whole head; so is this body's: a
// block owns a (slot, head, split) over all dh columns, so each K row is
// read once and each score computed once. Decode attention stays one query
// against the cache, ~2 flops a byte with no K/V shared across heads to
// batch, so the tensor cores have nothing to do: the design is about bytes
// in flight and the grid's fill.
//   * A lane holds 16 bytes of q and of acc: at bfloat16 dh 256, 32 lanes
//     of 8 elements, one row a pass (8 passes a chunk), its score reduced
//     over the whole warp; at int8, 16 lanes of 16, two rows a pass. dh
//     129 to 255 runs the dh-256 body with rows at stride dh (24 lanes at
//     bfloat16 dh 192 would break the power-of-two reductions); the copies
//     still move only the real bytes.
//   * Copies: an 8-row chunk's K and V (4 KB each at bfloat16 dh 256,
//     one contiguous run of the pool each) arrive by two 1-D bulk copies
//     (cp.async.bulk, Hopper's TMA without a tensor map) that one lane
//     issues against the stage's mbarrier, in a ring of 2 stages a warp:
//     4 warps x 2 x 8 KB = 64 KB, three blocks an SM, every chunk of a
//     4-page split in flight at once. (Every lane's 16-byte cp.async, as
//     the narrow bodies copy, was slower in the same run.)
//   * Split size (ops/paged_attention.py::pages_per_split, WIDE_SPLIT_ROWS
//     = 64 rows, 4 pages of 16): at 2 heads a serve step has few (slot,
//     head) pairs. Late in a request, 6 live slots near pos 1,100 (~69
//     pages each) x 2 heads give 12 x ceil(69 / 16) = 60 blocks at the
//     narrow 16 pages a split, under half of the 132 SMs, each walking
//     256 KB; 4 pages a split give 12 x 18 = 216 blocks of 64 KB, more
//     than one an SM. The merge of the longest slot's splits (20 at pos
//     1,279) reads 20 x 258 floats in the last block.
//   * Bound: bytes, the same 6.2 MB as the narrow dh-64 case at the
//     smoke's 8 slots (2 heads x 256 = 8 x 64): 1.85 us at 3.35 TB/s.
//   * The merge loops over dh in steps of the block's 128 threads.

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
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// 1-D bulk copies (Hopper's TMA without a tensor map): one thread arms a
// stage's mbarrier with the bytes it expects and issues the copies, which
// complete on it; the warp waits on the barrier's phase
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// until the barrier has completed the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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

// this lane's piece of a staged row: its 16 bytes (elements sub * N ..
// sub * N + N - 1) as N = 16 / sizeof(T) floats; with EXACT false the row
// is dh elements wide, fewer than the width compiled for, and elements at
// or past dh read as 0
template <typename T, int N, bool EXACT>
__device__ __forceinline__ void row_piece(const uint8_t* row, int sub, int dh,
                                          float (&f)[N]) {
  if constexpr (EXACT) {
    unpack<T>(row + 16 * sub, f);
  } else if (dh % N == 0) {         // rows start on 16 bytes: whole pieces
    if (sub * N < dh) {
      unpack<T>(row + 16 * sub, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
  } else {
    const T* p = reinterpret_cast<const T*>(row) + sub * N;
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = sub * N + e < dh ? to_f(p[e]) : 0.f;
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
  int heads, dh, page_size, max_pages, L, width, pages_per_split;
  float scale;
};

// the body of both walks; VISIBLE selects the visible-page list. DH is
// the width compiled for: the head dim itself when EXACT, else the next
// width up, with the head dim a.dh < DH
template <typename TQ, typename TKV, int DH, bool QUANT, bool VISIBLE,
          bool EXACT>
__device__ __forceinline__ void paged_decode_body(const Args& a) {
  using S = Shape<TKV, DH>;
  const int dh = EXACT ? DH : a.dh;
  const int row_bytes = EXACT ? S::kRowBytes
                              : dh * static_cast<int>(sizeof(TKV));
  const int kv_bytes = kChunk * row_bytes;     // a chunk's K (or V) rows
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
  const size_t qh = (static_cast<size_t>(slot) * a.heads + h) * dh;
  const TQ* q = static_cast<const TQ*>(a.q) + qh + sub * S::kVec;
  float qr[S::kVec];
#pragma unroll
  for (int e = 0; e < S::kVec; ++e)
    qr[e] = EXACT || sub * S::kVec + e < dh ? to_f(q[e]) : 0.f;
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
  // the wide split body (DH 256) takes a chunk's K and V runs (and the
  // int8 scales) by bulk copies, issued by lane 0 against an mbarrier a
  // stage, where their length allows (a multiple of 16 bytes: every dh at
  // bfloat16, even dh at int8); the narrow bodies by cp.async from every
  // lane
  const bool bulk = DH > 128 && kv_bytes % 16 == 0;
  __shared__ __align__(8) uint64_t sBar[kWarps][S::kStages];
  if (bulk) {
    if (lane == 0) {
#pragma unroll
      for (int st = 0; st < S::kStages; ++st)
        mbar_init(wg::smem_addr(&sBar[warp][st]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  // chunk c of the split into stage `stage` of this warp's ring: one copy
  // group, maybe empty, or (bulk) one phase of the stage's barrier
  auto load_chunk = [&](int c, int stage) {
    if (c < nchunks) {
      // first row of the chunk in the pool (P, heads, page_size, dh)
      const size_t row0 =
          (static_cast<size_t>(sPage[c / per_page]) * a.heads + h) * ps +
          (c % per_page) * kChunk;
      const uint32_t dst = wg::smem_addr(ring + stage * S::kStageBytes);
      const uint8_t* ksrc = kp + row0 * row_bytes;
      const uint8_t* vsrc = vp + row0 * row_bytes;
      if (bulk) {
        if (lane == 0) {
          const uint32_t bar = wg::smem_addr(&sBar[warp][stage]);
          // the warp's reads of the stage's last chunk (generic proxy)
          // before the copies' writes (async proxy)
          wg::fence_async_shared();
          mbar_expect(bar, 2 * kv_bytes + (QUANT ? 2 * kChunk * 4 : 0));
          bulk_copy(dst, ksrc, kv_bytes, bar);
          bulk_copy(dst + S::kKVBytes, vsrc, kv_bytes, bar);
          if (QUANT) {
            bulk_copy(dst + 2 * S::kKVBytes, a.k_scales + row0, kChunk * 4,
                      bar);
            bulk_copy(dst + 2 * S::kKVBytes + kChunk * 4, a.v_scales + row0,
                      kChunk * 4, bar);
          }
        }
      } else if (EXACT || kv_bytes % 16 == 0) {
        for (int i = lane; i < kv_bytes / 16; i += 32) {
          wg::cp_async16(dst + 16 * i, ksrc + 16 * i, true);
          wg::cp_async16(dst + S::kKVBytes + 16 * i, vsrc + 16 * i, true);
        }
      } else {                        // 8 dh elements: a multiple of 8 bytes
        for (int i = lane; i < kv_bytes / 8; i += 32) {
          wg::cp_async8(dst + 8 * i, ksrc + 8 * i);
          wg::cp_async8(dst + S::kKVBytes + 8 * i, vsrc + 8 * i);
        }
      }
      if (QUANT && !bulk && lane < 4) {
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
    if (bulk)                              // chunk c has landed
      mbar_wait(wg::smem_addr(&sBar[warp][i % S::kStages]),
                (i / S::kStages) & 1);
    else
      wg::cp_async_wait<S::kStages - 1>();
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
        row_piece<TKV, S::kVec, EXACT>(st + r * row_bytes, sub, dh, kf);
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
      row_piece<TKV, S::kVec, EXACT>(st + S::kKVBytes + r * row_bytes, sub,
                                     dh, vf);
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
  // acc columns a thread merges: column tid + kThreads * j
  constexpr int kCols = (DH + kThreads - 1) / kThreads;
  float out[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = tid + kThreads * j;
    out[j] = 0.f;
    if (col < DH) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) out[j] += sAcc[w][col] * f[w];
    }
  }
  const size_t so = static_cast<size_t>(slot) * a.heads + h;
  if (nlive == 1) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (tid + kThreads * j < dh) a.acc[qh + tid + kThreads * j] = out[j];
    if (tid == 0) {
      a.m[so] = big;
      a.l[so] = total;
    }
    return;
  }

  // several splits: this one's partials to the scratch; the last block of
  // the (slot, head) to finish merges them all
  float* mine = a.part + (static_cast<size_t>(bhid) * splits + split) *
                             (dh + 2);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (tid + kThreads * j < dh) mine[tid + kThreads * j] = out[j];
  if (tid == 0) {
    mine[dh] = big;
    mine[dh + 1] = total;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(a.counters + bhid, 1) == nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const float* all = a.part + static_cast<size_t>(bhid) * splits * (dh + 2);
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
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (tid + kThreads * j < dh) a.acc[qh + tid + kThreads * j] = gacc[j];
  if (tid == 0) {
    a.m[so] = gbig;
    a.l[so] = gl;
    a.counters[bhid] = 0;           // zero again for the next launch
  }
}

// the prefix walk and the visible walk, as two kernels so that a profile
// tells them apart
template <typename TQ, typename TKV, int DH, bool QUANT, bool EXACT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  paged_decode_body<TQ, TKV, DH, QUANT, false, EXACT>(a);
}

template <typename TQ, typename TKV, int DH, bool QUANT, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_visible_kernel(Args a) {
  paged_decode_body<TQ, TKV, DH, QUANT, true, EXACT>(a);
}

// the same body for 128 < dh <= 256 (bfloat16 or int8 pages), named apart
// from the narrow walks and from the CUDA-core wide body
template <typename TQ, typename TKV, bool QUANT, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_wide_split_kernel(Args a) {
  paged_decode_body<TQ, TKV, 256, QUANT, false, EXACT>(a);
}

template <typename TQ, typename TKV, bool QUANT, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_visible_wide_split_kernel(Args a) {
  paged_decode_body<TQ, TKV, 256, QUANT, true, EXACT>(a);
}

template <typename TQ, typename TKV, int DH, bool QUANT, bool EXACT>
cudaError_t launch(const Args& a, int b, int splits, cudaStream_t stream) {
  using S = Shape<TKV, DH>;
  void (*kernel)(Args);
  if constexpr (DH > 128) {
    if (a.visible)
      kernel = paged_decode_visible_wide_split_kernel<TQ, TKV, QUANT, EXACT>;
    else
      kernel = paged_decode_wide_split_kernel<TQ, TKV, QUANT, EXACT>;
  } else
    kernel = a.visible ? paged_decode_visible_kernel<TQ, TKV, DH, QUANT, EXACT>
                       : paged_decode_kernel<TQ, TKV, DH, QUANT, EXACT>;
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

// ---------------------------------------------------------------------------
// wide heads on CUDA cores: float32 pages above dh 128, any dh above 256
// ---------------------------------------------------------------------------
//
// A float32 row wider than 128 elements, or any row wider than 256, does
// not fit the split body's lanes (one lane's 16 bytes, at most 32 lanes a
// row), and q and acc would grow with dh. So a block owns one (slot x
// head, split) and a slice of at most kWideSlice acc columns (grid axis
// z): q waits in shared
// memory as f32; each warp takes the split's rows round-robin, scores a
// row over the whole head (lanes striding dh, a warp reduction), runs the
// online softmax in registers and adds its slice of the V row, 4 columns
// a lane. The warps merge as the narrow body's do; the splits merge
// through `part` (b * heads, slices, splits, kWideSlice + 2) with one
// counter a (slot, head, slice), reset by the last block. Every slice
// recomputes the scores; slice 0 writes m and l.
constexpr int kWideSlice = kThreads;         // acc columns a block owns

template <typename TQ, typename TKV, bool QUANT, bool VISIBLE>
__global__ void __launch_bounds__(kThreads) paged_decode_wide_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sAcc[kWarps][kWideSlice];
  __shared__ float sM[kWarps];
  __shared__ float sL[kWarps];
  __shared__ int sLast;

  const int bhid = blockIdx.x;
  const int slot = bhid / a.heads;
  const int h = bhid % a.heads;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int slice = blockIdx.z;
  const int dh = a.dh;
  const int c0 = slice * kWideSlice;
  const int width = min(kWideSlice, dh - c0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ps = a.page_size;
  const int pps = a.pages_per_split;

  const int walk_len = VISIBLE ? a.visible_cnt[slot] : a.pos[slot];
  const int trips = VISIBLE ? walk_len : (walk_len + ps - 1) / ps;
  const int nlive = max(1, (trips + pps - 1) / pps);
  if (split >= nlive) return;                 // past the walk: reads no page
  const int first = split * pps;
  const int npages = max(0, min(pps, trips - first));

  float* sq = reinterpret_cast<float*>(smem);             // q, dh floats
  int* sPage = reinterpret_cast<int*>(sq + dh);            // pps page ids
  int* sLogical = sPage + pps;
  const size_t qh = (static_cast<size_t>(slot) * a.heads + h) * dh;
  const TQ* qp = static_cast<const TQ*>(a.q) + qh;
  for (int e = tid; e < dh; e += kThreads) sq[e] = to_f(qp[e]);
  if (tid < npages) {
    const int lp = VISIBLE ? a.visible[static_cast<size_t>(slot) * a.width +
                                       first + tid]
                           : first + tid;
    sLogical[tid] = lp;
    sPage[tid] = a.block_tables[static_cast<size_t>(slot) * a.max_pages + lp];
  }
  __syncthreads();

  const uint8_t* allow_row = a.allowed + static_cast<size_t>(slot) * a.L;
  const TKV* kp = static_cast<const TKV*>(a.k_pages);
  const TKV* vp = static_cast<const TKV*>(a.v_pages);
  constexpr int kPer = kWideSlice / 32;       // acc columns a lane
  float acc[kPer];
#pragma unroll
  for (int jj = 0; jj < kPer; ++jj) acc[jj] = 0.f;
  float m = kFill;
  float l = 0.f;                              // the same in every lane
  for (int i = warp; i < npages * ps; i += kWarps) {
    const int pg = i / ps;
    const int off = i % ps;
    const int j = sLogical[pg] * ps + off;   // the row's logical position
    const size_t row0 =
        (static_cast<size_t>(sPage[pg]) * a.heads + h) * ps + off;
    const TKV* krow = kp + row0 * dh;
    float part = 0.f;
    for (int e = lane; e < dh; e += 32) part += sq[e] * to_f(krow[e]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kAll, part, o);
    float x = part * a.scale;
    if (QUANT) x *= a.k_scales[row0];
    if (!(j < a.L && allow_row[j])) x = kFill;
    const float m_new = fmaxf(m, x);
    const float alpha = expf(m - m_new);
    const float w = expf(x - m_new);
    l = l * alpha + w;
    const float wv = QUANT ? w * a.v_scales[row0] : w;
    const TKV* vrow = vp + row0 * dh + c0;
#pragma unroll
    for (int jj = 0; jj < kPer; ++jj) {
      const int c = lane + 32 * jj;
      acc[jj] = acc[jj] * alpha + (c < width ? wv * to_f(vrow[c]) : 0.f);
    }
    m = m_new;
  }

  // merge the warps' partials; a warp that walked nothing holds
  // (FILL, 0, 0) and contributes nothing
  if (lane == 0) {
    sM[warp] = m;
    sL[warp] = l;
  }
#pragma unroll
  for (int jj = 0; jj < kPer; ++jj) sAcc[warp][lane + 32 * jj] = acc[jj];
  __syncthreads();
  float big = kFill;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sM[w]);
  float out = 0.f, total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(sM[w] - big);
    total += sL[w] * f;
    out += sAcc[w][tid] * f;
  }
  const size_t so = static_cast<size_t>(slot) * a.heads + h;
  if (nlive == 1) {
    if (tid < width) a.acc[qh + c0 + tid] = out;
    if (tid == 0 && slice == 0) {
      a.m[so] = big;
      a.l[so] = total;
    }
    return;
  }

  // several splits: this one's partials to the scratch; the last block of
  // the (slot, head, slice) to finish merges them all
  const size_t cell = static_cast<size_t>(bhid) * gridDim.z + slice;
  float* mine = a.part + (cell * splits + split) * (kWideSlice + 2);
  mine[tid] = out;
  if (tid == 0) {
    mine[kWideSlice] = big;
    mine[kWideSlice + 1] = total;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(a.counters + cell, 1) == nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const float* all = a.part + cell * splits * (kWideSlice + 2);
  float gbig = kFill;
  for (int sp = 0; sp < nlive; ++sp)
    gbig = fmaxf(gbig, __ldcg(all + sp * (kWideSlice + 2) + kWideSlice));
  float gacc = 0.f, gl = 0.f;
  for (int sp = 0; sp < nlive; ++sp) {
    const float* p = all + sp * (kWideSlice + 2);
    const float fs = expf(__ldcg(p + kWideSlice) - gbig);
    gl += __ldcg(p + kWideSlice + 1) * fs;
    gacc += __ldcg(p + tid) * fs;
  }
  if (tid < width) a.acc[qh + c0 + tid] = gacc;
  if (tid == 0) {
    if (slice == 0) {
      a.m[so] = gbig;
      a.l[so] = gl;
    }
    a.counters[cell] = 0;           // zero again for the next launch
  }
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_wide(const Args& a, int b, int splits,
                        cudaStream_t stream) {
  auto kernel = a.visible ? paged_decode_wide_kernel<TQ, TKV, QUANT, true>
                          : paged_decode_wide_kernel<TQ, TKV, QUANT, false>;
  const size_t smem = sizeof(float) * static_cast<size_t>(a.dh) +
                      2 * sizeof(int) * a.pages_per_split;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int slices = (a.dh + kWideSlice - 1) / kWideSlice;
  kernel<<<dim3(b * a.heads, splits, slices), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dh 16, 32, 64 and 128 run their own bodies; any other dh up to 128 the
// body of the next of those widths, reading rows at stride dh; a wider dh
// the wide split body (dh <= 256, bfloat16 or int8 pages) when the caller
// asks for it (wide_split), else the CUDA-core wide body
template <typename TQ, typename TKV, bool QUANT>
cudaError_t by_dim(int dh, bool wide_split, const Args& a, int b, int splits,
                   cudaStream_t stream) {
  if (wide_split) {
    if constexpr (sizeof(TKV) < 4) {
      if (dh == 256) return launch<TQ, TKV, 256, QUANT, true>(a, b, splits,
                                                             stream);
      if (dh > 128 && dh < 256)
        return launch<TQ, TKV, 256, QUANT, false>(a, b, splits, stream);
    }
    return cudaErrorInvalidValue;    // no split body for this dh or dtype
  }
  switch (dh) {
    case 16: return launch<TQ, TKV, 16, QUANT, true>(a, b, splits, stream);
    case 32: return launch<TQ, TKV, 32, QUANT, true>(a, b, splits, stream);
    case 64: return launch<TQ, TKV, 64, QUANT, true>(a, b, splits, stream);
    case 128: return launch<TQ, TKV, 128, QUANT, true>(a, b, splits, stream);
    default: break;
  }
  if (dh < 1) return cudaErrorInvalidValue;
  if (dh > 128) return launch_wide<TQ, TKV, QUANT>(a, b, splits, stream);
  if (dh < 16) return launch<TQ, TKV, 16, QUANT, false>(a, b, splits, stream);
  if (dh < 32) return launch<TQ, TKV, 32, QUANT, false>(a, b, splits, stream);
  if (dh < 64) return launch<TQ, TKV, 64, QUANT, false>(a, b, splits, stream);
  return launch<TQ, TKV, 128, QUANT, false>(a, b, splits, stream);
}

}  // namespace

// dtype codes shared with ops/paged_attention.py: 0 float32, 1 bfloat16,
// 2 int8. Pointers are device pointers; every array is contiguous:
// q (b, heads, dh), dh >= 1; k/v pages (P, heads, page_size, dh),
// 16-byte aligned;
// scales (P, heads, page_size) float32, 16-byte aligned (int8 pages only,
// else null); block_tables (b, max_pages) int32; pos (b,) int32; allowed
// (b, L) uint8; visible (b, width) int32 logical page ids and visible_cnt
// (b,) int32, both null for the prefix walk; acc (b, heads, dh), m and l
// (b, heads) float32. A split covers pages_per_split trips; the walk
// takes splits = ceil(max_pages (or width) / pages_per_split) of them,
// and when that is more than one, part is a float32 scratch of
// (b, heads, splits, dh + 2) for dh <= 128 and for the wide split body,
// (b, heads, slices, splits, 130) for the CUDA-core wide body (slices =
// ceil(dh / 128)), and counters an int32 array of zeros, (b, heads) or
// (b, heads, slices), which
// the launch leaves zero (launches sharing it must be ordered on one
// stream). wide_split 1 asks for the wide split body, which takes 128 < dh
// <= 256 with bfloat16 or int8 pages and is refused (cudaErrorInvalidValue)
// for anything else; 0 sends dh above 128 to the CUDA-core wide body.
// Returns the CUDA error of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* pos, const void* allowed, const void* visible,
    const void* visible_cnt, void* acc, void* m, void* l, void* part,
    void* counters, int b, int heads, int dh, int page_size, int max_pages,
    int L, int width, int pages_per_split, float scale, int q_dtype,
    int kv_dtype, int wide_split, void* stream) {
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
         static_cast<float*>(part), static_cast<int*>(counters), heads, dh,
         page_size, max_pages, L, width, pages_per_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = by_dim<float, float, false>(dh, wide_split, a, b, splits, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = by_dim<__nv_bfloat16, __nv_bfloat16, false>(dh, wide_split, a, b,
                                                        splits, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = by_dim<float, int8_t, true>(dh, wide_split, a, b, splits, s);
  else if (q_dtype == 1 && kv_dtype == 2)
    err = by_dim<__nv_bfloat16, int8_t, true>(dh, wide_split, a, b, splits,
                                                s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
