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
//     the running max is not finite; p is rounded to the input dtype
//     before the PV product (the TPU kernel's p.astype(vb.dtype)), l sums
//     the unrounded p; out = acc / l with a zero l taken as 1; m is
//     written as 0 where it is not finite; m and l are f32.
// This contract differs from the flash kernels' (K1): there the max starts
// at FILL and pad queries are masked too.
//
// Bound: bytes. At the north training shapes (b 8, h 8, n 1280, d 64,
// block 16, window 4 blocks, global block 0, causal) a row sees at most
// 80 keys: ~61 k allowed pairs per (b, h), ~1.0 GFLOP of products against
// ~42.6 MB of q, k, v, out, m and l in bf16 (12.7 us at 3.35 TB/s) -- ~24
// flops per byte, far below the ~295 at which the tensor cores would set
// the pace. Both bodies visit only the key tiles that the layout makes
// live for a 64-row query tile (tile_any): at the default layout the
// global tile 0 and the diagonal tile, 2 of up to 20 (~2,500 tile pairs
// in all against K1's 13,440), so per-tile latency, not products or
// bytes, sets the time.
//
// bf16 (block_sparse_fwd_wgmma_kernel): tensor cores, on wgmma.cuh, one
// warpgroup of 128 threads per (b*h, 64-row query tile). With the
// products this cheap, what is left is per-tile work outside them, so:
//   * the live tiles are computed, not searched for: QueryTile works out
//     once the key tiles its rows' windows span and jumps from one live
//     tile to the next (the global tiles, then the window tiles), where a
//     scan testing the dead tiles between them took 40 % of the time on
//     an H100;
//   * copies up front: Q and the K, V tiles of the first kLive = 2 live
//     key tiles are issued at once as 16-byte cp.async copies into the
//     128-byte swizzle, so the second tile's copy runs under the first
//     tile's products (a layout with more live tiles refills a stage as
//     soon as the product that read it has completed); the pad flags of
//     each tile are loaded two tiles ahead;
//   * products: S = Q K^T as wgmma m64n64k16 from shared memory; P rounded
//     to bf16 in registers is the A operand of O += P V (m64n{d}k16), and
//     the next tile's S is issued while that product runs;
//   * the layout test leaves the element loop: tile_mask decides once per
//     tile which columns every row may see (the global columns of a tile
//     outside the window, every column of a tile inside the rows' one
//     window) and whether the causal diagonal, a window boundary (windows
//     that do not hold the 64-row tile: block 8, or 48-token windows) or
//     pad keys cut it; a cut tile turns them into one 64-bit mask per row
//     and applies it with a bit test and a select per element;
//   * 42 KB of shared memory and at most 128 registers a thread at d 64,
//     so 4 blocks share an SM and the 1,280 query tiles of the north
//     shapes run in 2.4 waves (82 KB at d 128).
// wide heads, d > 128, bf16 at d 192 and 256
// (block_sparse_fwd_wide_wgmma_kernel): the same body, at d 256 in two
// warpgroups that each compute S and hold half of O (m64n128k16 output
// products; one warpgroup holding all of O spills), at d 192 in one
// (m64n192k16); 160 KB of shared memory at d 256, so one block an SM,
// and the 320 query tiles of b 8, h 2, n 1280 run in 2.4 waves. Every other wide call (block_sparse_fwd_wide_kernel, f32, and
// bf16 above 256): a block owns a slice of at most 128 output columns and
// streams S over the whole head in 64-column chunks, as the flash
// kernels' CUDA-core wide bodies do (tile.cuh); the wrapper pads d to a
// multiple of 64.
// float32 (block_sparse_fwd_kernel): CUDA cores, the tile, staging and
// products of tile.cuh shared with flash_attention.cu (a 16 x 16 thread
// grid, each thread owning 4 rows and 4 columns of every 64 x 64 score
// tile, tiles in shared memory as f32 with a padded row stride, FMAs), so
// float32 keeps full f32 products; it tests every key tile with tile_any
// and the layout per element, at a cost that the f32 products dwarf.

#include <math.h>
#include <stdint.h>

#include "tile.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores (wgmma.cuh)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using wg::aligned_smem;
using wg::hold_frags;
using wg::kLog2e;
using wg::mma_rs;
using wg::zero;

// K/V stages in shared memory: the live key tiles issued at once (a query
// tile of the default layout has two)
constexpr int kLive = 2;
static_assert(kLive >= 2, "the copy-group count below needs two stages");
// blocks an SM: at d 64, 4 (128 registers a thread, 42 KB of shared
// memory each), which ptxas reaches without spilling; at d 128 the
// accumulators need more registers than 4 blocks leave
template <int D>
constexpr int kBlocksPerSM = D == 64 ? 4 : 1;
// warpgroups a block, splitting O's columns: two at d 256 (the wide
// kernel says why), one at every other width
template <int D>
constexpr int kGroups = D == 256 ? 2 : 1;

// The layout as seen from one 64-row query tile, worked out once per
// block: the key tokens its rows' windows span, and from them the live
// key tiles, found without scanning the dead ones between them (a scan
// calling tile_any for each of up to 19 dead tiles cost more than the
// tiles' products). Global blocks are read with constant indices, so the
// layout stays in the kernel's parameters.
struct QueryTile {
  int q0, q_hi, n;
  int win_start, win_end;  // key tokens of the windows of rows q0 .. q_hi
  bool one_window;         // those rows share one window
  int tile_lo, tile_hi;    // the key tiles the windows span
  int num_k;               // key tiles up to the causal diagonal

  __device__ __forceinline__ QueryTile(const Layout& L, int q0_, int n_)
      : q0(q0_), q_hi(min(q0_ + kTile, n_) - 1), n(n_) {
    const int w_lo = q0 / L.window, w_hi = q_hi / L.window;
    one_window = w_lo == w_hi;
    win_start = w_lo * L.window;
    win_end = min(w_hi * L.window + L.window, n) - 1;
    tile_lo = win_start / kTile;
    tile_hi = win_end / kTile;
    num_k = L.causal ? q_hi / kTile + 1 : (n + kTile - 1) / kTile;
  }

  // the first live key tile at or after ik (num_k if none): a window
  // tile or one holding a global block's tokens (tile_any's tiles)
  __device__ __forceinline__ int next_live(const Layout& L, int ik) const {
    int best = ik <= tile_hi ? max(ik, tile_lo) : num_k;
#pragma unroll
    for (int g = 0; g < kMaxGlobals; ++g) {
      if (g >= L.num_globals) break;
      const int lo = L.globals[g] * L.block;
      if ((lo + L.block - 1) / kTile >= ik)
        best = min(best, max(ik, lo / kTile));
    }
    return min(best, num_k);
  }
};

// bit i of a 64-bit word set for i < count (count in [0, 64])
__device__ __forceinline__ uint64_t low_bits(int count) {
  return count >= 64 ? ~0ull : (1ull << count) - 1;
}

// bits lo .. hi - 1 of a 64-bit word (each end clamped to [0, 64])
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  return low_bits(min(max(hi, 0), 64)) & ~low_bits(min(max(lo, 0), 64));
}

// The layout over one (64-row query tile, 64-column key tile) pair,
// decided once for the tile (the same in every thread): `cols` holds the
// columns every row may see (bit c: column k0 + c), `valid` those inside
// the sequence; a row may also see the columns of its own window where
// `window_cut` says a window boundary cuts the pair, and none of its
// future where `causal_cut` says the causal diagonal does.
struct TileMask {
  uint64_t cols;
  uint64_t valid;
  bool window_cut;
  bool causal_cut;
};

__device__ __forceinline__ TileMask tile_mask(const Layout& L,
                                              const QueryTile& qt, int k0) {
  const int k_hi = min(k0 + kTile, qt.n) - 1;
  TileMask tm;
  tm.valid = low_bits(qt.n - k0);
  tm.causal_cut = L.causal && k0 + kTile - 1 > qt.q0;
  if (qt.one_window && k0 >= qt.win_start && k_hi <= qt.win_end) {
    tm.cols = tm.valid;              // one window holds every pair
    tm.window_cut = false;
    return tm;
  }
  uint64_t glob = 0;                 // outside the window: global columns
#pragma unroll
  for (int g = 0; g < kMaxGlobals; ++g) {
    if (g >= L.num_globals) break;
    const int lo = max(L.globals[g] * L.block - k0, 0);
    const int hi = min(L.globals[g] * L.block + L.block - k0, kTile);
    if (lo < hi) glob |= low_bits(hi - lo) << lo;
  }
  tm.cols = glob & tm.valid;
  tm.window_cut = k0 <= qt.win_end && k_hi >= qt.win_start;
  return tm;
}

// G warpgroups per (b*h, 64-row query tile): Q resident, the live key
// tiles through kLive stages issued up front. Each warpgroup computes the
// tile's S = Q K^T and P itself and O += P V for its D / G output columns;
// each tile's S is issued while the last tile's O += P V still runs. The
// narrow (d 64, 128; G = 1) and wide (d 192, 256) kernels below run this
// body.
template <int D, int G>
__device__ __forceinline__ void bs_fwd_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int h, int n, float scale,
    const Layout& layout) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t kT = wg::tile_bytes<D>();
  constexpr int kNT = G * wg::kThreads;
  constexpr int kCols = D / G;                    // this warpgroup's O
  // the wide body waits for each tile's O += P V within its iteration, so
  // that P's fragments are not held under the next tile's S: 2-7 % faster
  // at d 256 on the H100 than running it under the next S, as the narrow
  // body does (chip_flash_variants.py, k3_pv_under_next_s)
  constexpr bool kWaitPV = D > 128;
  const uint32_t sQ = aligned_smem(smem_raw);
  const uint32_t sK = sQ + kT;                    // kLive tiles
  const uint32_t sV = sK + kLive * kT;            // kLive tiles

  const int tid = threadIdx.x;
  const int grp = tid / wg::kThreads;
  const int warp = tid % wg::kThreads / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;
  const QueryTile qt(layout, q0, n);
  const int num_k = qt.num_k;
  auto next_live = [&](int ik) { return qt.next_live(layout, ik); };
  auto load_keys = [&](int ik, int stage) {
    wg::load_tile<D, kNT>(sK + stage * kT, kh, ik * kTile, n, tid);
    wg::load_tile<D, kNT>(sV + stage * kT, vh, ik * kTile, n, tid);
  };

  // copy groups: Q with live tile 0, then live tiles 1 .. kLive - 1 (empty
  // groups where there are fewer); iteration it >= 1 commits one more
  wg::load_tile<D, kNT>(sQ, q + base, q0, n, tid);
  int issue = next_live(0);
#pragma unroll
  for (int stage = 0; stage < kLive; ++stage) {
    if (issue < num_k) {
      load_keys(issue, stage);
      issue = next_live(issue + 1);
    }
    wg::cp_async_commit();
  }

  int row[2], win_lo[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + 16 * warp + g + 8 * hh;
    win_lo[hh] = row[hh] / layout.window * layout.window;
  }
  float o[kCols / 2];
  zero(o);
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};  // l_i: lane's
  uint32_t pa[4][4];                                   // P of the last tile
  // live tiles ik and ik_next, and their pad flags, loaded two tiles
  // ahead of their use so that no load waits on the critical path
  int ik = next_live(0);
  int ik_next = next_live(ik + 1);
  auto pad_flags = [&](int it) {
    return mask_row && it < num_k
               ? wg::mask_flags(mask_row, it * kTile, n, lane) : 3u;
  };
  uint32_t kflags = pad_flags(ik), kflags_next = pad_flags(ik_next);

  for (int it = 0; ik < num_k; ++it) {
    if (it == 0)
      wg::cp_async_wait<kLive - 1>();   // Q and live tile 0 have landed
    else
      wg::cp_async_wait<kLive - 2>();   // live tile `it` has landed
    wg::fence_async_shared();
    __syncthreads();
    const int stage = it % kLive;
    const int k0 = ik * kTile;
    const uint64_t kbits = mask_row ? wg::mask_bits(kflags) : ~0ull;
    const int ik_after = next_live(ik_next + 1);
    kflags = kflags_next;
    kflags_next = pad_flags(ik_after);
    const uint32_t tK = sK + stage * kT;
    const uint32_t tV = sV + stage * kT;

    float s[32];
    zero(s);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, wg::desc_k(sQ, kk), wg::desc_k(tK, kk), kk > 0);
    wg::mma_commit();
    wg::mma_wait<0>();                // S, and the last tile's O += P V
    wg::hold(s);
    wg::hold(o);
    if constexpr (!kWaitPV) hold_frags(pa);
    if (it > 0) {                     // live tile it - 1's stage is free
      if (issue < num_k) {
        __syncthreads();              // every warp is past its products
        load_keys(issue, (it - 1) % kLive);
        issue = next_live(issue + 1);
      }
      wg::cp_async_commit();
    }

    // the layout, decided for the tile; per element only where the
    // diagonal, a window boundary or a pad key cuts it (warp-uniform)
    const TileMask tm = tile_mask(layout, qt, k0);
    const bool pad = mask_row != nullptr && (kbits & tm.valid) != tm.valid;
    if (tm.cols == ~0ull && !tm.window_cut && !tm.causal_cut && !pad) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    } else {
      // this lane's columns 2 t + 8 j + e as bits 8 j + e: the allowed
      // ones of each of its two rows, and the pad keys, as bit masks
      const int c0 = k0 + 2 * t;
      const uint64_t pb = kbits >> (2 * t);
      uint64_t allow[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        allow[hh] = tm.cols >> (2 * t);
        if (tm.window_cut)
          allow[hh] |= (tm.valid >> (2 * t)) &
                       bit_range(win_lo[hh] - c0,
                                 win_lo[hh] + layout.window - c0);
        if (tm.causal_cut) allow[hh] &= bit_range(0, row[hh] - c0 + 1);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bit = 8 * j + e;
            float& x = s[4 * j + 2 * hh + e];
            x = (pb >> bit & 1) ? x * scale : kFill;
            if (!(allow[hh] >> bit & 1)) x = -INFINITY;
          }
    }
    // online softmax from m = -inf, shifting by 0 while m is not finite;
    // ex2.approx gives 0 for -inf
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rmax = fmaxf(rmax, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      const float m_new = fmaxf(m_i[hh], wg::quad_max(rmax));
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = wg::exp2_approx((m_i[hh] - shift) * kLog2e);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = wg::exp2_approx((x - shift) * kLog2e);
          psum += x;
        }
      l_i[hh] = l_i[hh] * alpha + psum;
      m_i[hh] = m_new;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        o[4 * j + 2 * hh] *= alpha;
        o[4 * j + 2 * hh + 1] *= alpha;
      }
    }

    // O += P V: P rounded to bf16 in registers as the A operand; waited
    // for at the next tile's S (wide: here)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<kCols>(o, pa[kk], wg::desc_mn(tV + grp * (kCols / 64) *
                                                    wg::kBlockBytes, kk));
    wg::mma_commit();
    if constexpr (kWaitPV) {
      wg::mma_wait<0>();
      wg::hold(o);
      hold_frags(pa);
    }
    ik = ik_next;
    ik_next = ik_after;
  }
  wg::mma_wait<0>();
  wg::hold(o);
  hold_frags(pa);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = wg::quad_sum(l_i[hh]);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    if (row[hh] >= n) continue;
    bf16* dst = out + base + static_cast<size_t>(row[hh]) * D + grp * kCols +
                2 * t;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (t == 0 && grp == 0) {
      const size_t at = static_cast<size_t>(bh) * n + row[hh];
      m_out[at] = m_i[hh] == -INFINITY ? 0.f : m_i[hh];
      l_out[at] = l_safe;
    }
  }
}

// narrow K3 (d 64, 128)
template <int D>
__global__ void __launch_bounds__(wg::kThreads, kBlocksPerSM<D>)
    block_sparse_fwd_wgmma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
        bf16* __restrict__ out, float* __restrict__ m_out,
        float* __restrict__ l_out, int h, int n, float scale,
        Layout layout) {
  bs_fwd_wgmma<D, kGroups<D>>(q, k, v, mask, out, m_out, l_out, h, n,
                              scale, layout);
}

// wide K3 (bf16, d 192 and 256): the same body. A 64 x d f32 O is d / 2
// registers a thread; at d 256 one warpgroup holding it beside S's 32 and
// P's 16 fragments spills 204 bytes (ptxas), so two warpgroups each
// compute S and P and hold half of O (m64n128k16 products, 246
// registers, no spill; 7-14 % faster on the H100 than one warpgroup at
// 255 registers: chip_flash_variants.py, k3_one_group). At d 192 one
// warpgroup (m64n192k16; 12 bytes of spill), since 96 columns are not a
// whole number of the swizzled 64-column blocks (kGroups). Q with two
// K + V stages take 160 KB at d 256 (120 KB at d 192), so one block an SM
template <int D>
__global__ void __launch_bounds__(kGroups<D> * wg::kThreads, 1)
    block_sparse_fwd_wide_wgmma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
        bf16* __restrict__ out, float* __restrict__ m_out,
        float* __restrict__ l_out, int h, int n, float scale,
        Layout layout) {
  bs_fwd_wgmma<D, kGroups<D>>(q, k, v, mask, out, m_out, l_out, h, n,
                              scale, layout);
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

// the tensor-core kernel of width D: narrow up to 128, wide above
template <int D>
auto wgmma_kernel() {
  if constexpr (D <= 128)
    return block_sparse_fwd_wgmma_kernel<D>;
  else
    return block_sparse_fwd_wide_wgmma_kernel<D>;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* m, void* l,
                         int bh, int h, int n, float scale,
                         const Layout& layout, cudaStream_t stream) {
  const size_t smem = (1 + 2 * kLive) * wg::tile_bytes<D>() + 1024;
  auto kernel = wgmma_kernel<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile);
  constexpr int kBlockThreads = kGroups<D> * wg::kThreads;
  kernel<<<grid, kBlockThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l),
      h, n, scale, layout);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wide heads (d > 128, a multiple of 64): CUDA cores, f32 and bf16
// ---------------------------------------------------------------------------

// One block per (b*h, 64-row query tile, slice of at most 128 output
// columns): the live key tiles (tile_any) as the f32 body walks them, S
// over the whole head in 64-column chunks (tile.cuh), p rounded to T
// before the product with the slice of V; slice 0 writes m and l. Every
// slice recomputes S: ceil(d / 128) times the score work.
template <typename T>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int h, int n, int d,
    float scale, Layout layout) {
  extern __shared__ float smem[];
  float* sQ = smem;                         // chunk of Q
  float* sK = sQ + kChunkFloats;            // chunk of K
  float* sP = sK + kChunkFloats;            // P, rounded to T
  float* sV = sP + kChunkFloats;            // slice of V
  __shared__ int sKm[kTile];

  const int bh = blockIdx.x;
  const int num_tiles = (n + kTile - 1) / kTile;
  const int q0 = blockIdx.y * kTile;
  const int c0 = blockIdx.z * kSliceCols;
  const int width = min(kSliceCols, d - c0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const uint8_t* mask_row = mask ? mask + static_cast<size_t>(bh / h) * n
                                 : nullptr;

  float m_i[4], l_i[4], o[4][kSliceCols / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kSliceCols / 16; ++j) o[i][j] = 0.f;
  }

  for (int ik = 0; ik < num_tiles; ++ik) {
    const int k0 = ik * kTile;
    if (!tile_any(layout, q0, k0, n)) continue;   // the same for the block
    float s[4][4] = {};
    for (int c = 0; c < d; c += kChunkCols) {
      __syncthreads();               // the last readers of every buffer
      load_chunk<T>(sQ, q + base, d, q0, n, c);
      load_chunk<T>(sK, k + base, d, k0, n, c);
      if (c == 0) {
        load_slice<T>(sV, v + base, d, k0, n, c0, width);
        for (int j = threadIdx.x; j < kTile; j += kThreads)
          sKm[j] = k0 + j < n && (mask_row == nullptr || mask_row[k0 + j]);
      }
      __syncthreads();
      dot_nt_chunk(sQ, sK, s, ty, tx);
    }
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
        psum += p;                   // l sums the unrounded p
        sP[r * kPStride + tx + 16 * j] = to_f(from_f<T>(p));
      }
      l_i[i] = l_i[i] * alpha + row_sum(psum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < kSliceCols / 16; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    dot_nn<kSliceCols>(sP, sV, o, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
    store_slice_row<T>(out + base, o[i], l_safe, row, d, c0, width, tx);
    if (tx == 0 && blockIdx.z == 0) {
      m_out[static_cast<size_t>(bh) * n + row] =
          m_i[i] == -INFINITY ? 0.f : m_i[i];
      l_out[static_cast<size_t>(bh) * n + row] = l_safe;
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* m, void* l, int bh,
                        int h, int n, int d, float scale,
                        const Layout& layout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kChunkFloats + kSliceFloats);
  auto kernel = block_sparse_fwd_wide_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (n + kTile - 1) / kTile, (d + kSliceCols - 1) / kSliceCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), h,
      n, d, scale, layout);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/block_sparse.py: 0 float32, 1 bfloat16.
// q, k, v, out: device pointers to contiguous (b, h, n, d) arrays in that
// dtype, d 64, 128 or a multiple of 64 above 128; m, l: (b, h, n)
// float32; mask: (b, n) uint8 key-padding mask or null. block and window
// (= num_local_blocks * block) are in tokens; globals: a host array of
// num_globals (<= 8) global block ids. wide_wgmma: 1 runs the call on the
// wide tensor-core body, compiled for bf16 at d 192 and 256 only (1 with
// any other dtype or d is refused); 0 runs every d above 128 on the
// CUDA-core wide body (ops/block_sparse.py::wide_tensor_cores chooses).
// Returns the CUDA error of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* m, void* l, int b, int h, int n, int d, float scale, int causal,
    int block, int window, const int* globals, int num_globals, int dtype,
    int wide_wgmma, void* stream) {
  if (b <= 0 || h <= 0 || n <= 0 ||
      (d != 64 && d != 128 && (d <= 128 || d % kChunkCols != 0)) ||
      block <= 0 ||
      window <= 0 || num_globals < 0 || num_globals > kMaxGlobals ||
      (num_globals > 0 && globals == nullptr) || (dtype != 0 && dtype != 1) ||
      (n + kTile - 1) / kTile > 65535 ||
      (wide_wgmma && (dtype != 1 || (d != 192 && d != 256))))
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
  if (wide_wgmma)
    err = d == 192 ? launch_wgmma<192>(q, k, v, mask, out, m, l, bh, h, n,
                                       scale, layout, s)
                   : launch_wgmma<256>(q, k, v, mask, out, m, l, bh, h, n,
                                       scale, layout, s);
  else if (d > 128)
    err = dtype == 0 ? launch_wide<float>(q, k, v, mask, out, m, l, bh, h, n,
                                          d, scale, layout, s)
                     : launch_wide<bf16>(q, k, v, mask, out, m, l, bh, h, n,
                                         d, scale, layout, s);
  else if (dtype == 0)
    err = d == 64 ? launch<float, 64>(q, k, v, mask, out, m, l, bh, h, n,
                                      scale, layout, s)
                  : launch<float, 128>(q, k, v, mask, out, m, l, bh, h, n,
                                       scale, layout, s);
  else
    err = d == 64 ? launch_wgmma<64>(q, k, v, mask, out, m, l, bh, h, n,
                                     scale, layout, s)
                  : launch_wgmma<128>(q, k, v, mask, out, m, l, bh, h, n,
                                      scale, layout, s);
  return static_cast<int>(err);
}
