// Tile staging and tile products shared by the attention kernels
// (flash_attention.cu: K1, K2a, K2b; block_sparse.cu: K3), for Hopper
// (sm_90a).
//
// 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i
// (i < 4) and columns tx + 16 j of every 64 x 64 score tile and every
// 64 x d accumulator, so a row's reductions are shuffles within 16 lanes of
// one warp. Tiles are staged through shared memory as f32 with a padded
// row stride (d + 1, 65), which keeps the column reads of every product
// free of bank conflicts; products are CUDA-core FMAs.
//
// ops/build.py hashes this header with every source, so a change here
// rebuilds each kernel that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // query rows = key columns
constexpr int kThreads = 256;
constexpr int kPStride = kTile + 1;        // padded stride of p / ds tiles
constexpr float kFill = -3.0e38f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes that share a ty (lane = (ty & 1) * 16 + tx)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// rows [row0, row0 + 64) of one (n, D) head slice into dst[64][D + 1] as
// f32; rows at or past n read as zeros (the ragged tail is never read)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? to_f(src[static_cast<size_t>(g) * D + c])
                                 : 0.f;
  }
}

// acc[i][j] = sum_c A[ty + 16 i][c] * B[tx + 16 j][c]   (A B^T, 64 x 64)
template <int D>
__device__ __forceinline__ void dot_nt(const float* A, const float* B,
                                       float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * B[k][tx + 16 j]   (P B, 64 x D)
template <int D>
__device__ __forceinline__ void dot_nn(const float* P, const float* B,
                                       float acc[4][D / 16], int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kPStride + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = B[k * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_q P[q][ty + 16 i] * B[q][tx + 16 j]   (P^T B, 64 x D)
template <int D>
__device__ __forceinline__ void dot_tn(const float* P, const float* B,
                                       float acc[4][D / 16], int ty, int tx) {
#pragma unroll 4
  for (int q = 0; q < kTile; ++q) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[q * kPStride + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = B[q * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// wide heads (d > 128, a multiple of 64): the wide bodies of
// flash_attention.cu and block_sparse.cu. A block owns one slice of at
// most kSliceCols output columns (grid axis z); the products that need
// the whole head (q . k, dout . v) stream through shared memory in chunks
// of kChunkCols columns, so the footprint does not grow with d. A slice
// tile is a 64 x 128 f32 tile (stride 129, the D = 128 layout of the
// products above); a last slice of 64 columns is zero past them.
// ---------------------------------------------------------------------------

constexpr int kChunkCols = 64;
constexpr int kSliceCols = 128;
constexpr int kChunkFloats = kTile * (kChunkCols + 1);
constexpr int kSliceFloats = kTile * (kSliceCols + 1);

// rows [row0, row0 + 64), columns [col0, col0 + 64) of a (n, d) head
// slice into dst[64][65] as f32; rows at or past n read as zeros
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int d,
                                           int row0, int n, int col0) {
  for (int i = threadIdx.x; i < kTile * kChunkCols; i += kThreads) {
    const int r = i / kChunkCols;
    const int c = i % kChunkCols;
    const int g = row0 + r;
    dst[r * (kChunkCols + 1) + c] =
        g < n ? to_f(src[static_cast<size_t>(g) * d + col0 + c]) : 0.f;
  }
}

// rows [row0, row0 + 64), columns [col0, col0 + width) (width 64 or 128)
// into dst[64][129] as f32; zeros past n and past width
template <typename T>
__device__ __forceinline__ void load_slice(float* dst, const T* src, int d,
                                           int row0, int n, int col0,
                                           int width) {
  for (int i = threadIdx.x; i < kTile * kSliceCols; i += kThreads) {
    const int r = i / kSliceCols;
    const int c = i % kSliceCols;
    const int g = row0 + r;
    dst[r * (kSliceCols + 1) + c] =
        g < n && c < width
            ? to_f(src[static_cast<size_t>(g) * d + col0 + c])
            : 0.f;
  }
}

// this thread's columns of a slice accumulator row (acc[j]: column
// tx + 16 j of [c0, c0 + width)), divided by div, into row `row` of a
// (n, d) array
template <typename T>
__device__ __forceinline__ void store_slice_row(T* dst, const float* acc,
                                                float div, int row, int d,
                                                int c0, int width, int tx) {
#pragma unroll
  for (int j = 0; j < kSliceCols / 16; ++j) {
    const int c = tx + 16 * j;
    if (c < width)
      dst[static_cast<size_t>(row) * d + c0 + c] = from_f<T>(acc[j] / div);
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c] over one chunk
__device__ __forceinline__ void dot_nt_chunk(const float* A, const float* B,
                                             float acc[4][4], int ty,
                                             int tx) {
#pragma unroll 8
  for (int c = 0; c < kChunkCols; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (kChunkCols + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (kChunkCols + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace
