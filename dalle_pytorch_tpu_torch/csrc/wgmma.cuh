// Tensor-core tile code for Hopper (sm_90a): bf16 tiles staged
// asynchronously into shared memory in wgmma's 128-byte-swizzled layout,
// and warpgroup matrix products (wgmma.mma_async) on them, accumulating
// in f32 registers. Used by the bf16 bodies of flash_attention.cu's K1
// (forward), K2a (dq) and K2b (dk, dv; fused, dq too), narrow (d 64, 128)
// and wide (K1 and K2b at d 192, 256), and of block_sparse.cu's K3; its
// TF32 section (end of file: f32 tiles, split into hi and lo parts, three
// TF32 products a tile product) by the f32 bodies of K1 and K2b (split
// and fused) at d 64 and 128. The CUDA-core tile code of tile.cuh serves
// every other body, and paged_attention.cu (K4) uses only the cp.async
// copies.
//
// Layout. A tile is 64 rows of D bf16 values (D = 64, 128, 192 or 256),
// one row per query or key. It is stored as D / 64 column blocks of 64
// rows x 128 bytes (8 KB each, 1024-byte aligned); inside a block, row
// r's 16-byte chunk c lies at r * 128 + ((c ^ (r % 8)) * 16). That is
// the canonical 128-byte-swizzle layout of wgmma for both operand
// orientations:
//   * K-major (the depth, D, contiguous): Q, K, V or dO as the A or B of
//     a score product (S = Q K^T). A 16-deep step kk reads 32 bytes of
//     each row: block kk / 4, byte offset (kk % 4) * 32; 8-row groups
//     1024 bytes apart (SBO).
//   * MN-major (the output columns, D, contiguous): V, dO or Q as the B
//     of an output product (O = P V). A 16-deep step reads 16 rows,
//     2048 bytes on; 8-row groups 1024 bytes apart (SBO); each further
//     64-column block of D, 8 KB on (LBO). A 64 x 64 tile read so is the
//     transposed A of a product too (fused K2b's dS from dS^T).
//
// Register fragments (per warpgroup of 128 threads; warp w, lane
// 4 g + t). A 64 x N f32 accumulator holds, in d[4 j + 2 h + e], row
// 16 w + g + 8 h and column 8 j + 2 t + e. A 64 x 16 bf16 A operand
// holds rows 16 w + g (+ 8) and columns 2 t (+ 1) and 2 t + 8 (+ 1) in
// four 32-bit registers; columns 16 kk .. 16 kk + 15 of an accumulator
// map onto it register for register (``a_frag``), so a product's f32
// result becomes the next product's A without leaving registers.
//
// ops/build.py hashes this header with every source.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace wg {

constexpr int kRows = 64;                 // rows of a tile and of a wgmma
constexpr int kThreads = 128;             // one warpgroup
constexpr uint32_t kBlockBytes = 8192;    // 64 rows x 128 bytes

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return kRows * D * 2; }

// byte offset of row r's 16-byte chunk c (c < D / 8) inside a tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + 64) of one (n, D) bf16 head slice into the tile at
// shared address dst, by NT threads (tid < NT); rows at or past n are
// zero-filled
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int tid) {
  constexpr int kChunks = kRows * D / 8;
  static_assert(kChunks % NT == 0, "threads must divide the tile");
#pragma unroll
  for (int i = 0; i < kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / (D / 8);
    const int c = idx % (D / 8);
    const int g = row0 + r;
    const bool ok = g < n;
    cp_async16(dst + swizzled(r, c),
               src + static_cast<size_t>(ok ? g : 0) * D + c * 8, ok);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// the tile at `tile` as a K-major operand, 16-deep step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}

// the tile at `tile` as an MN-major B operand, 16-deep step kk (rows
// 16 kk .. 16 kk + 15)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, kBlockBytes, 1024);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed product groups are in flight (they complete
// in order)
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// an asynchronous product that owns it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = A B^T (+ d if accumulate): A (64 x 16) and B
// (64 x 16) K-major bf16 in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = A B (+ d if accumulate): A (64 x 16) and B (16 x 64)
// both MN-major bf16 in shared memory (A's 64 rows, not its depth,
// contiguous: the transposed read wgmma allows for 16-bit types), each
// addressed as ``desc_mn`` addresses a B
__device__ __forceinline__ void mma_ss_n64_mn(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A B: A (64 x 16 bf16) from registers (``a_frag``),
// B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += A B: A (64 x 16 bf16) from registers (``a_frag``),
// B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 192 f32) += A B: A (64 x 16 bf16) from registers (``a_frag``),
// B (16 x 192) MN-major in shared memory
__device__ __forceinline__ void mma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256 f32) += A B: A (64 x 16 bf16) from registers (``a_frag``),
// B (16 x 256) MN-major in shared memory
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// two f32 -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// columns 16 kk .. 16 kk + 15 of a 64 x 64 f32 accumulator, rounded to
// bf16, as the A operand of the next product
__device__ __forceinline__ void a_frag(const float (&s)[32], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// the A fragments of a 64 x 64 accumulator (``a_frag`` of each kk: rows
// 16 w + g (+ 8), columns 8 j + 2 t (+ 1), j = 2 kk, 2 kk + 1) stored as
// a bf16 tile at `tile` in the swizzled layout: 64 rows of 128 bytes, so
// that the tile read MN-major (``desc_mn``) is the accumulator's
// transpose. Each warp writes its 16 rows, 4 bytes a lane, without bank
// conflicts (the 8 rows of a store land in 8 different 16-byte chunks)
__device__ __forceinline__ void store_frags(uint32_t tile,
                                            const uint32_t (&a)[4][4],
                                            int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                       tile + swizzled(r, 2 * kk + (i >> 1)) + 4 * t),
                   "r"(a[kk][i])
                   : "memory");
    }
}

// *p += (x, y, z, w) in device memory (16-byte aligned), one vector
// reduction (sm_90); no value comes back
__device__ __forceinline__ void red_add_v4(float* p, float x, float y,
                                           float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

// 2^x by the special-function unit (relative error ~2^-22; -inf gives 0,
// results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 4 lanes (t = 0..3) that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the pad flags of a 64-row window, in two steps so that the loads can be
// issued a tile ahead: mask_flags gives this lane's two (bit 0: row
// row0 + lane, bit 1: row0 + 32 + lane; 0 at or past n), mask_bits the
// warp's 64-bit word (bit c: row row0 + c), the same in every lane
__device__ __forceinline__ uint32_t mask_flags(const uint8_t* mask_row,
                                               int row0, int n, int lane) {
  const int a = row0 + lane, b = row0 + 32 + lane;
  return (a < n && mask_row[a]) | (b < n && mask_row[b]) << 1;
}
__device__ __forceinline__ uint64_t mask_bits(uint32_t flags) {
  const unsigned lo = __ballot_sync(0xffffffffu, flags & 1);
  const unsigned hi = __ballot_sync(0xffffffffu, flags & 2);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

constexpr float kLog2e = 1.4426950408889634f;

// named barrier `id` (1-15; __syncthreads takes 0) of `threads` threads:
// bar_arrive signals without waiting, bar_sync waits for all `threads`;
// shared-memory writes before the arrival are visible after the sync
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x D f32) += A B: A (64 x 16 bf16) from registers, B (16 x D)
// MN-major in shared memory
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256,
                "wgmma output widths: 64, 128, 192, 256");
  if constexpr (D == 64)
    wg::mma_rs_n64(d, a, b);
  else if constexpr (D == 128)
    wg::mma_rs_n128(d, a, b);
  else if constexpr (D == 192)
    wg::mma_rs_n192(d, a, b);
  else
    wg::mma_rs_n256(d, a, b);
}

__device__ __forceinline__ void hold_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// 1024-byte aligned start of the dynamic shared memory (the swizzle
// pattern is a function of the address bits); launchers add 1 KB slack
__device__ __forceinline__ uint32_t aligned_smem(const uint8_t* raw) {
  return (wg::smem_addr(raw) + 1023u) & ~1023u;
}


// ---------------------------------------------------------------------------
// float32 on the tensor cores: three TF32 products a tile product
// ---------------------------------------------------------------------------
// A float32 product a b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi,
// with hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: 10 mantissa bits,
// rounded to nearest), each accumulated in f32 by a TF32 wgmma: a few f32
// ulps from the f32 product, where one TF32 product is 2^-11 relative
// (CUTLASS's OpMultiplyAddFastF32). The split happens once a tile, as it
// is staged (split_tile, split_tile_t) or taken from an accumulator
// (a_frag32), never once a product.
//
// Layout. An f32 tile of R rows by C columns is stored as the bf16 tiles
// are, 128-byte swizzled, but a swizzle row holds 32 values: C / 32
// column blocks of R rows x 128 bytes, row r's 16-byte chunk c (4
// values) at r * 128 + ((c ^ (r % 8)) * 16) in its block (swz32). tf32
// wgmma (m64nNk8) reads both operands K-major only (the transposed read
// is for 16-bit types): the depth contiguous in every row. An 8-deep step
// kk reads 32 bytes of each row: block kk / 4, byte offset (kk % 4) * 32,
// 8-row groups 1024 bytes apart (desc_k32). So a product whose depth runs
// over rows of a stored tile (O = P V: V's keys) takes that tile
// transposed (split_tile_t), and an A operand from registers (a_frag32)
// is an accumulator's columns, whose pairs (2 t, 2 t + 1) the fragment
// wants as (t, t + 4): split_tile_t permutes each 8-column group of the
// transposed tile to match (column 8 j + i at 8 j + i / 2 for even i, 8 j
// + 4 + i / 2 for odd i), so P and dS stay in registers.

template <int R>
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// the R-row tile at `tile` as a K-major TF32 operand, 8-deep step kk
template <int R>
__device__ __forceinline__ uint64_t desc_k32(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x ~= hi + lo, both TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// rows [row0, row0 + R) of one (n, D) f32 head slice into the R-row tile
// at dst (swz32), by NT threads, asynchronously; rows at or past n are
// zero-filled
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile32(uint32_t dst, const float* src,
                                            int row0, int n, int tid) {
  constexpr int kChunks = R * D / 4;
  static_assert(kChunks % NT == 0, "threads must divide the tile");
#pragma unroll
  for (int i = 0; i < kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / (D / 4);
    const int c = idx % (D / 4);
    const int g = row0 + r;
    const bool ok = g < n;
    cp_async16(dst + swz32<R>(r, c),
               src + static_cast<size_t>(ok ? g : 0) * D + c * 4, ok);
  }
}

// the same rows read from device memory now and split into the hi and
// lo tiles at hi and lo (rows past n: zeros); for a block's resident
// tiles, loaded once
template <int R, int D, int NT>
__device__ __forceinline__ void split_global(uint32_t hi, uint32_t lo,
                                             const float* src, int row0,
                                             int n, int tid) {
  constexpr int kChunks = R * D / 4;
  static_assert(kChunks % NT == 0, "threads must divide the tile");
#pragma unroll 4
  for (int i = 0; i < kChunks / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / (D / 4);
    const int c = idx % (D / 4);
    const int g = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < n)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * D +
                                           c * 4);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    const uint32_t at = swz32<R>(r, c);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + at),
                 "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + at),
                 "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
  }
}

__device__ __forceinline__ float4 ld_shared4(uint32_t at) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(at)
               : "memory");
  return x;
}

// the R x D tile at raw (as load_tile32 stores it, landed and visible)
// split into hi and lo tiles of the same layout. A warp takes one chunk
// of 32 rows: 512 bytes in 4 conflict-free wavefronts each way
template <int R, int D, int NT>
__device__ __forceinline__ void split_tile(uint32_t hi, uint32_t lo,
                                           uint32_t raw, int tid) {
  static_assert(R % 32 == 0 && (R * D / 4) % NT == 0, "tile shape");
#pragma unroll 4
  for (int i = 0; i < R * D / 4 / NT; ++i) {
    const int idx = tid + i * NT;
    const uint32_t at = swz32<R>(idx % R, idx / R);
    const float4 x = ld_shared4(raw + at);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + at),
                 "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + at),
                 "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
  }
}

// the position of column i of an 8-column group in a transposed tile
// (``a_frag32``'s order)
__device__ __forceinline__ int frag_pos(int i) {
  return (i & ~7) | ((i & 1) << 2) | ((i & 7) >> 1);
}

// the R x D tile at raw split into hi and lo tiles of its transpose: D
// rows of R columns (R / 32 blocks of D rows x 128 bytes), each 8-column
// group permuted by frag_pos. A warp takes one chunk of 32 rows, so each
// of its stores writes one 128-byte row segment: conflict-free
template <int R, int D, int NT>
__device__ __forceinline__ void split_tile_t(uint32_t hi, uint32_t lo,
                                             uint32_t raw, int tid) {
  static_assert(R % 32 == 0 && (R * D / 4) % NT == 0, "tile shape");
#pragma unroll 4
  for (int i = 0; i < R * D / 4 / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx % R, c = idx / R;
    const float4 x = ld_shared4(raw + swz32<R>(r, c));
    const float v[4] = {x.x, x.y, x.z, x.w};
    const int p = frag_pos(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split_tf32(v[e], h, l);
      const uint32_t at = swz32<D>(4 * c + e, p >> 2) + (p & 3) * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + at), "r"(h)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo + at), "r"(l)
                   : "memory");
    }
  }
}

// columns 8 kk .. 8 kk + 7 of an f32 accumulator (this thread's rows g,
// g + 8 and columns 8 kk + 2 t (+ 1)) as the hi and lo A fragments of a
// TF32 product (rows g, g + 8 and depth t, t + 4): column 2 t is depth t
// and 2 t + 1 depth t + 4, the order split_tile_t gives B's rows
template <int N>
__device__ __forceinline__ void a_frag32(const float (&s)[N], int kk,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(s[4 * kk + 0], hi[0], lo[0]);
  split_tf32(s[4 * kk + 2], hi[1], lo[1]);
  split_tf32(s[4 * kk + 1], hi[2], lo[2]);
  split_tf32(s[4 * kk + 3], hi[3], lo[3]);
}

// d (64 x 32 f32) = A B^T (+ d if accumulate): A (64 x 8) and B (32 x 8)
// K-major float32 tiles in shared memory, read as TF32
__device__ __forceinline__ void mma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = A B^T (+ d if accumulate): A (64 x 8) and B (64 x 8)
// K-major float32 tiles in shared memory, read as TF32
__device__ __forceinline__ void mma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32 f32) += A B: A (64 x 8 TF32) from registers (``a_frag32``),
// B (32 x 8) K-major float32 in shared memory, read as TF32
__device__ __forceinline__ void mma_tf32_rs_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 f32) += A B: A (64 x 8 TF32) from registers (``a_frag32``),
// B (64 x 8) K-major float32 in shared memory, read as TF32
__device__ __forceinline__ void mma_tf32_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += A B: A (64 x 8 TF32) from registers (``a_frag32``),
// B (128 x 8) K-major float32 in shared memory, read as TF32
__device__ __forceinline__ void mma_tf32_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) = A B^T (+ d if accumulate) over a depth of 8 steps: A (64
// rows) and B (N rows) K-major f32 tiles, each as its hi and lo tiles;
// the small products first
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint32_t a_hi,
                                        uint32_t a_lo, uint32_t b_hi,
                                        uint32_t b_lo, int steps,
                                        bool accumulate) {
  static_assert(N == 32 || N == 64, "score widths: 32, 64");
#pragma unroll
  for (int kk = 0; kk < steps; ++kk) {
    const uint64_t ah = desc_k32<kRows>(a_hi, kk);
    const uint64_t al = desc_k32<kRows>(a_lo, kk);
    const uint64_t bh = desc_k32<N>(b_hi, kk);
    const uint64_t bl = desc_k32<N>(b_lo, kk);
    if constexpr (N == 32) {
      mma_tf32_ss_n32(d, al, bh, accumulate || kk > 0);
      mma_tf32_ss_n32(d, ah, bl, 1);
      mma_tf32_ss_n32(d, ah, bh, 1);
    } else {
      mma_tf32_ss_n64(d, al, bh, accumulate || kk > 0);
      mma_tf32_ss_n64(d, ah, bl, 1);
      mma_tf32_ss_n64(d, ah, bh, 1);
    }
  }
}

// the same product, 64 x 32 (K2b's scores over its 32-row query tiles,
// which feed exp and every gradient), into two accumulators: d takes
// a_hi b_hi, c the two small products (a_lo b_hi + a_hi b_lo), summed by
// the caller once all are done. The tensor core's sums truncate; kept
// apart, the main sum takes a third of the truncations, and the small
// ones cost only bits of their own size
__device__ __forceinline__ void mma3_ss2(float (&d)[16], float (&c)[16],
                                         uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo,
                                         int steps) {
#pragma unroll
  for (int kk = 0; kk < steps; ++kk) {
    const uint64_t ah = desc_k32<kRows>(a_hi, kk);
    const uint64_t al = desc_k32<kRows>(a_lo, kk);
    const uint64_t bh = desc_k32<32>(b_hi, kk);
    const uint64_t bl = desc_k32<32>(b_lo, kk);
    mma_tf32_ss_n32(c, al, bh, kk > 0);
    mma_tf32_ss_n32(c, ah, bl, 1);
    mma_tf32_ss_n32(d, ah, bh, kk > 0);
  }
}

// d (64 x N) += A B for one 8-deep step: A from registers (hi, lo), B (N
// rows) K-major at b_hi and b_lo
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&a_hi)[4],
                                        const uint32_t (&a_lo)[4],
                                        uint64_t b_hi, uint64_t b_lo) {
  static_assert(N == 32 || N == 64 || N == 128, "widths: 32, 64, 128");
  if constexpr (N == 32) {
    mma_tf32_rs_n32(d, a_lo, b_hi);
    mma_tf32_rs_n32(d, a_hi, b_lo);
    mma_tf32_rs_n32(d, a_hi, b_hi);
  } else if constexpr (N == 64) {
    mma_tf32_rs_n64(d, a_lo, b_hi);
    mma_tf32_rs_n64(d, a_hi, b_lo);
    mma_tf32_rs_n64(d, a_hi, b_hi);
  } else {
    mma_tf32_rs_n128(d, a_lo, b_hi);
    mma_tf32_rs_n128(d, a_hi, b_lo);
    mma_tf32_rs_n128(d, a_hi, b_hi);
  }
}

template <int N>
__device__ __forceinline__ void hold_u(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// the pad flags of R (32 or 64) rows from row0 as a warp-uniform word:
// bit c set where row row0 + c is below n and kept
template <int R>
__device__ __forceinline__ uint64_t row_bits(const uint8_t* mask_row,
                                             int row0, int n, int lane) {
  if constexpr (R == 64) {
    return mask_bits(mask_flags(mask_row, row0, n, lane));
  } else {
    static_assert(R == 32, "32 or 64 rows");
    const int a = row0 + lane;
    return __ballot_sync(0xffffffffu, a < n && mask_row[a]);
  }
}
template <int R>
__host__ __device__ constexpr uint64_t all_rows() {
  return R == 64 ? ~0ull : (1ull << R) - 1;
}

}  // namespace wg
}  // namespace
