// Hopper building blocks of the flash kernels K1-K3
// (flash_attention.cu): wgmma products on 128-byte-swizzled shared-memory
// tiles, and an asynchronous cp.async tile ring that fills them.
//
// Element types. Every tile and product here takes bf16 or fp16 (T, a
// template parameter defaulting to bf16): the two have the same size and
// fragment layouts, so only the wgmma instruction's type suffix, the
// packing of two fp32 values and the q-scale pass differ.
//
// Tile layout. A [ROWS, D] tile is stored as W/64 column blocks of
// [ROWS][64], W = tile_width<D>() (D rounded up to whole 64-column
// blocks up to 128, and to 256 above: a D = 96 tile is stored 128 wide,
// a D = 160 tile 256 wide, the columns past D zero filled as they
// land). Each row of a block is 128 bytes, and the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte
// swizzle, so eight rows read at one column hit eight different bank
// groups). Blocks start 1024-byte aligned. One stored tile serves as a
// K-major wgmma operand (D, its contiguous axis, is the reduction axis:
// Q and K in Q K^T) and as an MN-major one (ROWS is the reduction axis:
// V in P V, read through the transpose bit), so no tile is ever
// transposed in shared memory.
//
// Descriptors (PTX ISA "Matrix Descriptor Format"): start address,
// leading byte offset (LBO) and stride byte offset (SBO), all >> 4, and
// the swizzle mode in bits 62-63 (1 = 128-byte).
//   K-major, k-step kk (16 of D): start = block kk/4 + 32 bytes * (kk % 4)
//     inside the 128-byte row; SBO = 1024 (eight rows); LBO unused (1).
//   MN-major, k-step kk (16 rows): start = 16 rows * 128 bytes * kk;
//     SBO = 1024 (eight rows of the reduction axis); LBO = ROWS * 128
//     (from one 64-wide column block to the next).
//
// Fragments. wgmma m64nNk16 gives each warp w of the warpgroup rows
// 16w..16w+15 in the layout of mma.sync m16n8k16, repeated over the N/8
// column blocks: d[j][0..1] at row g = lane / 4, columns 8j + 2(lane % 4)
// + {0, 1}; d[j][2..3] at row g + 8. Its register A operand (the RS form)
// is the m16n8k16 A fragment, so an fp32 accumulator over 16 columns
// becomes the T A operand of the next product by acc_to_a_as (bf16:
// acc_to_a of flash_tile.cuh; column blocks 2c and 2c+1 make k-chunk c).
//
// wgmma is asynchronous: a warpgroup issues a batch, commits it and
// waits. Registers an asm statement names are pinned with fence_acc /
// fence_frag around the batch so that the compiler neither moves a
// write into it nor reads a result before the wait; wgmma_fence orders
// earlier register writes before the batch (PTX requires it). Shared
// memory written by threads (cp.async, the q-scale pass) is made visible
// to wgmma, which reads in the async proxy, by fence_proxy_async and a
// barrier.

#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "flash_tile.cuh"

namespace {

typedef __half half;

// Head dims: multiples of 16 up to 256, so that a k-step of 16 never
// straddles the zero-filled columns and a row is whole 16-byte chunks.
template <int D>
__host__ __device__ constexpr int tile_width() {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "D is 16, 32, ..., 256");
  return D <= 128 ? (D + 63) / 64 * 64 : 256;
}

// Columns of an RS product's accumulator: the whole stored width up to
// 128; a 256-wide tile's products run as two 128-column chunks, one per
// CTA, so that no accumulator takes more than 64 registers a thread.
template <int D>
__host__ __device__ constexpr int out_width() {
  return tile_width<D>() > 128 ? 128 : tile_width<D>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (of D/8) of row r in a swizzled tile.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows row0..row0+63 of a ROWS-row tile, k-step kk.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * (ROWS * 128) + row0 * 128 +
                        (kk & 3) * 32,
                    16, 1024);
}

// MN-major operand: rows 16kk..16kk+15 of a ROWS-row tile, all D columns.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// d (+)= A B, m64nNk16, T (bf16 or fp16) in, fp32 accumulate. SS: A and
// B from shared memory; RS: A from registers. TRANS_B 0 reads B K-major,
// 1 MN-major. accumulate 0 overwrites d. Each body is a macro over the
// PTX type name, so the bf16 and fp16 forms are one text.
#define HVD_WGMMA_SS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, %35;\n}\n" \
  : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
  : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B))

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    HVD_WGMMA_SS_N64("bf16");
  } else {
    static_assert(std::is_same<T, half>::value, "T is bf16 or half");
    HVD_WGMMA_SS_N64("f16");
  }
}

#define HVD_WGMMA_SS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p, 1, 1, 0, %67;\n}\n" \
  : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
  "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
  "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
  "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
  "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
  : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B))

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    HVD_WGMMA_SS_N128("bf16");
  } else {
    static_assert(std::is_same<T, half>::value, "T is bf16 or half");
    HVD_WGMMA_SS_N128("f16");
  }
}

#define HVD_WGMMA_RS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
  : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
  "r"(accumulate), "n"(TRANS_B))

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    HVD_WGMMA_RS_N64("bf16");
  } else {
    static_assert(std::is_same<T, half>::value, "T is bf16 or half");
    HVD_WGMMA_RS_N64("f16");
  }
}

#define HVD_WGMMA_RS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
  : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
  "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
  "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
  "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
  "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
  "r"(accumulate), "n"(TRANS_B))

template <int TRANS_B, typename T = bf16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    HVD_WGMMA_RS_N128("bf16");
  } else {
    static_assert(std::is_same<T, half>::value, "T is bf16 or half");
    HVD_WGMMA_RS_N128("f16");
  }
}

// SS product with a K-major B of N = 64 or 128 rows.
template <int N, typename T = bf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4],
                                         uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64<0, T>(d, desc_a, desc_b, accumulate);
  } else {
    static_assert(N == 128, "N is 64 or 128");
    wgmma_ss_n128<0, T>(d, desc_a, desc_b, accumulate);
  }
}

// RS product over out_width<D>() stored columns of an MN-major B whose
// rows are D wide (from the column block desc_b starts at): the
// accumulator's columns past D take the zero-filled columns of B and
// stay zero.
template <int D, typename T = bf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[out_width<D>() / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (out_width<D>() == 64) {
    wgmma_rs_n64<1, T>(d, a, desc_b, 1);
  } else {
    wgmma_rs_n128<1, T>(d, a, desc_b, 1);
  }
}

// Two fp32 values rounded to T and packed low-first into one register,
// and the A fragment of the next product from an accumulator (as
// pack2 / acc_to_a of flash_tile.cuh, which are the bf16 forms).
template <typename T>
__device__ __forceinline__ uint32_t pack2_as(float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    return pack2(lo, hi);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ void acc_to_a_as(uint32_t a[4], const float c0[4],
                                            const float c1[4]) {
  if constexpr (std::is_same<T, bf16>::value) {
    acc_to_a(a, c0, c1);
  } else {
    a[0] = pack2_as<T>(c0[0], c0[1]);
    a[1] = pack2_as<T>(c0[2], c0[3]);
    a[2] = pack2_as<T>(c1[0], c1[1]);
    a[3] = pack2_as<T>(c1[2], c1[3]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issue the copies of rows row0..row0+ROWS-1 of a [seq, D] matrix into
// the swizzled tile at shared address `tile`, 16 bytes a thread. Rows
// past seq, and columns past D, are zero-filled (src-size 0) and never
// read.
template <int D, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_tile_async(uint32_t tile,
                                                const T* src, int row0,
                                                int seq) {
  static_assert(sizeof(T) == 2, "16-bit elements: 8 to a chunk");
  constexpr int kChunks = tile_width<D>() / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    if constexpr (kChunks == D / 8) {
      const bool ok = row0 + r < seq;
      cp_async16(tile + sw128<ROWS>(r, c),
                 src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
    } else {
      const bool ok = row0 + r < seq && c < D / 8;
      cp_async16(tile + sw128<ROWS>(r, c),
                 src + (size_t)(ok ? row0 + r : 0) * D + (ok ? c * 8 : 0),
                 ok);
    }
  }
}

// Rows row0..row0+ROWS-1 and columns col0..col0+127 of a [seq, ld]
// matrix into a 128-wide swizzled tile (the D = 128 layout), for head
// dims above 256 that stream through shared memory 128 columns at a
// time. Rows past seq are zero-filled. A thread copies the chunks that
// load_tile_async<128, ROWS, THREADS> gives it, so scale_tile<128, ROWS,
// THREADS> scales this thread's own copies.
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_chunk_async(uint32_t tile, const T* src,
                                                 int row0, int seq, int ld,
                                                 int col0) {
  static_assert(sizeof(T) == 2, "16-bit elements: 8 to a chunk");
  constexpr int kChunks = 128 / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = row0 + r < seq;
    cp_async16(tile + sw128<ROWS>(r, c),
               src + (size_t)(ok ? row0 + r : 0) * ld + col0 + c * 8, ok);
  }
}

// q * scale in T arithmetic (the product of the two T values, rounded
// to T), as load_tile does, in place over the chunks this thread copied
// with load_tile_async (so its own cp_async_wait is enough before it).
template <int D, int ROWS, int THREADS, typename T = bf16>
__device__ __forceinline__ void scale_tile(unsigned char* tile,
                                           float scale) {
  constexpr int kChunks = tile_width<D>() / 8;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    uint4* p = reinterpret_cast<uint4*>(
        tile + sw128<ROWS>(idx / kChunks, idx % kChunks));
    uint4 raw = *p;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (std::is_same<T, bf16>::value) {
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      } else {
        e[j] = __float2half(__half2float(e[j]) * scale);
      }
    }
    *p = raw;
  }
}

}  // namespace
