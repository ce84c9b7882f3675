// Device helpers of the flash forward kernel (flash_attention.cu), shared
// with its ablation (flash_ablate.cu) so that both run the same loads and
// the same mma.sync fragments.
//
// mma16816 is one mma.sync m16n8k16 (bf16 in, fp32 accumulate); load_a
// and acc_to_a build its A fragment from shared memory or from an fp32
// accumulator; load_tile copies a [ROWS, D] tile of a [seq, D] matrix
// into shared memory, row-major and/or transposed. The defaults of
// load_tile (64 rows, 128 threads) are the flash kernels' CTA.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 k) of a row-major bf16 tile in shared memory.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base,
                                       int ld, int g, int t) {
  a[0] = ld32(base + g * ld + t * 2);
  a[1] = ld32(base + (g + 8) * ld + t * 2);
  a[2] = ld32(base + g * ld + 8 + t * 2);
  a[3] = ld32(base + (g + 8) * ld + 8 + t * 2);
}

// A fragment for a 16-wide k chunk taken from two accumulator n-tiles
// (the C layout of tiles 2c and 2c+1 is the A layout of chunk c).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// Load `ROWS` rows starting at `row0` of a [seq, D] matrix into shared
// memory: row-major into `dst` (leading dim `ld`) and/or transposed into
// `dstT` ([D][ROWS], leading dim `ldT`). Rows past `seq` become zeros.
// With `scale` != 0 each element is multiplied by it in bf16 arithmetic.
template <int D, int ROWS = 64, int THREADS = 128>
__device__ void load_tile(bf16* dst, int ld, bf16* dstT, int ldT,
                          const bf16* src, int row0, int seq, float scale) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += THREADS) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int gr = row0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (gr < seq) {
      raw = *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    }
    bf16* e = reinterpret_cast<bf16*>(&raw);
    if (scale != 0.f) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    if (dst) *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;
    if (dstT) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dstT[(c + j) * ldT + r] = e[j];
    }
  }
}

__device__ __forceinline__ bool valid_pair(int qrow, int kcol, int sq,
                                           int sk, int causal) {
  return qrow < sq && kcol < sk && (!causal || qrow >= kcol);
}

}  // namespace
