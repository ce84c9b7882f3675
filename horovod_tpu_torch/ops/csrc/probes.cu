// Streaming probes for Hopper (sm_90a): what a plain copy, a +1 map and a
// stats-style column reduce reach on the card, at the shapes of the
// batch-norm kernels (fused_bn.cu), whose practical ceiling they measure.
//
// Layout: x, y are [M, C] bf16, row-major, C a multiple of 8 and the
// pointers 16-byte aligned; M a multiple of the row tile bm. One CTA per
// (bm, C) row tile, as the probes' Pallas grids have one step per tile.
//
// probe_map_kernel<false> replaces
//   experiments/pallas_shape_probe.py::make_copy (kernel copy_kernel) and
//   experiments/pallas_mem_probe.py::copy_kernel via make_pallas_map;
// probe_map_kernel<true>  replaces pallas_mem_probe.py::addone_kernel:
//   y = x, or y = bf16(x + 1). A (bm, C) tile of a row-major [M, C]
//   matrix is one contiguous range of bm*C elements, so the CTA walks it
//   flat: 256 threads, each with four 16-byte loads in flight before its
//   stores. Bound: 2*M*C*2 bytes (read x, write y); at [802816, 256],
//   822 MB, 245 us at 3.35 TB/s. What moves the time is the number and
//   size of the tiles: a tile is one CTA's serial work, so few large tiles
//   leave SMs idle.
// probe_stats_kernel + probe_finalize_kernel replace
//   pallas_mem_probe.py::stats_like_kernel via make_pallas_map:
//   out[c] = sum over rows of x + sum over rows of x^2, in fp32, one [C]
//   vector. The TPU kernel carries the sum across its sequential grid;
//   here each CTA sums its bm rows (32 threads across 256 channels, 8
//   channels each with one 16-byte load per row, times 8 row lanes; a
//   fixed tree over the lanes in shared memory) and writes the partial
//   sum(x) + sum(x^2) of its tile to part[g, :]; a second launch sums the
//   M/bm partials of each channel in a fixed order (as fused_bn.cu's
//   finalize), so there are no float atomics and two calls give the same
//   bits. Bound: M*C*2 bytes read; at [802816, 256] 411 MB, 123 us.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMapThreads = 256;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kStatsTX = 32;    // threads across channels (8 each)
constexpr int kStatsTY = 8;     // row lanes
constexpr int kStatsCols = kStatsTX * 8;

__device__ __forceinline__ uint4 add_one(uint4 u) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    h[k] = __floats2bfloat162_rn(__fadd_rn(f.x, 1.f), __fadd_rn(f.y, 1.f));
  }
  return u;
}

// One CTA copies (or maps) the tile_vecs 16-byte vectors of its tile.
template <bool ADDONE>
__global__ void __launch_bounds__(kMapThreads)
probe_map_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                 int64_t tile_vecs) {
  const int64_t base = (int64_t)blockIdx.x * tile_vecs;
  x += base;
  y += base;
  for (int64_t i0 = threadIdx.x; i0 < tile_vecs;
       i0 += (int64_t)kUnroll * kMapThreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kMapThreads;
      if (i < tile_vecs) u[j] = x[i];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kMapThreads;
      if (i < tile_vecs) y[i] = ADDONE ? add_one(u[j]) : u[j];
    }
  }
}

// part[g, c] = sum(x) + sum(x^2) over rows [g*bm, (g+1)*bm) of channel c.
__global__ void __launch_bounds__(kStatsTX * kStatsTY)
probe_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                   int c, int bm) {
  __shared__ float s1s[kStatsTY][kStatsCols];
  __shared__ float s2s[kStatsTY][kStatsCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kStatsCols + tx * 8;
  const bool live = c0 < c;
  float s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
  if (live) {
    const bf16* p = x + (int64_t)blockIdx.y * bm * c + c0;
    for (int r = ty; r < bm; r += kStatsTY) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + (int64_t)r * c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        s1[2 * k] += f.x;
        s2[2 * k] = fmaf(f.x, f.x, s2[2 * k]);
        s1[2 * k + 1] += f.y;
        s2[2 * k + 1] = fmaf(f.y, f.y, s2[2 * k + 1]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s1s[ty][tx * 8 + k] = s1[k];
    s2s[ty][tx * 8 + k] = s2[k];
  }
  __syncthreads();
#pragma unroll
  for (int st = kStatsTY / 2; st > 0; st >>= 1) {
    if (ty < st) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s1s[ty][tx * 8 + k] += s1s[ty + st][tx * 8 + k];
        s2s[ty][tx * 8 + k] += s2s[ty + st][tx * 8 + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    float* out = part + (int64_t)blockIdx.y * c + c0;
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = s1s[0][tx * 8 + k] + s2s[0][tx * 8 + k];
  }
}

// out[c] = sum over g of part[g, c], in a fixed order: 32 lanes each sum
// every 32nd partial, then a fixed tree over the lanes.
__global__ void __launch_bounds__(1024)
probe_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int groups, int c) {
  __shared__ float s[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (ch < c) {
    for (int g = ty; g < groups; g += 32) acc += part[(int64_t)g * c + ch];
  }
  s[ty][tx] = acc;
  __syncthreads();
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    if (ty < st) s[ty][tx] += s[ty + st][tx];
    __syncthreads();
  }
  if (ty == 0 && ch < c) out[ch] = s[0][tx];
}

bool bad_args(int m, int c, int bm) {
  return m < 1 || c < 8 || c % 8 != 0 || bm < 1 || m % bm != 0;
}

}  // namespace

extern "C" {

// y = x (addone = 0) or y = bf16(x + 1) (addone = 1) over [m, c], one CTA
// per bm-row tile. Returns a cudaError_t (0 on success).
int hvd_probe_map(const void* x, void* y, int m, int c, int bm, int addone,
                  void* stream) {
  if (bad_args(m, c, bm)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tile_vecs = (int64_t)bm * c / 8;
  if (addone) {
    probe_map_kernel<true><<<m / bm, kMapThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, tile_vecs);
  } else {
    probe_map_kernel<false><<<m / bm, kMapThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, tile_vecs);
  }
  return (int)cudaGetLastError();
}

// out is [c] fp32: sum(x) + sum(x^2) per channel. part is [m/bm, c]
// scratch.
int hvd_probe_stats_like(const void* x, void* part, void* out, int m, int c,
                         int bm, void* stream) {
  if (bad_args(m, c, bm) || m / bm > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = m / bm;
  probe_stats_kernel<<<dim3((c + kStatsCols - 1) / kStatsCols, groups),
                       dim3(kStatsTX, kStatsTY), 0, s>>>(
      (const bf16*)x, (float*)part, c, bm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_finalize_kernel<<<(c + 31) / 32, dim3(32, 32), 0, s>>>(
      (const float*)part, (float*)out, groups, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
