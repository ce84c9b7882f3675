// Fused batch-norm(+residual)(+ReLU) for Hopper (sm_90a): the four passes
// of horovod_tpu/ops/fused_bn.py as CUDA kernels.
//
// Layout: x, r, da, y, dx, dr are [M, C] bf16, row-major (channels last,
// M = N*H*W); mean, rstd, scale, shift, g1, g2 are [C] fp32. Any M and C:
// a thread owns VEC adjacent channels (VEC = 8, one 16-byte load per row,
// where C % 8 == 0 and the pointers are 16-byte aligned; else VEC = 1).
//
// Grid: (channel tiles of 8*VEC channels) x (G row chunks); a block of
// 8 x 32 threads walks its chunk 32 rows at a time, two rows per step in
// flight, with its channels' per-channel vectors held in registers. G is
// chosen by the caller (ops/fused_bn.py::row_chunks) to fill the SMs with
// one wave; it depends only on M, C and the card.
//
// bn_stats_kernel      replaces horovod_tpu/ops/fused_bn.py::_stats_kernel
//   Per-channel fp32 sum(x), sum(x^2). Each thread sums its rows in order,
//   the block reduces over its 32 row lanes in shared memory in a fixed
//   tree, and writes [2, G, C] partials; bn_finalize_kernel (a second,
//   small launch) sums the G partials of each channel in a fixed order.
//   No float atomics, so two calls give bit-identical sums.
// bn_norm_kernel       replaces fused_bn.py::_norm_kernel
//   y = [relu](x*scale + shift [+ r]) in fp32, stored as bf16.
// bn_bwd_reduce_kernel replaces fused_bn.py::_bwd_reduce_kernel
//   s1 = sum(dy), s2 = sum(dy * x_hat), dy = da * [z > 0] under ReLU with
//   z recomputed from x (and r); the same partials + finalize as stats.
// bn_bwd_dx_kernel     replaces fused_bn.py::_bwd_dx_kernel
//   dx = scale * ((dy - g1*inv_m) - x_hat * (g2*inv_m)) and dr = dy.
//
// Bound: every kernel streams its [M, C] operands once and does a few
// fp32 operations per element, so all four are bound by device memory
// (at M = 802816, C = 256 on an H100 SXM: 411 MB per bf16 operand, 123 us
// at 3.35 TB/s). The design reads each operand once with 16-byte loads
// along C (neighbouring threads on neighbouring addresses), converts bf16
// to fp32 in registers, keeps every per-channel value in registers, and
// issues two rows' loads before using them.
//
// The elementwise arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn so that no
// multiply-add is contracted: y, dx, dr and the ReLU mask round exactly as
// the plain PyTorch versions do, one fp32 operation at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTX = 8;    // threads across a channel tile
constexpr int kTY = 32;   // row lanes of a block
constexpr int kThreads = kTX * kTY;

template <int VEC> struct Vec;

template <> struct Vec<8> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[1]) {
    f[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[1]) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* v, int c0, float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = v[c0 + k];
}

// The rows [lo, hi) of the block's chunk.
__device__ __forceinline__ void chunk_rows(int m, int chunk, int64_t& lo,
                                           int64_t& hi) {
  lo = (int64_t)blockIdx.y * chunk;
  hi = lo + chunk;
  if (hi > m) hi = m;
}

// Pre-ReLU z = x*scale + shift [+ r], rounded one operation at a time.
template <bool RES>
__device__ __forceinline__ float pre_relu(float x, float r, float sc, float sh) {
  float z = __fadd_rn(__fmul_rn(x, sc), sh);
  if (RES) z = __fadd_rn(z, r);
  return z;
}

// Sum a[VEC], b[VEC] over the block's 32 row lanes in a fixed tree and write
// them to part[0][g][c0..], part[1][g][c0..].
template <int VEC>
__device__ __forceinline__ void block_partials(const float (&a)[VEC],
                                               const float (&b)[VEC],
                                               float* part, int c, int c0,
                                               bool live) {
  constexpr int kW = kTX * VEC;
  __shared__ float sa[kTY][kW];
  __shared__ float sb[kTY][kW];
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sa[ty][tx * VEC + k] = a[k];
    sb[ty][tx * VEC + k] = b[k];
  }
  __syncthreads();
#pragma unroll
  for (int s = kTY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sa[ty][tx * VEC + k] += sa[ty + s][tx * VEC + k];
        sb[ty][tx * VEC + k] += sb[ty + s][tx * VEC + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const int64_t g = blockIdx.y, G = gridDim.y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      part[g * c + c0 + k] = sa[0][tx * VEC + k];
      part[(G + g) * c + c0 + k] = sb[0][tx * VEC + k];
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int m,
                int c, int chunk) {
  const int c0 = (blockIdx.x * kTX + threadIdx.x) * VEC;
  const bool live = c0 < c;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  if (live) {
    int64_t lo, hi;
    chunk_rows(m, chunk, lo, hi);
    int64_t row = lo + threadIdx.y;
    for (; row + kTY < hi; row += 2 * kTY) {
      float v0[VEC], v1[VEC];
      Vec<VEC>::load(x + row * c + c0, v0);
      Vec<VEC>::load(x + (row + kTY) * c + c0, v1);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += v0[k];
        s2[k] = fmaf(v0[k], v0[k], s2[k]);
        s1[k] += v1[k];
        s2[k] = fmaf(v1[k], v1[k], s2[k]);
      }
    }
    if (row < hi) {
      float v0[VEC];
      Vec<VEC>::load(x + row * c + c0, v0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += v0[k];
        s2[k] = fmaf(v0[k], v0[k], s2[k]);
      }
    }
  }
  block_partials<VEC>(s1, s2, part, c, c0, live);
}

// out[0][ch], out[1][ch] = sum over g of part[0|1][g][ch], in a fixed order:
// 32 lanes each sum every 32nd partial, then a fixed tree over the lanes.
__global__ void __launch_bounds__(1024)
bn_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int groups, int c) {
  __shared__ float s[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  const int which = blockIdx.y;
  const float* p = part + (int64_t)which * groups * c;
  float acc = 0.f;
  if (ch < c) {
    for (int g = ty; g < groups; g += 32) acc += p[(int64_t)g * c + ch];
  }
  s[ty][tx] = acc;
  __syncthreads();
#pragma unroll
  for (int st = 16; st > 0; st >>= 1) {
    if (ty < st) s[ty][tx] += s[ty + st][tx];
    __syncthreads();
  }
  if (ty == 0 && ch < c) out[(int64_t)which * c + ch] = s[0][tx];
}

template <int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
bn_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
               const float* __restrict__ scale, const float* __restrict__ shift,
               bf16* __restrict__ y, int m, int c, int chunk) {
  const int c0 = (blockIdx.x * kTX + threadIdx.x) * VEC;
  if (c0 >= c) return;
  float sc[VEC], sh[VEC];
  load_vec<VEC>(scale, c0, sc);
  load_vec<VEC>(shift, c0, sh);
  int64_t lo, hi;
  chunk_rows(m, chunk, lo, hi);
  for (int64_t row = lo + threadIdx.y; row < hi; row += 2 * kTY) {
    const bool two = row + kTY < hi;
    float xv[2][VEC], rv[2][VEC];
    Vec<VEC>::load(x + row * c + c0, xv[0]);
    if (RES) Vec<VEC>::load(r + row * c + c0, rv[0]);
    if (two) {
      Vec<VEC>::load(x + (row + kTY) * c + c0, xv[1]);
      if (RES) Vec<VEC>::load(r + (row + kTY) * c + c0, rv[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      float out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float z = pre_relu<RES>(xv[u][k], RES ? rv[u][k] : 0.f, sc[k], sh[k]);
        out[k] = RELU ? fmaxf(z, 0.f) : z;
      }
      Vec<VEC>::store(y + (row + u * kTY) * c + c0, out);
    }
  }
}

// dy for one element: da, masked by the recomputed ReLU.
template <bool RELU, bool RES>
__device__ __forceinline__ float masked(float x, float da, float r, float sc,
                                        float sh) {
  if (!RELU) return da;
  return pre_relu<RES>(x, r, sc, sh) > 0.f ? da : 0.f;
}

template <int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
bn_bwd_reduce_kernel(const bf16* __restrict__ x, const bf16* __restrict__ da,
                     const bf16* __restrict__ r, const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ part,
                     int m, int c, int chunk) {
  const int c0 = (blockIdx.x * kTX + threadIdx.x) * VEC;
  const bool live = c0 < c;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
  if (live) {
    float mu[VEC], rs[VEC], sc[VEC], sh[VEC];
    load_vec<VEC>(mean, c0, mu);
    load_vec<VEC>(rstd, c0, rs);
    load_vec<VEC>(scale, c0, sc);
    load_vec<VEC>(shift, c0, sh);
    int64_t lo, hi;
    chunk_rows(m, chunk, lo, hi);
    for (int64_t row = lo + threadIdx.y; row < hi; row += 2 * kTY) {
      const bool two = row + kTY < hi;
      float xv[2][VEC], dv[2][VEC], rv[2][VEC];
      Vec<VEC>::load(x + row * c + c0, xv[0]);
      Vec<VEC>::load(da + row * c + c0, dv[0]);
      if (RELU && RES) Vec<VEC>::load(r + row * c + c0, rv[0]);
      if (two) {
        Vec<VEC>::load(x + (row + kTY) * c + c0, xv[1]);
        Vec<VEC>::load(da + (row + kTY) * c + c0, dv[1]);
        if (RELU && RES) Vec<VEC>::load(r + (row + kTY) * c + c0, rv[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float dy = masked<RELU, RES>(xv[u][k], dv[u][k],
                                             (RELU && RES) ? rv[u][k] : 0.f,
                                             sc[k], sh[k]);
          const float xhat = __fmul_rn(__fsub_rn(xv[u][k], mu[k]), rs[k]);
          s1[k] += dy;
          s2[k] = fmaf(dy, xhat, s2[k]);
        }
      }
    }
  }
  block_partials<VEC>(s1, s2, part, c, c0, live);
}

template <int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
bn_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ da,
                 const bf16* __restrict__ r, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ scale,
                 const float* __restrict__ shift, const float* __restrict__ g1,
                 const float* __restrict__ g2, float inv_m,
                 bf16* __restrict__ dx, bf16* __restrict__ dr, int m, int c,
                 int chunk) {
  const int c0 = (blockIdx.x * kTX + threadIdx.x) * VEC;
  if (c0 >= c) return;
  float mu[VEC], rs[VEC], sc[VEC], sh[VEC], a1[VEC], a2[VEC];
  load_vec<VEC>(mean, c0, mu);
  load_vec<VEC>(rstd, c0, rs);
  load_vec<VEC>(scale, c0, sc);
  load_vec<VEC>(shift, c0, sh);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a1[k] = __fmul_rn(g1[c0 + k], inv_m);
    a2[k] = __fmul_rn(g2[c0 + k], inv_m);
  }
  int64_t lo, hi;
  chunk_rows(m, chunk, lo, hi);
  for (int64_t row = lo + threadIdx.y; row < hi; row += 2 * kTY) {
    const bool two = row + kTY < hi;
    float xv[2][VEC], dv[2][VEC], rv[2][VEC];
    Vec<VEC>::load(x + row * c + c0, xv[0]);
    Vec<VEC>::load(da + row * c + c0, dv[0]);
    if (RELU && RES) Vec<VEC>::load(r + row * c + c0, rv[0]);
    if (two) {
      Vec<VEC>::load(x + (row + kTY) * c + c0, xv[1]);
      Vec<VEC>::load(da + (row + kTY) * c + c0, dv[1]);
      if (RELU && RES) Vec<VEC>::load(r + (row + kTY) * c + c0, rv[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      float dxo[VEC], dro[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float dy = masked<RELU, RES>(xv[u][k], dv[u][k],
                                           (RELU && RES) ? rv[u][k] : 0.f,
                                           sc[k], sh[k]);
        const float xhat = __fmul_rn(__fsub_rn(xv[u][k], mu[k]), rs[k]);
        dro[k] = dy;
        dxo[k] = __fmul_rn(sc[k], __fsub_rn(__fsub_rn(dy, a1[k]),
                                            __fmul_rn(xhat, a2[k])));
      }
      const int64_t off = (row + u * kTY) * c + c0;
      Vec<VEC>::store(dx + off, dxo);
      if (RES) Vec<VEC>::store(dr + off, dro);
    }
  }
}

dim3 grid_of(int c, int groups, int vec) {
  return dim3((c + kTX * vec - 1) / (kTX * vec), groups);
}

int chunk_of(int m, int groups) { return (m + groups - 1) / groups; }

template <int VEC>
int launch_stats(const void* x, void* part, void* out, int m, int c, int g,
                 cudaStream_t s) {
  bn_stats_kernel<VEC><<<grid_of(c, g, VEC), dim3(kTX, kTY), 0, s>>>(
      (const bf16*)x, (float*)part, m, c, chunk_of(m, g));
  return (int)cudaGetLastError();
}

int launch_finalize(const void* part, void* out, int c, int g, cudaStream_t s) {
  bn_finalize_kernel<<<dim3((c + 31) / 32, 2), dim3(32, 32), 0, s>>>(
      (const float*)part, (float*)out, g, c);
  return (int)cudaGetLastError();
}

template <int VEC, bool RELU, bool RES>
int launch_norm(const void* x, const void* r, const void* scale,
                const void* shift, void* y, int m, int c, int g,
                cudaStream_t s) {
  bn_norm_kernel<VEC, RELU, RES><<<grid_of(c, g, VEC), dim3(kTX, kTY), 0, s>>>(
      (const bf16*)x, (const bf16*)r, (const float*)scale,
      (const float*)shift, (bf16*)y, m, c, chunk_of(m, g));
  return (int)cudaGetLastError();
}

template <int VEC, bool RELU, bool RES>
int launch_reduce(const void* x, const void* da, const void* r,
                  const void* mean, const void* rstd, const void* scale,
                  const void* shift, void* part, int m, int c, int g,
                  cudaStream_t s) {
  bn_bwd_reduce_kernel<VEC, RELU, RES>
      <<<grid_of(c, g, VEC), dim3(kTX, kTY), 0, s>>>(
          (const bf16*)x, (const bf16*)da, (const bf16*)r, (const float*)mean,
          (const float*)rstd, (const float*)scale, (const float*)shift,
          (float*)part, m, c, chunk_of(m, g));
  return (int)cudaGetLastError();
}

template <int VEC, bool RELU, bool RES>
int launch_dx(const void* x, const void* da, const void* r, const void* mean,
              const void* rstd, const void* scale, const void* shift,
              const void* g1, const void* g2, float inv_m, void* dx, void* dr,
              int m, int c, int g, cudaStream_t s) {
  bn_bwd_dx_kernel<VEC, RELU, RES><<<grid_of(c, g, VEC), dim3(kTX, kTY), 0, s>>>(
      (const bf16*)x, (const bf16*)da, (const bf16*)r, (const float*)mean,
      (const float*)rstd, (const float*)scale, (const float*)shift,
      (const float*)g1, (const float*)g2, inv_m, (bf16*)dx, (bf16*)dr, m, c,
      chunk_of(m, g));
  return (int)cudaGetLastError();
}

template <int VEC>
int norm_variant(const void* x, const void* r, const void* scale,
                 const void* shift, void* y, int m, int c, int g, int relu,
                 cudaStream_t s) {
  if (relu && r) return launch_norm<VEC, true, true>(x, r, scale, shift, y, m, c, g, s);
  if (relu) return launch_norm<VEC, true, false>(x, r, scale, shift, y, m, c, g, s);
  if (r) return launch_norm<VEC, false, true>(x, r, scale, shift, y, m, c, g, s);
  return launch_norm<VEC, false, false>(x, r, scale, shift, y, m, c, g, s);
}

// Without ReLU the residual does not enter the reduction: two variants
// under ReLU, one without.
template <int VEC>
int reduce_variant(const void* x, const void* da, const void* r,
                   const void* mean, const void* rstd, const void* scale,
                   const void* shift, void* part, int m, int c, int g,
                   int relu, cudaStream_t s) {
  if (relu && r)
    return launch_reduce<VEC, true, true>(x, da, r, mean, rstd, scale, shift, part, m, c, g, s);
  if (relu)
    return launch_reduce<VEC, true, false>(x, da, r, mean, rstd, scale, shift, part, m, c, g, s);
  return launch_reduce<VEC, false, false>(x, da, r, mean, rstd, scale, shift, part, m, c, g, s);
}

template <int VEC>
int dx_variant(const void* x, const void* da, const void* r, const void* mean,
               const void* rstd, const void* scale, const void* shift,
               const void* g1, const void* g2, float inv_m, void* dx, void* dr,
               int m, int c, int g, int relu, cudaStream_t s) {
  if (relu && r)
    return launch_dx<VEC, true, true>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, s);
  if (relu)
    return launch_dx<VEC, true, false>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, s);
  if (r)
    return launch_dx<VEC, false, true>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, s);
  return launch_dx<VEC, false, false>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, s);
}

bool bad_args(int m, int c, int g, int vec) {
  return m < 1 || c < 1 || g < 1 || g > 65535 || (vec != 1 && vec != 8) ||
         (vec == 8 && c % 8 != 0);
}

}  // namespace

extern "C" {

// out is [2, C]: sum(x), sum(x^2). part is [2, g, C] scratch.
int hvd_bn_stats(const void* x, void* part, void* out, int m, int c, int g,
                 int vec, void* stream) {
  if (bad_args(m, c, g, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vec == 8 ? launch_stats<8>(x, part, out, m, c, g, s)
                     : launch_stats<1>(x, part, out, m, c, g, s);
  if (err) return err;
  return launch_finalize(part, out, c, g, s);
}

// r may be null (no residual).
int hvd_bn_norm(const void* x, const void* r, const void* scale,
                const void* shift, void* y, int m, int c, int g, int relu,
                int vec, void* stream) {
  if (bad_args(m, c, g, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec == 8 ? norm_variant<8>(x, r, scale, shift, y, m, c, g, relu, s)
                  : norm_variant<1>(x, r, scale, shift, y, m, c, g, relu, s);
}

// out is [2, C]: sum(dy), sum(dy * x_hat). part is [2, g, C] scratch.
int hvd_bn_bwd_reduce(const void* x, const void* da, const void* r,
                      const void* mean, const void* rstd, const void* scale,
                      const void* shift, void* part, void* out, int m, int c,
                      int g, int relu, int vec, void* stream) {
  if (bad_args(m, c, g, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vec == 8
      ? reduce_variant<8>(x, da, r, mean, rstd, scale, shift, part, m, c, g, relu, s)
      : reduce_variant<1>(x, da, r, mean, rstd, scale, shift, part, m, c, g, relu, s);
  if (err) return err;
  return launch_finalize(part, out, c, g, s);
}

// r and dr are both null or both set.
int hvd_bn_bwd_dx(const void* x, const void* da, const void* r,
                  const void* mean, const void* rstd, const void* scale,
                  const void* shift, const void* g1, const void* g2,
                  float inv_m, void* dx, void* dr, int m, int c, int g,
                  int relu, int vec, void* stream) {
  if (bad_args(m, c, g, vec) || (r == nullptr) != (dr == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec == 8
      ? dx_variant<8>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, relu, s)
      : dx_variant<1>(x, da, r, mean, rstd, scale, shift, g1, g2, inv_m, dx, dr, m, c, g, relu, s);
}

}  // extern "C"
