// Flash attention on fp32 operands: forward, dK/dV and dQ kernels in
// fp32 FMA (SIMT), the fp32 forms of K1-K3 (flash_attention.cuh has the
// 16-bit forms, on wgmma).
//
// flash_fwd_fp32_kernel  replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel
// flash_dkv_fp32_kernel  replaces horovod_tpu/ops/flash_attention.py::_dkv_kernel
// flash_dq_fp32_kernel   replaces horovod_tpu/ops/flash_attention.py::_dq_kernel
//   on fp32 operands, where JAX's products are fp32 x fp32 with fp32
//   accumulation (preferred_element_type=jnp.float32 on fp32 inputs). A
//   single TF32 pass on the tensor cores keeps ~10 bits and cannot hold
//   fp32's tolerance, so every product here is an fp32 FMA. Bound on an
//   H100 SXM at the flagship shape (BH=48, S=2048, D=128, causal): 2
//   causal products = 51.6 GFLOP / 67 TFLOP/s = 0.77 ms (K1); 4 and 3
//   products (K2, K3). The design is the simplest that is right: no
//   register blocking beyond a row per 8 threads, so shared-memory
//   loads, not FMAs, set the pace.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, d] fp32, contiguous, d a
// multiple of 4 up to W (the wrapper pads every head dim to a multiple
// of 16, and above 256 to a multiple of 128); lse and delta are [BH, S]
// fp32. W (64, 128 or 256) sizes the shared-memory rows and the
// per-thread accumulators; d is a runtime argument, so one kernel serves
// every head dim up to its W. Above 256 the _wide kernels take d in
// 128-column chunks (the section "Head dims above 256").
//
// Each CTA of 256 threads owns 32 rows (q rows for K1 and K3, key rows
// for K2), 8 threads a row, and loops over 32-row tiles of the other
// operand, loaded whole into shared memory (rows padded by 4 floats: the
// 8 threads of a row read 8 distinct 16-byte bank groups). A thread
// holds 4 of its row's 32 scores (columns sub + 8 i) and the output
// columns 4 (sub + 8 g) .. +3 of its row; a product's 32 terms reach the
// row's 8 threads by shuffles. The numerics are JAX's on fp32: q * scale
// in fp32, masked scores -1e30, exp(s - m) online (K1) or exp(s - lse)
// (K2, K3), lse = m + log(max(l, 1e-30)), dQ scaled once at the end.
// Each output has one owner CTA: no atomics, and repeats are
// bit-identical. Kernels launch on the caller's stream, allocate nothing
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 32;    // rows a CTA owns
constexpr int kCols = 32;    // rows of the streamed operand per tile
constexpr int kLanes = 8;    // threads of one owned row
constexpr int kThreads = kRows * kLanes;
constexpr int kPer = kCols / kLanes;   // scores a thread holds per tile

template <int W>
struct Simt {
  static constexpr int kLd = W + 4;       // floats per shared-memory row
  static constexpr int kLd4 = kLd / 4;    // float4s per row
  static constexpr int kTile = kRows * kLd;  // floats of one 32-row tile
};

// Rows row0..row0+31 of a [seq, d] matrix into a 32-row tile, times
// `scale` when SCALED; rows past seq and columns past d are zeros.
template <int W, bool SCALED>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int seq, int d,
                                          float scale) {
  constexpr int kPerRow = W / 4;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq && c < d) {
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * d + c);
      if (SCALED) {
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
    }
    *reinterpret_cast<float4*>(dst + r * Simt<W>::kLd + c) = x;
  }
}

// out[i] (+)= a . b_i over d columns: a one row, b_i the rows sub + 8 i of
// a tile (4 rows), both in shared memory.
template <int W>
__device__ __forceinline__ void dots(float (&out)[kPer], const float* a,
                                     const float* tile, int sub, int d) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* t4 = reinterpret_cast<const float4*>(tile);
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[i] = 0.f;
  for (int c = 0; c < d / 4; ++c) {
    const float4 x = a4[c];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float4 y = t4[(sub + kLanes * i) * Simt<W>::kLd4 + c];
      out[i] = fmaf(x.x, y.x, out[i]);
      out[i] = fmaf(x.y, y.y, out[i]);
      out[i] = fmaf(x.z, y.z, out[i]);
      out[i] = fmaf(x.w, y.w, out[i]);
    }
  }
}

// acc[g] += sum over the tile's 32 rows j of w_j * tile[j][cols of g],
// w_j held by thread (lane & ~7) + j % 8 of this row as its w[j / 8].
template <int W>
__device__ __forceinline__ void accumulate(float (&acc)[W / 32][4],
                                           const float (&w)[kPer],
                                           const float* tile, int sub) {
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  const int base = (threadIdx.x % 32) & ~(kLanes - 1);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float wj = __shfl_sync(0xffffffffu, w[j / kLanes],
                                 base + j % kLanes);
#pragma unroll
    for (int g = 0; g < W / 32; ++g) {
      const float4 y = t4[j * Simt<W>::kLd4 + sub + kLanes * g];
      acc[g][0] = fmaf(wj, y.x, acc[g][0]);
      acc[g][1] = fmaf(wj, y.y, acc[g][1]);
      acc[g][2] = fmaf(wj, y.z, acc[g][2]);
      acc[g][3] = fmaf(wj, y.w, acc[g][3]);
    }
  }
}

__device__ __forceinline__ bool valid_pair(int qrow, int kcol, int sq,
                                           int sk, int causal) {
  return qrow < sq && kcol < sk && (!causal || qrow >= kcol);
}

// Store a thread's output columns of one row (scaled by `mul`), those
// inside d.
template <int W>
__device__ __forceinline__ void store_row(float* row, const float (&acc)[W / 32][4],
                                          int sub, int d, float mul) {
#pragma unroll
  for (int g = 0; g < W / 32; ++g) {
    const int c = 4 * (sub + kLanes * g);
    if (c < d) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(acc[g][0] * mul, acc[g][1] * mul, acc[g][2] * mul,
                      acc[g][3] * mul);
    }
  }
}

// Key tiles a q tile starting at q0 reaches.
__device__ __forceinline__ int key_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + kCols - 1) / kCols;
  if (causal) n = min(n, (min(q0 + kRows, sq) - 1) / kCols + 1);
  return n;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int d,
                      float qscale, int causal) {
  using L = Simt<W>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + L::kTile;
  float* sV = sK + L::kTile;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  q += (size_t)bh * sq * d;
  o += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int row = q0 + r;

  load_rows<W, true>(sQ, q, q0, sq, d, qscale);
  float acc[W / 32][4];
#pragma unroll
  for (int g = 0; g < W / 32; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  float m = kNegInf, l = 0.f;
  const int n_kt = key_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();  // the previous tile's reads are done
    load_rows<W, false>(sK, k, k0, sk, d, 1.f);
    load_rows<W, false>(sV, v, k0, sk, d, 1.f);
    __syncthreads();
    float s[kPer];
    dots<W>(s, sQ + r * L::kLd, sK, sub, d);
    float mx = m;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)) s[i] = kNegInf;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off *= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)
                          ? expf(s[i] - mx) : 0.f;
      s[i] = p;
      l += p;
    }
#pragma unroll
    for (int g = 0; g < W / 32; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
    }
    accumulate<W>(acc, s, sV, sub);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  l = fmaxf(l, 1e-30f);
  if (row < sq) {
    store_row<W>(o + (size_t)row * d, acc, sub, d, 1.f / l);
    if (sub == 0) lse[row] = m + logf(l);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int sk, int d,
                      float qscale, int causal) {
  using L = Simt<W>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + L::kTile;
  float* sQ = sV + L::kTile;
  float* sO = sQ + L::kTile;
  float* sLse = sO + L::kTile;   // [32] lse, then [32] delta
  float* sDel = sLse + kCols;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dk += (size_t)bh * sk * d;
  dv += (size_t)bh * sk * d;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int key = k0 + r;

  load_rows<W, false>(sK, k, k0, sk, d, 1.f);
  load_rows<W, false>(sV, v, k0, sk, d, 1.f);
  float dka[W / 32][4], dva[W / 32][4];
#pragma unroll
  for (int g = 0; g < W / 32; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[g][e] = dva[g][e] = 0.f;
  }
  const int n_qt = (sq + kCols - 1) / kCols;
  for (int qt = causal ? k0 / kCols : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    __syncthreads();  // the previous tile's reads are done
    load_rows<W, true>(sQ, q, q0, sq, d, qscale);
    load_rows<W, false>(sO, dout, q0, sq, d, 1.f);
    if (threadIdx.x < 2 * kCols) {
      const int qi = q0 + threadIdx.x % kCols;
      const float* src = threadIdx.x < kCols ? lse : delta;
      sLse[threadIdx.x] = qi < sq ? src[qi] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T of this key row against q rows sub + 8 i.
    float st[kPer], dpt[kPer];
    dots<W>(st, sK + r * L::kLd, sQ, sub, d);
    dots<W>(dpt, sV + r * L::kLd, sO, sub, d);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qc = sub + kLanes * i;
      const float p = valid_pair(q0 + qc, key, sq, sk, causal)
                          ? expf(st[i] - sLse[qc]) : 0.f;
      st[i] = p;                        // P^T
      dpt[i] = p * (dpt[i] - sDel[qc]);  // dS^T
    }
    accumulate<W>(dva, st, sO, sub);    // dV += P^T dO
    accumulate<W>(dka, dpt, sQ, sub);   // dK += dS^T Qs
  }
  if (key < sk) {
    store_row<W>(dk + (size_t)key * d, dka, sub, d, 1.f);
    store_row<W>(dv + (size_t)key * d, dva, sub, d, 1.f);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
flash_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int sq, int sk, int d, float qscale, float scale,
                     int causal) {
  using L = Simt<W>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + L::kTile;
  float* sK = sO + L::kTile;
  float* sV = sK + L::kTile;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  dq += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int row = q0 + r;
  const float lse_r = row < sq ? lse[row] : 0.f;
  const float del_r = row < sq ? delta[row] : 0.f;

  load_rows<W, true>(sQ, q, q0, sq, d, qscale);
  load_rows<W, false>(sO, dout, q0, sq, d, 1.f);
  float dqa[W / 32][4];
#pragma unroll
  for (int g = 0; g < W / 32; ++g) dqa[g][0] = dqa[g][1] = dqa[g][2] = dqa[g][3] = 0.f;
  const int n_kt = key_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();  // the previous tile's reads are done
    load_rows<W, false>(sK, k, k0, sk, d, 1.f);
    load_rows<W, false>(sV, v, k0, sk, d, 1.f);
    __syncthreads();
    float s[kPer], dp[kPer];
    dots<W>(s, sQ + r * L::kLd, sK, sub, d);
    dots<W>(dp, sO + r * L::kLd, sV, sub, d);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)
                          ? expf(s[i] - lse_r) : 0.f;
      s[i] = p * (dp[i] - del_r);  // dS
    }
    accumulate<W>(dqa, s, sK, sub);   // dQ += dS K
  }
  if (row < sq) store_row<W>(dq + (size_t)row * d, dqa, sub, d, scale);
}

// ---------------------------------------------------------------------------
// Head dims above 256: the _wide kernels
// ---------------------------------------------------------------------------
//
// d a runtime multiple of 128 (the wrapper zero-pads any other head dim
// above 256 to one), nc = d / 128 chunks. Each CTA owns one 128-column
// chunk c = blockIdx.z of its output; the dot products that sum over d
// (Q K^T, and dO V^T in K2 and K3) stream d through shared memory one
// 128-column chunk at a time, every tile 32 x 128 as at W = 128, and keep
// adding to the same fp32 sums. K2 and K3 visit the chunks from c + 1
// round to c, so the last chunk loaded is the one their accumulate reads
// (dO and Qs in K2, K in K3); K1 loads V's chunk c with its last chunk.
// Each CTA recomputes the scores over the whole d.

constexpr int kWide = 128;
using Wide = Simt<kWide>;

// Rows row0..row0+31, columns col0..col0+127 of a [seq, ld] matrix into a
// 32-row tile, times `scale` when SCALED; rows past seq are zeros.
template <bool SCALED>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int seq, int ld,
                                           int col0, float scale) {
  constexpr int kPerRow = kWide / 4;
  for (int idx = threadIdx.x; idx < kRows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) {
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * ld +
                                           col0 + c);
      if (SCALED) {
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
    }
    *reinterpret_cast<float4*>(dst + r * Wide::kLd + c) = x;
  }
}

// out[i] += a . b_i over one 128-column chunk (dots without the reset).
__device__ __forceinline__ void dots_more(float (&out)[kPer], const float* a,
                                          const float* tile, int sub) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  for (int c = 0; c < kWide / 4; ++c) {
    const float4 x = a4[c];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float4 y = t4[(sub + kLanes * i) * Wide::kLd4 + c];
      out[i] = fmaf(x.x, y.x, out[i]);
      out[i] = fmaf(x.y, y.y, out[i]);
      out[i] = fmaf(x.z, y.z, out[i]);
      out[i] = fmaf(x.w, y.w, out[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int sq, int sk, int d,
                           float qscale, int causal) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Wide::kTile;
  float* sV = sK + Wide::kTile;
  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  q += (size_t)bh * sq * d;
  o += (size_t)bh * sq * d + c * kWide;
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int row = q0 + r;

  float acc[kWide / 32][4];
#pragma unroll
  for (int g = 0; g < kWide / 32; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  float m = kNegInf, l = 0.f;
  const int n_kt = key_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    float s[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = 0.f;
    for (int dc = 0; dc < nc; ++dc) {
      __syncthreads();  // the previous chunk's reads are done
      load_chunk<true>(sQ, q, q0, sq, d, dc * kWide, qscale);
      load_chunk<false>(sK, k, k0, sk, d, dc * kWide, 1.f);
      if (dc == nc - 1) load_chunk<false>(sV, v, k0, sk, d, c * kWide, 1.f);
      __syncthreads();
      dots_more(s, sQ + r * Wide::kLd, sK, sub);
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)) s[i] = kNegInf;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off *= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)
                          ? expf(s[i] - mx) : 0.f;
      s[i] = p;
      l += p;
    }
#pragma unroll
    for (int g = 0; g < kWide / 32; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
    }
    accumulate<kWide>(acc, s, sV, sub);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  l = fmaxf(l, 1e-30f);
  if (row < sq) {
    store_row<kWide>(o + (size_t)row * d, acc, sub, kWide, 1.f / l);
    if (sub == 0 && c == 0) lse[row] = m + logf(l);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_dkv_fp32_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int sq, int sk, int d, float qscale, int causal) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + Wide::kTile;
  float* sQ = sV + Wide::kTile;
  float* sO = sQ + Wide::kTile;
  float* sLse = sO + Wide::kTile;   // [32] lse, then [32] delta
  float* sDel = sLse + kCols;
  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dk += (size_t)bh * sk * d + c * kWide;
  dv += (size_t)bh * sk * d + c * kWide;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int key = k0 + r;

  float dka[kWide / 32][4], dva[kWide / 32][4];
#pragma unroll
  for (int g = 0; g < kWide / 32; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[g][e] = dva[g][e] = 0.f;
  }
  const int n_qt = (sq + kCols - 1) / kCols;
  for (int qt = causal ? k0 / kCols : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    float st[kPer], dpt[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) st[i] = dpt[i] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int col = ((c + 1 + j) % nc) * kWide;
      __syncthreads();  // the previous chunk's reads are done
      load_chunk<false>(sK, k, k0, sk, d, col, 1.f);
      load_chunk<false>(sV, v, k0, sk, d, col, 1.f);
      load_chunk<true>(sQ, q, q0, sq, d, col, qscale);
      load_chunk<false>(sO, dout, q0, sq, d, col, 1.f);
      if (j == nc - 1 && threadIdx.x < 2 * kCols) {
        const int qi = q0 + threadIdx.x % kCols;
        const float* src = threadIdx.x < kCols ? lse : delta;
        sLse[threadIdx.x] = qi < sq ? src[qi] : 0.f;
      }
      __syncthreads();
      dots_more(st, sK + r * Wide::kLd, sQ, sub);
      dots_more(dpt, sV + r * Wide::kLd, sO, sub);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qc = sub + kLanes * i;
      const float p = valid_pair(q0 + qc, key, sq, sk, causal)
                          ? expf(st[i] - sLse[qc]) : 0.f;
      st[i] = p;                        // P^T
      dpt[i] = p * (dpt[i] - sDel[qc]);  // dS^T
    }
    accumulate<kWide>(dva, st, sO, sub);    // dV += P^T dO, chunk c
    accumulate<kWide>(dka, dpt, sQ, sub);   // dK += dS^T Qs, chunk c
  }
  if (key < sk) {
    store_row<kWide>(dk + (size_t)key * d, dka, sub, kWide, 1.f);
    store_row<kWide>(dv + (size_t)key * d, dva, sub, kWide, 1.f);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_dq_fp32_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int sq, int sk, int d,
                          float qscale, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + Wide::kTile;
  float* sK = sO + Wide::kTile;
  float* sV = sK + Wide::kTile;
  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  dq += (size_t)bh * sq * d + c * kWide;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int row = q0 + r;
  const float lse_r = row < sq ? lse[row] : 0.f;
  const float del_r = row < sq ? delta[row] : 0.f;

  float dqa[kWide / 32][4];
#pragma unroll
  for (int g = 0; g < kWide / 32; ++g) dqa[g][0] = dqa[g][1] = dqa[g][2] = dqa[g][3] = 0.f;
  const int n_kt = key_tiles(q0, sq, sk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int col = ((c + 1 + j) % nc) * kWide;
      __syncthreads();  // the previous chunk's reads are done
      load_chunk<true>(sQ, q, q0, sq, d, col, qscale);
      load_chunk<false>(sO, dout, q0, sq, d, col, 1.f);
      load_chunk<false>(sK, k, k0, sk, d, col, 1.f);
      load_chunk<false>(sV, v, k0, sk, d, col, 1.f);
      __syncthreads();
      dots_more(s, sQ + r * Wide::kLd, sK, sub);
      dots_more(dp, sO + r * Wide::kLd, sV, sub);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = valid_pair(row, k0 + sub + kLanes * i, sq, sk, causal)
                          ? expf(s[i] - lse_r) : 0.f;
      s[i] = p * (dp[i] - del_r);  // dS
    }
    accumulate<kWide>(dqa, s, sK, sub);   // dQ += dS K, chunk c
  }
  if (row < sq) store_row<kWide>(dq + (size_t)row * d, dqa, sub, kWide, scale);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// fn(std::integral_constant<int, W>) for the smallest W of 64, 128, 256
// that holds d; cudaErrorInvalidValue past 256 or for a d not a
// multiple of 4.
template <typename F>
cudaError_t dispatch_w(int d, F fn) {
  if (d < 4 || d % 4) return cudaErrorInvalidValue;
  if (d <= 64) return fn(std::integral_constant<int, 64>{});
  if (d <= 128) return fn(std::integral_constant<int, 128>{});
  if (d <= 256) return fn(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points with the arguments of the 16-bit forms' (d is the
// head dim), bound with ctypes; each returns a cudaError_t.
extern "C" {

int hvd_flash_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, int d, float qscale,
                       int causal, void* stream) {
  if (d > 256) {
    if (d % kWide) return cudaErrorInvalidValue;
    constexpr int smem = 3 * Wide::kTile * 4;
    cudaError_t err = prepare(flash_fwd_fp32_wide_kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sq + kRows - 1) / kRows, d / kWide);
    flash_fwd_fp32_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  }
  return dispatch_w(d, [&](auto w) {
    constexpr int W = decltype(w)::value;
    constexpr int smem = 3 * Simt<W>::kTile * 4;
    cudaError_t err = prepare(flash_fwd_fp32_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sq + kRows - 1) / kRows);
    flash_fwd_fp32_kernel<W><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  });
}

int hvd_flash_dkv_fp32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       float qscale, int causal, void* stream) {
  if (d > 256) {
    if (d % kWide) return cudaErrorInvalidValue;
    constexpr int smem = (4 * Wide::kTile + 2 * kCols) * 4;
    cudaError_t err = prepare(flash_dkv_fp32_wide_kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sk + kRows - 1) / kRows, d / kWide);
    flash_dkv_fp32_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  }
  return dispatch_w(d, [&](auto w) {
    constexpr int W = decltype(w)::value;
    constexpr int smem = (4 * Simt<W>::kTile + 2 * kCols) * 4;
    cudaError_t err = prepare(flash_dkv_fp32_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sk + kRows - 1) / kRows);
    flash_dkv_fp32_kernel<W><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  });
}

int hvd_flash_dq_fp32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, int d, float qscale,
                      float scale, int causal, void* stream) {
  if (d > 256) {
    if (d % kWide) return cudaErrorInvalidValue;
    constexpr int smem = 4 * Wide::kTile * 4;
    cudaError_t err = prepare(flash_dq_fp32_wide_kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sq + kRows - 1) / kRows, d / kWide);
    flash_dq_fp32_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, sq, sk, d, qscale, scale, causal);
    return cudaGetLastError();
  }
  return dispatch_w(d, [&](auto w) {
    constexpr int W = decltype(w)::value;
    constexpr int smem = 4 * Simt<W>::kTile * 4;
    cudaError_t err = prepare(flash_dq_fp32_kernel<W>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sq + kRows - 1) / kRows);
    flash_dq_fp32_kernel<W><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, sq, sk, d, qscale, scale, causal);
    return cudaGetLastError();
  });
}

}  // extern "C"
