// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] bf16, contiguous;
// lse and delta are [BH, S] fp32 (the [BH, S, 1] tensors of the Python
// side). D is 64 or 128. All three kernels share one convention with the
// JAX package (horovod_tpu/ops/flash_attention.py):
//   - q is multiplied by the scale in bf16 before the QK^T product
//     (`qscale` is the scale already rounded to bf16 by the caller);
//   - masked scores are -1e30, not -inf;
//   - rows past the sequence are loaded as zeros before any product;
//   - P is cast to bf16 before P.V, dS to bf16 before dS.Q and dS.K;
//   - every product accumulates in fp32 (mma.sync m16n8k16 bf16->f32).
//
// One CTA of 4 warps owns a 64-row output tile; each warp owns 16 rows.
// The TPU grid's sequential innermost axis becomes a loop inside the CTA,
// so each output has exactly one owner and no atomics are needed.
//
// flash_fwd_kernel  replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel
//   One CTA per (bh, 64 q rows); loops over 64-key tiles up to the
//   diagonal, online softmax with m, l and the fp32 O accumulator in
//   registers; writes O and lse = m + log(max(l, 1e-30)).
//   Bound on an H100 SXM at the flagship shape (BH=48, S=2048, D=128,
//   causal): 2 causal products = 51.6 GFLOP / 989 TFLOP/s = 52 us against
//   101 MB / 3.35 TB/s = 30 us, so compute-bound.
// flash_dkv_kernel  replaces horovod_tpu/ops/flash_attention.py::_dkv_kernel
//   One CTA per (bh, 64 key rows); loops over q tiles from the diagonal
//   on, recomputing P^T = exp(K Qs^T - lse), accumulating dV += P^T dO and
//   dK += dS^T Qs in fp32 registers. 4 causal products = 103 GFLOP =
//   104 us at peak against 152 MB = 45 us: compute-bound.
// flash_dq_kernel   replaces horovod_tpu/ops/flash_attention.py::_dq_kernel
//   One CTA per (bh, 64 q rows); loops over key tiles up to the diagonal,
//   dQ += dS K, times the fp32 scale once at the end. 3 causal products =
//   77 GFLOP = 78 us at peak against 127 MB = 38 us: compute-bound.
//
// What this simple design leaves on the table: mma.sync runs at a
// fraction of the wgmma rate; tiles are loaded synchronously with plain
// 16-byte loads (no TMA, no cp.async pipeline, no overlap of loads with
// math); fragments are read from shared memory with 32-bit loads instead
// of ldmatrix; the transposed operands are written to shared memory by
// scalar stores with bank conflicts; dK/dV and dQ recompute P twice
// where a fused backward would do it once.

#include "flash_tile.cuh"

namespace {

constexpr int kRows = 64;      // rows of the tile a CTA owns
constexpr int kCols = 64;      // rows of the tile the inner loop streams
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;
// load_tile's default tile is this CTA's.
static_assert(kRows == 64 && kCols == 64 && kThreads == 128,
              "flash_tile.cuh's load_tile defaults assume a 64-row CTA of "
              "128 threads");

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float qscale,
                 int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kCols + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [kRows][LD]
  bf16* sK = sQ + kRows * LD;                 // [kCols][LD]
  bf16* sVt = sK + kCols * LD;                // [D][LDT]

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  q += (size_t)bh * sq * D;
  o += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<D>(sQ, LD, nullptr, 0, q, q0, sq, qscale);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    load_a(qf[kc], sQ + warp * 16 * LD + kc * 16, LD, g, t);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  int n_kt = (sk + kCols - 1) / kCols;
  if (causal) {
    const int last = min(q0 + kRows, sq) - 1;
    n_kt = min(n_kt, last / kCols + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();
    load_tile<D>(sK, LD, nullptr, 0, k, k0, sk, 0.f);
    load_tile<D>(nullptr, 0, sVt, LDT, v, k0, sk, 0.f);
    __syncthreads();

    float s[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const bf16* kb = sK + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(s[j], qf[kc], ld32(kb), ld32(kb + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        if (!valid_pair(row[e >> 1], col, sq, sk, causal)) s[j][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        const float p = valid_pair(row[e >> 1], col, sq, sk, causal)
                            ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
#pragma unroll
    for (int c = 0; c < kCols / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* vb = sVt + (i * 8 + g) * LDT + c * 16 + t * 2;
        mma16816(acc[i], a, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = o + (size_t)row[r] * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + t * 2) =
          pack2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (t == 0) lse[row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int sq, int sk, float qscale,
                 int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kRows + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // [kRows][LD]  this CTA's keys
  bf16* sV = sK + kRows * LD;                 // [kRows][LD]
  bf16* sQ = sV + kRows * LD;                 // [kCols][LD]  scaled q tile
  bf16* sQt = sQ + kCols * LD;                // [D][LDT]
  bf16* sO = sQt + D * LDT;                   // [kCols][LD]  dO tile
  bf16* sOt = sO + kCols * LD;                // [D][LDT]
  float* sLse = reinterpret_cast<float*>(sOt + D * LDT);  // [kCols]
  float* sDel = sLse + kCols;                              // [kCols]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles carry the most causal work
  const int k0 = kt * kRows;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* kw = sK + warp * 16 * LD;
  const bf16* vw = sV + warp * 16 * LD;

  load_tile<D>(sK, LD, nullptr, 0, k, k0, sk, 0.f);
  load_tile<D>(sV, LD, nullptr, 0, v, k0, sk, 0.f);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  }

  const int n_qt = (sq + kCols - 1) / kCols;
  const int qt0 = causal ? k0 / kCols : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    __syncthreads();
    load_tile<D>(sQ, LD, sQt, LDT, q, q0, sq, qscale);
    load_tile<D>(sO, LD, sOt, LDT, dout, q0, sq, 0.f);
    for (int i = threadIdx.x; i < kCols; i += kThreads) {
      const bool ok = q0 + i < sq;
      sLse[i] = ok ? lse[q0 + i] : 0.f;
      sDel[i] = ok ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Qs^T   (16 key rows x 64 q columns per warp)
    float st[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      load_a(a, kw + kc * 16, LD, g, t);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const bf16* qb = sQ + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(st[j], a, ld32(qb), ld32(qb + 8));
      }
    }
    // P^T = exp(S^T - lse), masked to 0.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t * 2 + (e & 1);
        st[j][e] = valid_pair(q0 + qc, krow[e >> 1], sq, sk, causal)
                       ? expf(st[j][e] - sLse[qc]) : 0.f;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int c = 0; c < kCols / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, st[2 * c], st[2 * c + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* ob = sOt + (i * 8 + g) * LDT + c * 16 + t * 2;
        mma16816(dva[i], a, ld32(ob), ld32(ob + 8));
      }
    }
    // dP^T = V dO^T
    float dpt[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      load_a(a, vw + kc * 16, LD, g, t);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const bf16* ob = sO + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(dpt[j], a, ld32(ob), ld32(ob + 8));
      }
    }
    // dS^T = P^T * (dP^T - delta), masked to 0.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t * 2 + (e & 1);
        st[j][e] = valid_pair(q0 + qc, krow[e >> 1], sq, sk, causal)
                       ? st[j][e] * (dpt[j][e] - sDel[qc]) : 0.f;
      }
    }
    // dK += dS^T Qs
#pragma unroll
    for (int c = 0; c < kCols / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, st[2 * c], st[2 * c + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* qb = sQt + (i * 8 + g) * LDT + c * 16 + t * 2;
        mma16816(dka[i], a, ld32(qb), ld32(qb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    bf16* dkr = dk + (size_t)krow[r] * D;
    bf16* dvr = dv + (size_t)krow[r] * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dkr + i * 8 + t * 2) =
          pack2(dka[i][2 * r], dka[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvr + i * 8 + t * 2) =
          pack2(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int sq, int sk, float qscale, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LDT = kCols + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [kRows][LD]  scaled q
  bf16* sO = sQ + kRows * LD;                 // [kRows][LD]  dO
  bf16* sK = sO + kRows * LD;                 // [kCols][LD]
  bf16* sKt = sK + kCols * LD;                // [D][LDT]
  bf16* sV = sKt + D * LDT;                   // [kCols][LD]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < sq ? lse[row[r]] : 0.f;
    del_r[r] = row[r] < sq ? delta[row[r]] : 0.f;
  }
  const bf16* qw = sQ + warp * 16 * LD;
  const bf16* ow = sO + warp * 16 * LD;

  load_tile<D>(sQ, LD, nullptr, 0, q, q0, sq, qscale);
  load_tile<D>(sO, LD, nullptr, 0, dout, q0, sq, 0.f);

  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  int n_kt = (sk + kCols - 1) / kCols;
  if (causal) {
    const int last = min(q0 + kRows, sq) - 1;
    n_kt = min(n_kt, last / kCols + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    __syncthreads();
    load_tile<D>(sK, LD, sKt, LDT, k, k0, sk, 0.f);
    load_tile<D>(sV, LD, nullptr, 0, v, k0, sk, 0.f);
    __syncthreads();

    float s[kCols / 8][4], dp[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], b[4];
      load_a(a, qw + kc * 16, LD, g, t);
      load_a(b, ow + kc * 16, LD, g, t);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const bf16* kb = sK + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(s[j], a, ld32(kb), ld32(kb + 8));
        const bf16* vb = sV + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(dp[j], b, ld32(vb), ld32(vb + 8));
      }
    }
    // dS = P * (dP - delta), P = exp(S - lse), both masked to 0.
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = valid_pair(row[r], col, sq, sk, causal)
                      ? expf(s[j][e] - lse_r[r]) * (dp[j][e] - del_r[r])
                      : 0.f;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int c = 0; c < kCols / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* kb = sKt + (i * 8 + g) * LDT + c * 16 + t * 2;
        mma16816(dqa[i], a, ld32(kb), ld32(kb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    bf16* dqr = dq + (size_t)row[r] * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dqr + i * 8 + t * 2) =
          pack2(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
    }
  }
}

template <int D>
constexpr int fwd_smem() {
  return ((kRows + kCols) * (D + 8) + D * (kCols + 8)) * 2;
}
template <int D>
constexpr int dkv_smem() {
  return ((2 * kRows + 2 * kCols) * (D + 8) + 2 * D * (kCols + 8)) * 2 +
         2 * kCols * 4;
}
template <int D>
constexpr int dq_smem() {
  return ((2 * kRows + 2 * kCols) * (D + 8) + D * (kCols + 8)) * 2;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, float qscale,
                       int causal, cudaStream_t stream) {
  constexpr int smem = fwd_smem<D>();
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kRows - 1) / kRows);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      sq, sk, qscale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk,
                       float qscale, int causal, cudaStream_t stream) {
  constexpr int smem = dkv_smem<D>();
  cudaError_t err = prepare(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sk + kRows - 1) / kRows);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, sq, sk,
      qscale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, float qscale,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dq_smem<D>();
  cudaError_t err = prepare(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kRows - 1) / kRows);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, sq, sk, qscale,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns a cudaError_t
// (0 on success); the caller raises on anything else.
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int sq, int sk, int d, float qscale,
                  int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return launch_fwd<64>(q, k, v, o, lse, bh, sq, sk, qscale, causal, s);
  if (d == 128) return launch_fwd<128>(q, k, v, o, lse, bh, sq, sk, qscale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int sq, int sk, int d,
                  float qscale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, qscale, causal, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, qscale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int hvd_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int sq, int sk, int d, float qscale,
                 float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, qscale, scale, causal, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, qscale, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
