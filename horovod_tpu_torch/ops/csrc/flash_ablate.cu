// Ablations of the flash forward kernel (flash_attention.cu, K1) for
// Hopper (sm_90a): K1's grid, tile loads and loop with the body cut down,
// to split K1's time into loading, matrix products and softmax.
//
// flash_ablate_kernel replaces
//   experiments/flash_ablate_probe.py::variant_kernel (via run_variant).
// Layout: q, k, v, o are [BH, S, D] bf16, contiguous; D is 64 or 128;
// S is a multiple of the tile T (no ragged tiles, as in the probe). One
// CTA of T/16 warps owns a T-row q tile (each warp 16 rows) and loops
// over T-row key tiles, the heaviest causal tiles first, exactly as K1:
// Q is loaded once, K row-major and V transposed into shared memory for
// every key tile, with load_tile from flash_tile.cuh. Causal skipping is
// per tile: key tile kj is processed when kj*T <= (qi+1)*T - 1, and
// nothing inside a processed tile is masked. The fp32 accumulator starts
// at 0 and is written as bf16(acc), unnormalised. The body per processed
// tile is one of
//   stream: acc += (q + k) + v elementwise (fp32; needs bq == bk, which
//           one T gives): K1's loads with no product;
//   matmul: acc += bf16(q k^T) v, both products on mma.sync m16n8k16;
//   nosoft: m = rowmax(q k^T) of this tile alone, then
//           acc = acc * 0.5 + bf16(q k^T - m) v: the products plus the
//           softmax's row max, without exp, sum or a running max.
// The fourth variant, "full", is K1 itself.
//
// Tiles: T = 64 with 4 warps (K1's CTA) and T = 128 with 8 warps (the
// probe's block sweep); T = 128 at D = 128 takes 104 KB of dynamic shared
// memory.
//
// Bound: matmul, nosoft and full do 4*D flops per (q, key) pair of the
// processed tiles, against 4*BH*S*D*2 bytes moved (q, k, v read once, o
// written once): at the flagship (BH=48, S=2048, D=128, causal, T=64)
// 53.2 GFLOP, 54 us at 989 TFLOP/s, against 101 MB, 30 us at 3.35 TB/s;
// stream is bound by those bytes. The kernels do what K1 does and
// nothing more to reach those bounds: they exist to be timed beside K1.

#include "flash_tile.cuh"

namespace {

enum Mode { kStream = 0, kMatmul = 1, kNosoft = 2 };

template <int D, int T, int MODE>
__global__ void __launch_bounds__(2 * T)
flash_ablate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int s, int causal) {
  constexpr int kThreads = 2 * T;  // T/16 warps x 32 lanes
  constexpr int LD = D + 8;
  constexpr int LDT = T + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [T][LD]
  bf16* sK = sQ + T * LD;                     // [T][LD]
  bf16* sVt = sK + T * LD;                    // [D][LDT]

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first, as K1.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * T;
  q += (size_t)bh * s * D;
  o += (size_t)bh * s * D;
  k += (size_t)bh * s * D;
  v += (size_t)bh * s * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's tile rows: r0, r0 + 8

  load_tile<D, T, kThreads>(sQ, LD, nullptr, 0, q, q0, s, 0.f);
  __syncthreads();
  uint32_t qf[D / 16][4];
  if (MODE != kStream) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      load_a(qf[kc], sQ + warp * 16 * LD + kc * 16, LD, g, t);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // kj * T <= (qt + 1) * T - 1  <=>  kj <= qt.
  const int n_kt = causal ? qt + 1 : s / T;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    load_tile<D, T, kThreads>(sK, LD, nullptr, 0, k, k0, s, 0.f);
    load_tile<D, T, kThreads>(nullptr, 0, sVt, LDT, v, k0, s, 0.f);
    __syncthreads();

    if (MODE == kStream) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int c = i * 8 + t * 2 + (e & 1);
          const float qk = __fadd_rn(__bfloat162float(sQ[r * LD + c]),
                                     __bfloat162float(sK[r * LD + c]));
          acc[i][e] = __fadd_rn(acc[i][e],
                                __fadd_rn(qk, __bfloat162float(sVt[c * LDT + r])));
        }
      }
      continue;
    }

    float sc[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        const bf16* kb = sK + (j * 8 + g) * LD + kc * 16 + t * 2;
        mma16816(sc[j], qf[kc], ld32(kb), ld32(kb + 8));
      }
    }

    if (MODE == kNosoft) {
      float mx[2] = {sc[0][0], sc[0][2]};
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = __fsub_rn(sc[j][e], mx[e >> 1]);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= 0.5f;
      }
    }

#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, sc[2 * c], sc[2 * c + 1]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const bf16* vb = sVt + (i * 8 + g) * LDT + c * 16 + t * 2;
        mma16816(acc[i], a, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* orow = o + (size_t)(q0 + r0 + r * 8) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + t * 2) =
          pack2(acc[i][2 * r], acc[i][2 * r + 1]);
    }
  }
}

template <int D, int T>
constexpr int ablate_smem() {
  return (2 * T * (D + 8) + D * (T + 8)) * 2;
}

template <int D, int T, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, int causal, cudaStream_t stream) {
  constexpr int smem = ablate_smem<D, T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_ablate_kernel<D, T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_ablate_kernel<D, T, MODE><<<dim3(bh, s / T), 2 * T, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, s, causal);
  return cudaGetLastError();
}

template <int D, int T>
cudaError_t by_mode(const void* q, const void* k, const void* v, void* o,
                    int bh, int s, int mode, int causal, cudaStream_t st) {
  if (mode == kStream) return launch<D, T, kStream>(q, k, v, o, bh, s, causal, st);
  if (mode == kMatmul) return launch<D, T, kMatmul>(q, k, v, o, bh, s, causal, st);
  if (mode == kNosoft) return launch<D, T, kNosoft>(q, k, v, o, bh, s, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// mode: 0 stream, 1 matmul, 2 nosoft. tile: 64 or 128 (bq = bk = tile).
// Returns a cudaError_t (0 on success).
int hvd_flash_ablate(const void* q, const void* k, const void* v, void* o,
                     int bh, int s, int d, int tile, int mode, int causal,
                     void* stream) {
  if (bh < 1 || s < tile || s % tile != 0 || s / tile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64 && tile == 64) return by_mode<64, 64>(q, k, v, o, bh, s, mode, causal, st);
  if (d == 64 && tile == 128) return by_mode<64, 128>(q, k, v, o, bh, s, mode, causal, st);
  if (d == 128 && tile == 64) return by_mode<128, 64>(q, k, v, o, bh, s, mode, causal, st);
  if (d == 128 && tile == 128) return by_mode<128, 128>(q, k, v, o, bh, s, mode, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
