// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels,
// the bodies of every 16-bit form. Each form is a .cu file of its own
// that includes this header and defines its kernels and entry points
// (HVD_FLASH_ENTRIES), so the forms build in parallel:
//   flash_attention.cu           bf16 operands, bf16 outputs
//   flash_attention_bf16_f32.cu  bf16 operands, fp32 outputs
//   flash_attention_f16.cu       fp16 operands, fp16 outputs
//   flash_attention_f16_f32.cu   fp16 operands, fp32 outputs
// (fp32 operands take flash_attention_fp32.cu, a SIMT body of its own).
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D], contiguous, in the
// operand type InT (bf16 or half) or, for the outputs, OutT (InT or fp32);
// lse and delta are [BH, S] fp32 (the [BH, S, 1] tensors of the Python
// side). The fp32-output forms serve ring attention, whose merge adds n
// per-block results and would stack n 16-bit roundings: the same body,
// templated on the output type, keeps the fp32 accumulator values and
// stores them as float2 pairs where the 16-bit forms pack them (Pair).
// The fp16 forms are the bf16 bodies with the wgmma type suffix, the
// packing and the q-scale pass of fp16 (hopper_tile.cuh). D is one of
// BuiltHeadDims below (every multiple of 16 up to 256), or a multiple of
// 128 above 256, which the _wide kernels take as a runtime count of
// 128-column chunks (the section "Head dims above 256"); sq and sk take
// any length >= 1, causal or not. A head dim short of its stored width
// (16, 48, 80, 96, 112, and every D above 128) is stored in shared
// memory at tile_width, zero filled: Q K^T and dO V^T take only D/16
// k-steps, and P V, dS K, P^T dO and dS^T Qs run out_width wide, their
// columns past D zero and never stored. A 256-wide tile's RS products
// run as two 128-column chunks, one per CTA (grid z): each CTA recomputes
// S (and dP) over the whole D and accumulates, and stores, its own 128
// output columns, so no accumulator outgrows 64 registers a thread. At
// that width shared memory takes two stages of the ring, and K2 and K3
// one warpgroup of 64 rows a CTA (the Fwd/Dkv/DqSmem configurations).
// All three kernels share one convention with the JAX package
// (horovod_tpu/ops/flash_attention.py):
//   - q is multiplied by the scale in the operand type before the QK^T
//     product (`qscale` is the scale already rounded to that type by the
//     caller);
//   - masked scores are -1e30, not -inf;
//   - rows past the sequence are loaded as zeros before any product, and
//     nothing beyond the sequence is read;
//   - P is cast to the operand type before P.V, dS before dS.Q and dS.K;
//   - every product accumulates in fp32.
// Each output has exactly one owner CTA: the TPU grid's sequential
// innermost axis becomes a loop inside the CTA, so there are no atomics
// and repeats are bit-identical. Kernels launch on the caller's stream,
// allocate nothing and return cudaGetLastError().
//
// flash_fwd_kernel (K1)  replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel
//   One CTA of two warpgroups owns 128 q rows (64 each) and loops over
//   64-key tiles up to the diagonal, heaviest causal tiles first. Bound on
//   an H100 SXM at the flagship shape (BH=48, S=2048, D=128, causal): 2
//   causal products = 51.6 GFLOP / 989 TFLOP/s = 0.0521 ms against 101 MB
//   / 3.35 TB/s = 0.030 ms, so compute-bound. The design, for that bound:
//   the products are wgmma (S = Qs K^T from shared memory, K K-major;
//   O += P V with P in registers and V read MN-major through the
//   transpose bit, so V is stored row-major as it lands); K and V stream
//   through a four-stage cp.async ring, the next three tiles in flight
//   while this one's products and softmax run; Q lands once and is
//   scaled in shared memory; the online softmax uses exp2f with log2 e
//   folded into one FMA, and the valid_pair mask runs only on tiles that
//   cross the diagonal (two per CTA) or the sq/sk tail. A warpgroup skips
//   the key tiles wholly above its own rows.
// flash_dkv_kernel (K2)  replaces horovod_tpu/ops/flash_attention.py::_dkv_kernel
//   One CTA of two warpgroups owns 128 key rows (64 each); K and V land
//   once, and 64-row Qs and dO tiles with their lse/delta slices stream
//   through the same kind of ring from the diagonal on. Four wgmma
//   products per tile: S^T = K Qs^T and dP^T = V dO^T from shared memory
//   (Qs, dO K-major), dV += P^T dO and dK += dS^T Qs with P^T and dS^T in
//   registers (dO, Qs MN-major): each Qs and dO tile is stored once,
//   row-major, and read in both majors. 4 causal products = 103 GFLOP =
//   0.1043 ms at peak against 152 MB = 0.045 ms: compute-bound.
// flash_dq_kernel (K3)   replaces horovod_tpu/ops/flash_attention.py::_dq_kernel
//   K2's layout with the roles swapped: one CTA of two warpgroups owns
//   128 q rows (64 each); Qs and dO land once, and 64-key K and V tiles
//   stream through the ring up to the diagonal. Three wgmma products per
//   tile: S = Qs K^T and dP = dO V^T from shared memory in one batch (K, V
//   K-major), then dQ += dS K with dS in registers and K read MN-major, so
//   K is stored once, row-major, and never transposed. The dQ product is
//   left running while the next tile's S and dP batch issues behind it,
//   so the tensor cores go from one to the other without an exposed wait;
//   the four-stage ring runs two tiles ahead, so a stage is refilled only
//   after its dQ product has retired. dQ is multiplied by the fp32 scale
//   once at the end. 3 causal products = 77 GFLOP = 78 us at peak against
//   127 MB = 38 us: compute-bound.
//
// What these designs leave on the table. A warpgroup runs its products
// and its softmax one after the other, and the two warpgroups meet at a
// barrier every tile, so the tensor cores idle while both run the
// softmax (no overlap of one tile's softmax with the next tile's first
// product, no ping-pong between warpgroups, one CTA per SM at ~170-250
// registers); every thread both loads and computes (no producer warp, no
// TMA); O, dQ, dK and dV leave the registers as 4-byte stores; dK/dV and
// dQ recompute P twice where a fused backward would do it once.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "hopper_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 1024-byte aligned start of dynamic shared memory (the 128-byte swizzle
// is a function of address bits 4-9).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// The epilogue's store of two adjacent accumulator columns of one row,
// `*reinterpret_cast<Pair<OutT>::T*>(p) = Pair<OutT>::of(lo, hi)`:
// rounded to bf16 and packed into one 4-byte store, or kept in fp32 as
// one 8-byte store. Either way a thread's pair is columns i*8 + t*2 and
// i*8 + t*2 + 1 of the fragment, so the row/column mapping is the same.
// (An assignment, as the bf16-only kernels had: C++ sequences its value
// before its address, so the bf16 forms compile to the same SASS.)
template <typename OutT>
struct Pair;
template <>
struct Pair<bf16> {
  using T = uint32_t;
  static __device__ __forceinline__ T of(float lo, float hi) {
    return pack2(lo, hi);
  }
};
template <>
struct Pair<half> {
  using T = uint32_t;
  static __device__ __forceinline__ T of(float lo, float hi) {
    return pack2_as<half>(lo, hi);
  }
};
template <>
struct Pair<float> {
  using T = float2;
  static __device__ __forceinline__ T of(float lo, float hi) {
    return make_float2(lo, hi);
  }
};

// ---------------------------------------------------------------------------
// Forward (K1)
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;     // q rows a CTA owns: two warpgroups
constexpr int kFwdCols = 64;      // keys per streamed tile
constexpr int kFwdStages = 4;     // K/V tiles in the ring
constexpr int kFwdThreads = 256;

// Output column chunks of a tile width (one CTA each, grid z), and the
// byte offset, inside a [64, W] tile, of the column block this CTA's RS
// products start at: 0 unless the tile is split.
template <int D>
struct Chunks {
  static constexpr int kN = tile_width<D>() / out_width<D>();
  // Columns this CTA accumulates and stores: D, or one chunk's.
  static constexpr int kCols = kN > 1 ? out_width<D>() : D;
  static __device__ __forceinline__ int col0() {
    if constexpr (kN > 1) return blockIdx.z * out_width<D>();
    return 0;
  }
  static __device__ __forceinline__ uint32_t bytes() {
    if constexpr (kN > 1) return blockIdx.z * (out_width<D>() / 64) * 64 * 128;
    return 0;
  }
  // Whether column block i*8 of this CTA's columns lies inside D.
  static __device__ __forceinline__ bool stored(int i) {
    if constexpr (kN > 1) return col0() + i * 8 < D;
    return true;
  }
};

template <int D>
struct FwdSmem {                               // byte offsets
  static constexpr int kW = tile_width<D>();      // stored tile width
  static constexpr int kStages = kW > 128 ? 2 : kFwdStages;  // ring
  static constexpr int kTile = kFwdCols * kW * 2;  // one K or V tile
  static constexpr int kRing = kFwdRows * kW * 2;  // Q [128, D] first
  // stage s: K at kRing + 2 s kTile, V right after it
  static constexpr int kBytes = kRing + kStages * 2 * kTile + 1024;
};

template <int D, typename InT, typename OutT>
__device__ __forceinline__ void
flash_fwd_body(const InT* __restrict__ q, const InT* __restrict__ k,
               const InT* __restrict__ v, OutT* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float qscale,
               int causal) {
  using L = FwdSmem<D>;
  using C = Chunks<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sRing = sQ + L::kRing;

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  q += (size_t)bh * sq * D;
  o += (size_t)bh * sq * D + C::col0();
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64;  // this warpgroup's first q row
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};

  // Key tiles the CTA loads, and those that reach this warpgroup's rows.
  int n_kt = (sk + kFwdCols - 1) / kFwdCols;
  int n_mine = r0 < sq ? n_kt : 0;
  if (causal) {
    n_kt = min(n_kt, (min(q0 + kFwdRows, sq) - 1) / kFwdCols + 1);
    if (r0 < sq) n_mine = min(n_kt, (min(r0 + 64, sq) - 1) / kFwdCols + 1);
  }

  // K and V of key tile kt into ring stage kt % kStages; one commit
  // group per tile, empty past the last.
  auto issue = [&](int kt) {
    if (kt < n_kt) {
      const uint32_t tile = sRing + (kt % L::kStages) * 2 * L::kTile;
      load_tile_async<D, kFwdCols, kFwdThreads>(tile, k, kt * kFwdCols, sk);
      load_tile_async<D, kFwdCols, kFwdThreads>(tile + L::kTile, v,
                                                kt * kFwdCols, sk);
    }
    cp_async_commit();
  };

  load_tile_async<D, kFwdRows, kFwdThreads>(sQ, q, q0, sq);
  cp_async_commit();
  for (int kt = 0; kt < L::kStages - 1; ++kt) issue(kt);
  cp_async_wait<L::kStages - 1>();  // this thread's Q chunks have landed
  scale_tile<D, kFwdRows, kFwdThreads, InT>(smem, qscale);

  float acc[out_width<D>() / 8][4];
#pragma unroll
  for (int i = 0; i < out_width<D>() / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    // Tile kt has landed (and Q is scaled) for every thread; the stage
    // tile kt-1 used is free, so tile kt+kStages-1 goes into it now.
    cp_async_wait<L::kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(kt + L::kStages - 1);
    if (kt >= n_mine) continue;  // wholly above this warpgroup's rows

    const uint32_t sK = sRing + (kt % L::kStages) * 2 * L::kTile;
    const uint32_t sV = sK + L::kTile + C::bytes();
    const int k0 = kt * kFwdCols;

    // S = Qs K^T (64 rows x kFwdCols keys per warpgroup).
    float s[kFwdCols / 8][4];
#pragma unroll
    for (int j = 0; j < kFwdCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kFwdCols, InT>(s, desc_kmajor<kFwdRows>(sQ, wg * 64, kk),
                              desc_kmajor<kFwdCols>(sK, 0, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // Online softmax in base 2; masks only on diagonal and tail tiles.
    const bool edge = k0 + kFwdCols > sk || (causal && k0 + kFwdCols - 1 > r0);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kFwdCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t * 2 + (e & 1);
          if (!valid_pair(row[e >> 1], col, sq, sk, causal)) s[j][e] = kNegInf;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFwdCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float corr[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
      mb[r] = mx[r] * kLog2e;
    }
#pragma unroll
    for (int j = 0; j < kFwdCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
        if (edge && !valid_pair(row[e >> 1], k0 + j * 8 + t * 2 + (e & 1),
                                sq, sk, causal)) {
          p = 0.f;
        }
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    uint32_t pa[kFwdCols / 16][4];
#pragma unroll
    for (int c = 0; c < kFwdCols / 16; ++c) acc_to_a_as<InT>(pa[c], s[2 * c], s[2 * c + 1]);
#pragma unroll
    for (int i = 0; i < C::kCols / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: P from registers, V MN-major.
    fence_acc(acc);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kFwdCols / 16; ++c) {
      wgmma_rs<D, InT>(acc, pa[c], desc_mnmajor<kFwdCols>(sV, c));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
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
    OutT* orow = o + (size_t)row[r] * D;
#pragma unroll
    for (int i = 0; i < C::kCols / 8; ++i) {
      if (!C::stored(i)) break;
      *reinterpret_cast<typename Pair<OutT>::T*>(orow + i * 8 + t * 2) =
          Pair<OutT>::of(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (t == 0 && C::col0() == 0) lse[row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV (K2)
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 128;     // key rows a CTA owns: two warpgroups
constexpr int kDkvCols = 64;      // q rows per streamed tile
constexpr int kDkvStages = 4;     // Qs/dO tiles in the ring

template <int D>
struct DkvSmem {                                  // byte offsets
  static constexpr int kW = tile_width<D>();       // stored tile width
  // A 256-wide K and V take one warpgroup's 64 key rows and two stages.
  static constexpr int kRows = kW > 128 ? 64 : kDkvRows;
  static constexpr int kThreads = 2 * kRows;
  static constexpr int kStages = kW > 128 ? 2 : kDkvStages;
  static constexpr int kKV = kRows * kW * 2;       // K at 0, V at kKV
  static constexpr int kTile = kDkvCols * kW * 2;  // one Qs or dO tile
  // stage s: Qs at kRing + 2 s kTile, dO right after it
  static constexpr int kRing = 2 * kKV;
  // stage s: lse[64] then delta[64] at kStats + 512 s
  static constexpr int kStats = kRing + kStages * 2 * kTile;
  static constexpr int kBytes = kStats + kStages * 512 + 1024;
};

template <int D, typename InT, typename OutT>
__device__ __forceinline__ void
flash_dkv_body(const InT* __restrict__ q, const InT* __restrict__ k,
               const InT* __restrict__ v, const InT* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, OutT* __restrict__ dk,
               OutT* __restrict__ dv, int sq, int sk, float qscale,
               int causal) {
  using L = DkvSmem<D>;
  using C = Chunks<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kKV;
  const uint32_t sRing = sK + L::kRing;
  const uint32_t sStats = sK + L::kStats;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::kRows;  // low key tiles carry the most causal work
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D + C::col0();
  dv += (size_t)bh * sk * D + C::col0();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + wg * 64;  // this warpgroup's first key row
  const int krow[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};

  const int n_qt = (sq + kDkvCols - 1) / kDkvCols;
  const int qt0 = causal ? k0 / kDkvCols : 0;

  // Qs, dO, lse and delta of q tile qt into ring stage (qt - qt0) %
  // kStages; one commit group per tile, empty past the last.
  auto issue = [&](int qt) {
    if (qt < n_qt) {
      const int stage = (qt - qt0) % L::kStages;
      const uint32_t tile = sRing + stage * 2 * L::kTile;
      load_tile_async<D, kDkvCols, L::kThreads>(tile, q, qt * kDkvCols, sq);
      load_tile_async<D, kDkvCols, L::kThreads>(tile + L::kTile, dout,
                                                qt * kDkvCols, sq);
      if (threadIdx.x < 2 * kDkvCols) {
        const int qi = qt * kDkvCols + threadIdx.x % kDkvCols;
        const float* src = threadIdx.x < kDkvCols ? lse : delta;
        cp_async4(sStats + stage * 512 + threadIdx.x * 4,
                  src + (qi < sq ? qi : 0), qi < sq);
      }
    }
    cp_async_commit();
  };

  load_tile_async<D, L::kRows, L::kThreads>(sK, k, k0, sk);
  load_tile_async<D, L::kRows, L::kThreads>(sV, v, k0, sk);
  for (int i = 0; i < L::kStages - 1; ++i) issue(qt0 + i);

  float dka[out_width<D>() / 8][4], dva[out_width<D>() / 8][4];
#pragma unroll
  for (int i = 0; i < out_width<D>() / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) % L::kStages;
    // Tile qt has landed; scale this thread's own Qs chunks, then publish
    // the tile to wgmma. The stage tile qt-1 used is free for tile
    // qt+kStages-1.
    cp_async_wait<L::kStages - 2>();
    scale_tile<D, kDkvCols, L::kThreads, InT>(
        smem + L::kRing + stage * 2 * L::kTile, qscale);
    fence_proxy_async();
    __syncthreads();
    issue(qt + L::kStages - 1);
    const int q0 = qt * kDkvCols;
    if (causal && q0 + kDkvCols - 1 < kr0) continue;  // all q above these keys

    const uint32_t sQ = sRing + stage * 2 * L::kTile;
    const uint32_t sO = sQ + L::kTile;
    const float* sLse = reinterpret_cast<const float*>(smem + L::kStats + stage * 512);
    const float* sDel = sLse + kDkvCols;
    // Rows past sq, and pairs across the diagonal, are masked; keys past
    // sk only reach their own (unstored) rows of dK and dV.
    const bool edge = q0 + kDkvCols > sq || (causal && q0 < kr0 + 63);

    // S^T = K Qs^T and dP^T = V dO^T (64 keys x 64 q per warpgroup).
    float st[kDkvCols / 8][4], dpt[kDkvCols / 8][4];
#pragma unroll
    for (int j = 0; j < kDkvCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDkvCols, InT>(st, desc_kmajor<L::kRows>(sK, wg * 64, kk),
                              desc_kmajor<kDkvCols>(sQ, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDkvCols, InT>(dpt, desc_kmajor<L::kRows>(sV, wg * 64, kk),
                              desc_kmajor<kDkvCols>(sO, 0, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    // P^T = exp(S^T - lse), masked to 0 on the edge tiles.
#pragma unroll
    for (int j = 0; j < kDkvCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + t * 2 + (e & 1);
        float p = exp2f(fmaf(st[j][e], kLog2e, -sLse[qc] * kLog2e));
        if (edge && !valid_pair(q0 + qc, krow[e >> 1], sq, sk, causal)) p = 0.f;
        st[j][e] = p;
      }
    }
    // dV += P^T dO, in flight while dS^T is formed.
    uint32_t pa[kDkvCols / 16][4];
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) acc_to_a_as<InT>(pa[c], st[2 * c], st[2 * c + 1]);
    fence_acc(dva);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) {
      wgmma_rs<D, InT>(dva, pa[c], desc_mnmajor<kDkvCols>(sO + C::bytes(), c));
    }
    wgmma_commit();

    // dS^T = P^T (dP^T - delta): masked pairs have P^T = 0.
    uint32_t dsa[kDkvCols / 16][4];
#pragma unroll
    for (int j = 0; j < kDkvCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] *= dpt[j][e] - sDel[j * 8 + t * 2 + (e & 1)];
      }
    }
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) acc_to_a_as<InT>(dsa[c], st[2 * c], st[2 * c + 1]);
    wgmma_wait<0>();
    fence_acc(dva);
    fence_frag(pa);

    // dK += dS^T Qs.
    fence_acc(dka);
    fence_frag(dsa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) {
      wgmma_rs<D, InT>(dka, dsa[c], desc_mnmajor<kDkvCols>(sQ + C::bytes(), c));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dka);
    fence_frag(dsa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    OutT* dkr = dk + (size_t)krow[r] * D;
    OutT* dvr = dv + (size_t)krow[r] * D;
#pragma unroll
    for (int i = 0; i < C::kCols / 8; ++i) {
      if (!C::stored(i)) break;
      *reinterpret_cast<typename Pair<OutT>::T*>(dkr + i * 8 + t * 2) =
          Pair<OutT>::of(dka[i][2 * r], dka[i][2 * r + 1]);
      *reinterpret_cast<typename Pair<OutT>::T*>(dvr + i * 8 + t * 2) =
          Pair<OutT>::of(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (K3)
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;     // q rows a CTA owns: two warpgroups
constexpr int kDqCols = 64;      // keys per streamed tile
constexpr int kDqStages = 4;     // K/V tiles in the ring
constexpr int kDqLead = 2;       // tiles in flight ahead of the one in use
// Tile kt's stage is refilled when tile kt + kDqStages - kDqLead = kt + 2
// is published: by then tile kt's dQ product, which runs on while tile
// kt+1's S and dP issue, has retired. Three tiles ahead (on five stages)
// took 1.5 times as long (experiments/flash_dq_order.py times both).

template <int D>
struct DqSmem {                                  // byte offsets
  static constexpr int kW = tile_width<D>();      // stored tile width
  // A 256-wide Qs and dO take one warpgroup's 64 q rows and two stages,
  // filled one tile at a time (no tile ahead: a stage may be refilled
  // only once its dQ product has retired).
  static constexpr int kRows = kW > 128 ? 64 : kDqRows;
  static constexpr int kThreads = 2 * kRows;
  static constexpr int kStages = kW > 128 ? 2 : kDqStages;
  static constexpr int kLead = kW > 128 ? 0 : kDqLead;
  static constexpr int kQ = kRows * kW * 2;       // Qs at 0, dO at kQ
  static constexpr int kTile = kDqCols * kW * 2;  // one K or V tile
  // stage s: K at kRing + 2 s kTile, V right after it
  static constexpr int kRing = 2 * kQ;
  static constexpr int kBytes = kRing + kStages * 2 * kTile + 1024;
};

template <int D, typename InT, typename OutT>
__device__ __forceinline__ void
flash_dq_body(const InT* __restrict__ q, const InT* __restrict__ k,
              const InT* __restrict__ v, const InT* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, OutT* __restrict__ dq,
              int sq, int sk, float qscale, float scale, int causal) {
  using L = DqSmem<D>;
  using C = Chunks<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + L::kQ;
  const uint32_t sRing = sQ + L::kRing;

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D + C::col0();
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64;  // this warpgroup's first q row
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  float lse2[2], del[2];  // lse in base 2, and delta, of this thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < sq ? lse[row[r]] * kLog2e : 0.f;
    del[r] = row[r] < sq ? delta[row[r]] : 0.f;
  }

  // Key tiles the CTA loads, and those that reach this warpgroup's rows.
  int n_kt = (sk + kDqCols - 1) / kDqCols;
  int n_mine = r0 < sq ? n_kt : 0;
  if (causal) {
    n_kt = min(n_kt, (min(q0 + L::kRows, sq) - 1) / kDqCols + 1);
    if (r0 < sq) n_mine = min(n_kt, (min(r0 + 64, sq) - 1) / kDqCols + 1);
  }

  // K and V of key tile kt into ring stage kt % kStages; one commit
  // group per tile, empty past the last.
  auto issue = [&](int kt) {
    if (kt < n_kt) {
      const uint32_t tile = sRing + (kt % L::kStages) * 2 * L::kTile;
      load_tile_async<D, kDqCols, L::kThreads>(tile, k, kt * kDqCols, sk);
      load_tile_async<D, kDqCols, L::kThreads>(tile + L::kTile, v,
                                               kt * kDqCols, sk);
    }
    cp_async_commit();
  };

  load_tile_async<D, L::kRows, L::kThreads>(sQ, q, q0, sq);
  load_tile_async<D, L::kRows, L::kThreads>(sO, dout, q0, sq);
  cp_async_commit();
  for (int kt = 0; kt < L::kLead; ++kt) issue(kt);
  cp_async_wait<L::kLead>();  // this thread's Q and dO chunks have landed
  scale_tile<D, L::kRows, L::kThreads, InT>(smem, qscale);

  float dqa[out_width<D>() / 8][4];
#pragma unroll
  for (int i = 0; i < out_width<D>() / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  float s[kDqCols / 8][4], dp[kDqCols / 8][4];  // S and dP of the tile in hand
  uint32_t dsa[kDqCols / 16][4];                // its dS: the dQ product's A

  // Tile kt has landed (and Qs is scaled) for every thread; tile
  // kt+kLead goes into the stage that tile kt+kLead-kStages used. With
  // no tile ahead, tile kt itself is issued once every warpgroup has
  // passed the barrier after tile kt-2's dQ product, whose stage it takes.
  auto next_tile = [&](int kt) {
    if constexpr (L::kLead == 0) {
      __syncthreads();
      issue(kt);
      cp_async_wait<0>();
    } else {
      cp_async_wait<L::kLead - 1>();
    }
    fence_proxy_async();
    __syncthreads();
    if constexpr (L::kLead > 0) issue(kt + L::kLead);
  };
  // S = Qs K^T and dP = dO V^T of key tile kt (64 rows x kDqCols keys
  // per warpgroup), one batch; the first k-step overwrites S and dP.
  auto s_dp = [&](int kt) {
    const uint32_t sK = sRing + (kt % L::kStages) * 2 * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDqCols, InT>(s, desc_kmajor<L::kRows>(sQ, wg * 64, kk),
                             desc_kmajor<kDqCols>(sK, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDqCols, InT>(dp, desc_kmajor<L::kRows>(sO, wg * 64, kk),
                             desc_kmajor<kDqCols>(sK + L::kTile, 0, kk), kk);
    }
    wgmma_commit();
  };

  // Each iteration forms tile kt's dS, issues its dQ product and, behind
  // it, tile kt+1's S and dP, then waits for both: the tensor cores go
  // from one batch to the next without an exposed wait. Every batch
  // retires in the iteration that issued it: a dQ batch left running
  // across the back edge made ptxas serialize every wgmma (note C7515,
  // "non wgmma instructions defining accumulator registers"; the zero
  // fill of dqa reaches the open batch through the loop header).
  next_tile(0);
  if (n_mine > 0) s_dp(0);
  wgmma_wait<0>();
  for (int kt = 0; kt < n_kt; ++kt) {
    fence_acc(s);
    fence_acc(dp);
    fence_acc(dqa);
    fence_frag(dsa);
    if (kt < n_mine) {  // else above this warpgroup's rows, or past sq
      // dS = P (dP - delta), P = exp(S - lse), masked to 0 on the tiles
      // that cross the diagonal or the key tail. Rows past sq need no
      // mask: each row of dQ takes only its own row of dS, and is not
      // stored.
      const int k0 = kt * kDqCols;
      const bool edge = k0 + kDqCols > sk || (causal && k0 + kDqCols - 1 > r0);
#pragma unroll
      for (int j = 0; j < kDqCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], kLog2e, -lse2[e >> 1]));
          if (edge && !valid_pair(row[e >> 1], k0 + j * 8 + t * 2 + (e & 1),
                                  sq, sk, causal)) {
            p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - del[e >> 1]);
        }
      }
#pragma unroll
      for (int c = 0; c < kDqCols / 16; ++c) acc_to_a_as<InT>(dsa[c], s[2 * c], s[2 * c + 1]);

      // dQ += dS K: dS from registers, K MN-major.
      const uint32_t sK = sRing + (kt % L::kStages) * 2 * L::kTile + C::bytes();
      fence_acc(dqa);
      fence_frag(dsa);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kDqCols / 16; ++c) {
        wgmma_rs<D, InT>(dqa, dsa[c], desc_mnmajor<kDqCols>(sK, c));
      }
      wgmma_commit();
    }
    if (kt + 1 < n_kt) {
      next_tile(kt + 1);
      if (kt + 1 < n_mine) s_dp(kt + 1);
    }
    wgmma_wait<0>();
  }
  fence_acc(dqa);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    OutT* dqr = dq + (size_t)row[r] * D;
#pragma unroll
    for (int i = 0; i < C::kCols / 8; ++i) {
      if (!C::stored(i)) break;
      *reinterpret_cast<typename Pair<OutT>::T*>(dqr + i * 8 + t * 2) =
          Pair<OutT>::of(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256: K1-K3 on 128-column chunks (the _wide kernels)
// ---------------------------------------------------------------------------
//
// d is a runtime multiple of 128 (the wrapper zero-pads any other head
// dim above 256 to one) and nc = d / 128 its chunks.
//
// K1 (flash_fwd_wide_body). One CTA owns 64 q rows and up to G = 4
// output chunks (512 columns; the CTAs of a row tile split nc into
// ceil(nc / G) groups). Its 256 threads are two warpgroups, each the
// producer of its own rings:
//   - TMA copies, one a [64, 128] chunk (a box of 64 rows x 64 columns x
//     2 column blocks of a 4-D view, 128-byte swizzled: the layout the
//     wgmma descriptors read; rows past the sequence land as zeros,
//     nothing past it is read), fill Q, loaded once, and for each
//     warpgroup a K ring and a V ring of chunk slots, each slot with a
//     "full" and an "empty" mbarrier. Thread 0 of a warpgroup fills its
//     rings' first slots, and refills a slot with the item a ring's
//     length later as soon as the four warps have let it go, so no ring
//     waits on another. (A producer warp of its own would make 9 warps,
//     three of them on one SM sub-partition, and cap every thread at 168
//     registers, below what the warpgroups hold.)
//   - warpgroup w computes the partial S = Qs K^T over the k-chunks c = w,
//     w + 2, ... (split-K), each chunk an SS batch into one fp32
//     accumulator, and owns its output chunks: the first half of the
//     group (w = 0) or the rest (w = 1), so both do the same number of
//     chunk products at nc = 3 and 4. The two partials meet in shared
//     memory and each warpgroup adds the other's to its own: fp32 addition
//     commutes, so both hold the same S bits and so the same m, l and P,
//     with P in registers for the RS products O += P V of its chunks;
//   - Q is loaded and scaled once (all 256 threads, in shared memory,
//     then a named barrier). Each K and V chunk comes through L2
//     once per 64-row q tile;
//   - every ring has one reader, which waits on each slot in order, so no
//     waiter runs a phase ahead. Within a tile a warpgroup issues P V of
//     the previous tile, then the next tile's S chunk by chunk, keeping one
//     batch in flight (wgmma_wait<1>) and letting each slot go the moment
//     the batch that read it retires; every batch retires in the loop
//     iteration that issued it. No __syncthreads after the set-up.
// Arithmetic at the timed shape (B=8, H=3, S=2048, D=512, causal):
//   - bound: 2 causal products = 103 GFLOP = 0.1043 ms at 989 TFLOP/s
//     against 151 MB in and 50 MB out at 3.35 TB/s = 0.060 ms: compute-
//     bound. S is computed once per q tile: the tensor work is the
//     bound's (the form before computed S once per output chunk, 2.5x);
//   - L2 to SM: 12,672 (q tile, key tile) pairs x 128 KB of K and V =
//     1.66 GB, plus Q's 50 MB once: 1.71 GB (5.3 GB before: Q again per
//     key tile and chunk, K per chunk). Block x runs the heads fastest and
//     the q tiles heaviest first, so the causal work spreads evenly over
//     the SMs: a head's q tiles first (its K and V shared in L2 by the
//     CTAs in flight) took 1.13x as long, the last waves left uneven
//     (experiments/wide_fwd_split.py, "head_major");
//   - shared memory at nc = 4: Q 64 KB + the two partial S (64 x 64 fp32)
//     32 KB + 8 ring slots of 16 KB (K and V, two each a warpgroup) 128
//     KB + 256 B of mbarriers + 1 KB of alignment = 230,656 B of 232,448:
//     one CTA an SM;
//   - registers: at most 255 a thread (256 threads): O 2 x 64, S 32, P
//     16, the rest addresses and the softmax's row state;
//   - exchanged per 64-key tile: each warpgroup stores its 16 KB partial
//     (8 float4 a thread, conflict-free) and loads the other's; one named
//     barrier (id 1, 256 threads) orders the stores before the loads, and
//     a bar.arrive by the reader that the writer's next bar.sync waits on
//     (ids 2 and 3) frees the buffer. The mbarriers carry the rest: TMA's
//     bytes into "full", the readers' release into "empty" (one arrival a
//     warp, after its wgmma wait);
//   - shared-memory traffic a tile: S's SS reads 128 KB (Q and K), P V's
//     RS reads 64 KB (V), the exchange 64 KB, TMA's writes 128 KB: ~384
//     KB, ~3,000 cycles at 128 B a cycle against 2,048 cycles of tensor
//     work at peak.
// What it still leaves on the table, measured at the timed shape on an
// H100 SXM at 700 W by experiments/wide_fwd_split.py: 0.41 ms, 25% of
// the bound. The rings alone (every product, the exchange and exp2 cut
// out) take 0.30 ms, and 0.27 with half the bytes: the loads wait on
// the copies' latency, not on bytes. Each ring holds one key tile (K's
// and V's 128 KB are what Q and the exchange leave), so a slot is
// refilled only once its product retires and every tile waits about one
// TMA round trip; the products, the exchange and the softmax add the
// rest (each cut saves 0.03-0.05 ms). A ring two tiles deep needs 256 KB
// that d = 512 does not leave; TMA multicast between the q tiles of a
// cluster would halve the bytes through L2, which half the bytes shows
// buys little. The two warpgroups meet at the exchange every tile, so
// both run their softmax while the tensor cores idle (no ping-pong).
// Above d = 512 (nc > G): S is recomputed once per group, ceil(nc / 4)
// times, and Q no longer fits beside the rings: its chunks ride the K
// rings (four slots each), re-read from L2 every key tile and scaled by
// the warpgroup that reads them behind a barrier of that warpgroup.
//
// K2 and K3 (flash_bwd_wide_body, as flash_dkv_wide_body and
// flash_dq_wide_body). A CTA of 256 threads owns 64 rows (K3: q rows, K2:
// key rows) and a group of output chunks: K3 up to G = 4 chunks of dQ,
// warpgroup w those of its own parity (c0 + w, c0 + w + 2: two 64 x 128
// fp32 accumulators, 128 registers a thread); K2 a pair, warpgroup w
// chunk c0 + w of dK and of dV (128 registers). (A pair is what the
// register file allows: dK and dV of 64 rows at d = 512 would take all
// 65,536 registers of an SM.) The other side streams in tiles of 32 rows
// (K3: the keys up to the diagonal; K2: the q rows from it on):
//   - per streamed tile, warpgroup w computes its partials of S and dP
//     (K2: S^T = K Qs^T and dP^T = V dO^T) over its parity chunks, one SS
//     m64n32k16 batch a chunk: the own rows' chunk is A, the tile's chunk
//     B, both K-major. The partials meet as K1's do (below); then P =
//     exp2(S log2 e - lse log2 e), masked to 0 on the tiles that cross the
//     diagonal or a sequence's end, and dS = P (dP - delta), each rounded
//     to the operand type as an RS A fragment: K3 dQ_o += dS K_o over its
//     owned chunks o, K2 dV_o += P^T dO_o, then dK_o += dS^T Qs_o, the
//     tile's chunk read MN-major from the slot its partial read K-major;
//   - so K3 computes S and dP once per (q tile, key tile) pair up to nc =
//     4 (one group), ceil(nc / 4) times above; K2 computes S^T and dP^T
//     once per pair of output chunks, ceil(nc / 2) times. The launcher
//     runs this K2 at nc = 4 only, and refuses it at any other nc (above
//     4 nothing is resident, which its RS products read): at nc = 3 and 5
//     it took longer than K2's one-chunk form (flash_dkv_chunk_body,
//     below), which serves every other nc (PERF.md §6;
//     experiments/wide_bwd_split.py, cut k2_wide_everywhere);
//   - up to nc = 4 the own rows' operands are resident (K3: Qs, scaled
//     once in shared memory by all 256 threads, and dO; K2: K and V), 16
//     KB a chunk, landed by one TMA barrier. Each warpgroup has two rings
//     of [32, 128] slots (8 KB): ring 0 the tile's chunks of the operand
//     its RS product reads (K3: K; K2: Qs, which the warpgroup scales as
//     it lands, then a named barrier of the warpgroup) and ring 1 the
//     other's (K3: V; K2: dO), its parity chunks in order, K2's owned one
//     last. A slot an RS product reads goes when that product retires,
//     the others when their partial's batch does. Above nc = 4 (K3 only)
//     nothing is resident: the own rows' chunk of a partial rides the ring
//     just before the tile's (16 KB slots; Qs chunks are scaled as they
//     land), every slot goes when its batch retires, and the K chunks the
//     dQ product reads are loaded once more after the partials';
//   - thread 0 of each warpgroup fills its rings' first slots and refills
//     a slot with the item a ring's length later as soon as the four
//     warps have let it go; every ring has one reader, which waits on each
//     slot in order. With the operands resident one batch stays in flight
//     (wgmma_wait<1>) and a batch's slots go once the next batch has
//     issued; above nc = 4 each batch is waited for (a ring's three slots
//     cannot hold two batches' four). Within a tile a warpgroup issues
//     the RS products of the tile in hand, then the next tile's partials:
//     K3 the dP chunks first, since the K slots that S reads come free
//     only when the dQ product retires, so dP covers their copies; K2 S^T
//     then dP^T chunk by chunk, the owned chunk last for the same reason.
//     Every batch retires in the loop iteration that issued it. No
//     __syncthreads after the set-up;
//   - exchanged per tile: each warpgroup stores its partial S and dP (8
//     float4 a thread, 2 x 8 KB), one named barrier (id 1) orders the
//     stores before the other's loads, and a bar.arrive (ids 2, 3) frees
//     the buffer for the next tile, as in K1. K2 stages the q tile's lse
//     (times log2 e) and delta in shared memory before the exchange
//     (threads 0-63, a buffer per tile parity); K3 holds its rows' in
//     registers;
//   - block x runs the heads fastest, then the 64-row tiles heaviest
//     causal first (K3 the last q tiles, K2 the first key tiles), then
//     the groups.
// Arithmetic at the timed shape (B=8, H=3, S=2048, D=512, causal):
//   - bound: K2 4 causal products = 206 GFLOP = 0.2086 ms, K3 3 = 155
//     GFLOP = 0.1564 ms at 989 TFLOP/s, against 0.06-0.09 ms of bytes at
//     3.35 TB/s: compute-bound. Tensor work (at the 32-row granularity of
//     the causal tiles, 3% over the triangle): K3 the bound's 3 full-d
//     products (before: 9 at nc = 4), K2 2 x 2 + 2 = 6, 1.5x the bound's
//     (before: 10);
//   - L2 to SM: K3 25,344 (q tile, 32-key tile) pairs x 64 KB of K and V
//     = 1.66 GB, plus Qs and dO once, 0.10 GB; K2 2 groups x 25,344 x 64
//     KB of Qs and dO = 3.32 GB, plus K and V once a group, 0.20 GB (13.3
//     GB each before);
//   - shared memory at nc = 4: the resident 128 KB + the partials 32 KB +
//     2 warpgroups x 2 rings x 2 slots x 8 KB = 64 KB + lse and delta 512
//     B + 136 B of mbarriers + 1 KB of alignment = 231,048 B of 232,448:
//     one CTA an SM (nc = 3: 96 KB resident and 3 slots a ring; above 4:
//     3 slots of 16 KB a ring);
//   - registers: at most 255 a thread (256 threads): K3 dQ 2 x 64, S 16,
//     dP 16, dS 8; K2 dK 64, dV 64, S^T 16, dP^T 16, P^T 8, dS^T 8; the
//     rest addresses, ring cursors, masks;
//   - shared-memory traffic a 32-row tile (K3; K2 alike): the partials'
//     SS batches read 192 KB (each 64-row A chunk again for every 32-row
//     B), the RS products 32 KB, TMA writes 64 KB, the exchange 64 KB:
//     ~352 KB, ~2,800 cycles at 128 B a cycle against ~1,540 cycles of
//     tensor work at peak.
// What binds it, measured at the timed shape on an H100 SXM at 700 W by
// experiments/wide_bwd_split.py (ptxas: 243 and 245 registers, no
// spills): K3 0.92 ms (17% of the bound; 2.42 before), K2 1.99 ms (10%;
// 2.57 before). Not bytes: half the bytes through L2 saves 1-2%. The
// rings alone (every product, the exchange and exp2 cut out) take 0.51
// and 1.20 ms, most of it the loop's own barriers, mbarrier round trips,
// wgmma commits and (K2) q-scale passes, paid per 32-row tile (the cut
// no_copies), and one TMA round trip a tile where a ring holds a single
// tile (K3's K slots wait for the dQ product, K2's owned Qs and dO slots
// for dK and dV). Each product and the exchange add 0.05-0.2 ms on top,
// in series: with the operands resident at nc = 4, 32-row tiles and
// one-tile rings are what shared memory leaves, and the two warpgroups
// meet at the exchange every tile.
//
// K2 at nc != 4 (flash_dkv_chunk_body, the first _wide form): one CTA of one
// warpgroup owns 64 key rows and one 128-column chunk c = blockIdx.z of
// dK and dV. The products that sum over d (K Qs^T and V dO^T) stream d
// through a three-stage cp.async ring one k-chunk at a time (the owned
// rows' chunk and the 64-row q tile's chunk of each operand, 64 KB an
// item), so each CTA recomputes S^T and dP^T over the whole d: nc times
// a pair. Its work grows as nc^2, the redesign's as ceil(nc / 2) times
// a per-tile cost that hardly depends on nc, and only at nc = 4 did the
// redesign come out ahead.

constexpr int kWide = 128;         // columns of one chunk
constexpr int kChunkTile = 64 * kWide * 2;  // a [64, 128] 16-bit chunk
constexpr int kWideStages = 3;     // ring items (K2 at nc != 4)
constexpr int kWideRows = 64;      // rows a K2 CTA owns at nc != 4
constexpr int kWideThreads = 128;

constexpr int kFwdWideRows = 64;       // q rows a _wide K1 CTA owns
constexpr int kFwdWideKeys = 64;       // keys per key tile
constexpr int kFwdWideGroup = 4;       // G: output chunks a CTA owns
constexpr int kFwdWideThreads = 256;   // two warpgroups
constexpr int kFwdWideX = 2 * 64 * 64 * 4;  // both partial S, fp32

constexpr int kBwdWideRows = 64;       // rows a _wide K2/K3 CTA owns
constexpr int kBwdWideCols = 32;       // rows of a streamed tile
constexpr int kBwdWideThreads = 256;   // two warpgroups
constexpr int kBwdHalfTile = kBwdWideCols * kWide * 2;  // a [32, 128] chunk
constexpr int kBwdWideX = 2 * 2 * 64 * kBwdWideCols * 4;  // partial S, dP
constexpr int kSmemPerBlock = 232448;  // an H100's most a CTA may take

// Shared memory of a _wide K1 CTA, byte offsets from the aligned base:
// the resident Q chunks, the two partial S, warpgroup 0's K then V ring
// slots, warpgroup 1's, then the mbarriers: Q's "full"; then per
// warpgroup its K "full" and "empty" barriers, then its V ones.
struct FwdWideSmem {
  static constexpr int kRv = 2;  // V ring slots a warpgroup
  int nq;                        // Q chunks resident: nc up to G, else 0
  int rk;                        // K ring slots a warpgroup
  __host__ __device__ explicit FwdWideSmem(int nc)
      : nq(nc <= kFwdWideGroup ? nc : 0), rk(nc <= kFwdWideGroup ? 2 : 4) {}
  __host__ __device__ int x() const { return nq * kChunkTile; }
  __host__ __device__ int ring(int w) const {
    return x() + kFwdWideX + w * (rk + kRv) * kChunkTile;
  }
  __host__ __device__ int bars() const { return ring(2); }
  // Warpgroup w's barriers, from bars(): K full, K empty, V full, V empty.
  __host__ __device__ int wg_bars(int w) const {
    return 8 + w * 16 * (rk + kRv);
  }
  __host__ __device__ int bytes() const { return bars() + 256 + 1024; }
};

struct BwdChunkSmem {                  // K2 at nc != 4: four [64, 128] chunks
  static constexpr int kStage = 4 * kChunkTile;
  static constexpr int kStats = kWideStages * kStage;  // lse, delta
  static constexpr int kBytes = kStats + kWideStages * 512 + 1024;
};

// Shared memory of a _wide K2/K3 CTA, byte offsets from the aligned base:
// the resident chunks of X1 then X2 (up to nc = 4), the two warpgroups'
// partial S and dP, warpgroup 0's rings 0 and 1 then warpgroup 1's, K2's
// lse and delta, then the mbarriers: the resident operands' "full"; then
// per warpgroup and ring its r "full" and r "empty" barriers. A ring
// takes as many slots as the rest leaves: 2 at nc = 4, 3 at nc = 3 and
// above nc = 4.
struct BwdWideSmem {
  int nr;    // resident chunks of each own-row operand: nc up to 4, else 0
  int slot;  // bytes of a ring slot: a [32, 128] chunk, or [64, 128]
  int r;     // slots of a ring
  __host__ __device__ explicit BwdWideSmem(int nc)
      : nr(nc <= 4 ? nc : 0),
        slot(nc <= 4 ? kBwdHalfTile : kChunkTile),
        r((kSmemPerBlock - 1024 - 512 - 8 - 2 * nr * kChunkTile - kBwdWideX) /
          (4 * slot + 64)) {}
  __host__ __device__ int x() const { return 2 * nr * kChunkTile; }
  __host__ __device__ int ring(int w, int j) const {
    return x() + kBwdWideX + (2 * w + j) * r * slot;
  }
  __host__ __device__ int stats() const { return ring(2, 0); }
  __host__ __device__ int bars() const { return stats() + 512; }
  // Ring j of warpgroup w's barriers, from bars(): r "full", r "empty".
  __host__ __device__ int ring_bars(int w, int j) const {
    return 8 + (2 * w + j) * 16 * r;
  }
  __host__ __device__ int bytes() const { return bars() + 8 + 64 * r + 1024; }
};

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_fwd_wide_body(const void* tq, const void* tk, const void* tv,
                    OutT* __restrict__ o, float* __restrict__ lse, int n_bh,
                    int sq, int sk, int d, float qscale, int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int nc = d / kWide;
  const FwdWideSmem L(nc);
  constexpr int kRv = FwdWideSmem::kRv;
  const uint32_t bars = base + L.bars();  // Q's "full" first

  // Block x: the heads fastest, then the q tiles, heaviest causal tile
  // first, then the groups of G output chunks.
  int blk = blockIdx.x;
  const int n_qt = (sq + kFwdWideRows - 1) / kFwdWideRows;
  const int bh = blk % n_bh;
  blk /= n_bh;
  const int q0 = (n_qt - 1 - blk % n_qt) * kFwdWideRows;
  const int c0 = blk / n_qt * kFwdWideGroup;
  const int ng = min(kFwdWideGroup, nc - c0);
  int n_kt = (sk + kFwdWideKeys - 1) / kFwdWideKeys;
  if (causal) {
    n_kt = min(n_kt, (min(q0 + kFwdWideRows, sq) - 1) / kFwdWideKeys + 1);
  }
  const int per_chunk = L.nq ? 1 : 2;  // ring items an S chunk: K, or Q and K

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int w = 0; w < 2; ++w) {
      const uint32_t b = bars + L.wg_bars(w);
      for (int s = 0; s < L.rk; ++s) {
        mbar_init(b + 8 * s, 1);
        mbar_init(b + 8 * (L.rk + s), 4);
      }
      for (int s = 0; s < kRv; ++s) {
        mbar_init(b + 8 * (2 * L.rk + s), 1);
        mbar_init(b + 8 * (2 * L.rk + kRv + s), 4);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // This warpgroup's S k-chunks w, w + 2, ... (n_s of them), and its
  // output chunks first .. first + n_own - 1 of the group.
  const int n_s = (nc - w + 1) / 2;
  const int first = c0 + (w ? ng / 2 : 0), n_own = w ? ng - ng / 2 : ng / 2;
  const uint32_t k_slots = base + L.ring(w);
  const uint32_t v_slots = k_slots + L.rk * kChunkTile;
  const uint32_t k_full = bars + L.wg_bars(w), k_empty = k_full + 8 * L.rk;
  const uint32_t v_full = k_full + 16 * L.rk, v_empty = v_full + 8 * kRv;
  const int k_items = n_kt * n_s * per_chunk, v_items = n_kt * n_own;

  // A [64, 128] chunk: one box of its two 64-column blocks.
  auto load = [&](uint32_t dst, const void* map, int c, int row0,
                  uint32_t bar) {
    tma_load_4d(dst, map, 0, row0, 2 * c, bh, bar);
  };
  // Item i of this warpgroup's K ring (key tile i / per, then its S
  // chunks in order, each Q's chunk then K's when Q is streamed) and of
  // its V ring (key tile i / n_own, then its output chunks), into slot s.
  auto issue_k = [&](int i, int s) {
    const int per = n_s * per_chunk, kt = i / per, p = i % per;
    const uint32_t full = k_full + 8 * s, dst = k_slots + s * kChunkTile;
    mbar_expect_tx(full, kChunkTile);
    if (per_chunk == 2 && p % 2 == 0) {
      load(dst, tq, w + p, q0, full);
    } else {
      load(dst, tk, w + 2 * (p / per_chunk), kt * kFwdWideKeys, full);
    }
  };
  auto issue_v = [&](int i, int s) {
    const uint32_t full = v_full + 8 * s;
    mbar_expect_tx(full, kChunkTile);
    load(v_slots + s * kChunkTile, tv, first + i % n_own,
         i / n_own * kFwdWideKeys, full);
  };
  if (tid == 0) {
    if (w == 0 && L.nq) {
      mbar_expect_tx(bars, L.nq * kChunkTile);
      for (int c = 0; c < L.nq; ++c) load(base + c * kChunkTile, tq, c, q0, bars);
    }
    for (int i = 0; i < min(L.rk, k_items); ++i) issue_k(i, i);
    for (int i = 0; i < min(kRv, v_items); ++i) issue_v(i, i);
  }

  // Ring cursors: the next slot to read and its phase; the next slot to
  // let go, its phase, and the item that refills it.
  int k_rd = 0, k_ph = 0, v_rd = 0, v_ph = 0;
  int k_rel = 0, k_rel_ph = 0, k_next = L.rk;
  int v_rel = 0, v_rel_ph = 0, v_next = kRv;
  auto next_k = [&]() {
    mbar_wait(k_full + 8 * k_rd, k_ph);
    const uint32_t a = k_slots + k_rd * kChunkTile;
    if (++k_rd == L.rk) k_rd = 0, k_ph ^= 1;
    return a;
  };
  auto next_v = [&]() {
    mbar_wait(v_full + 8 * v_rd, v_ph);
    const uint32_t a = v_slots + v_rd * kChunkTile;
    if (++v_rd == kRv) v_rd = 0, v_ph ^= 1;
    return a;
  };
  // Let the n oldest slots a ring holds go (one arrival a warp, after
  // the warp's wgmma wait); thread 0 refills each once all four warps
  // have let it go.
  auto release_k = [&](int n) {
    for (int i = 0; i < n; ++i) {
      if (lane == 0) mbar_arrive(k_empty + 8 * k_rel);
      if (tid == 0 && k_next < k_items) {
        mbar_wait(k_empty + 8 * k_rel, k_rel_ph);
        issue_k(k_next, k_rel);
      }
      ++k_next;
      if (++k_rel == L.rk) k_rel = 0, k_rel_ph ^= 1;
    }
  };
  auto release_v = [&](int n) {
    for (int i = 0; i < n; ++i) {
      if (lane == 0) mbar_arrive(v_empty + 8 * v_rel);
      if (tid == 0 && v_next < v_items) {
        mbar_wait(v_empty + 8 * v_rel, v_rel_ph);
        issue_v(v_next, v_rel);
      }
      ++v_next;
      if (++v_rel == kRv) v_rel = 0, v_rel_ph ^= 1;
    }
  };

  if (L.nq) {  // Q has landed: scale it once, then publish it to wgmma
    mbar_wait(bars, 0);
    scale_words<InT>(smem, L.nq * kChunkTile / 16, threadIdx.x, 256, qscale);
    fence_proxy_async();
    bar_sync(1, 256);
  }

  float acc[2][kWide / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kWide / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  float s[kFwdWideKeys / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  int v_held = 0;  // V slots the P V batch in flight reads

  // This warpgroup's partial S of the next key tile, a batch a k-chunk;
  // the first overwrites S. Each wait leaves the newest batch running and
  // lets go of what the one before it read (P V's V slots, then the
  // previous chunk's); the last chunk's slots go after the caller's wait.
  auto s_tile = [&]() {
    for (int i = 0; i < n_s; ++i) {
      const int c = w + 2 * i;
      uint32_t qa = base + c * kChunkTile;
      if (!L.nq) {  // Q's chunk rides the ring: scale it, then publish it
        qa = next_k();
        scale_words<InT>(smem + (qa - base), kChunkTile / 16, tid, 128, qscale);
        fence_proxy_async();
        bar_sync(4 + w, 128);
      }
      const uint32_t ka = next_k();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWide / 16; ++kk) {
        wgmma_ss<kFwdWideKeys, InT>(s, desc_kmajor<64>(qa, 0, kk),
                                    desc_kmajor<64>(ka, 0, kk), i | kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (i == 0) {
        release_v(v_held);
        v_held = 0;
      } else {
        release_k(per_chunk);
      }
    }
  };
  // O += P V over this warpgroup's n output chunks, one batch.
  auto pv = [&](auto n, uint32_t (&pa)[kFwdWideKeys / 16][4]) {
    uint32_t va[decltype(n)::value];
#pragma unroll
    for (int i = 0; i < decltype(n)::value; ++i) va[i] = next_v();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < decltype(n)::value; ++i) {
#pragma unroll
      for (int cc = 0; cc < kFwdWideKeys / 16; ++cc) {
        wgmma_rs<kWide, InT>(acc[i], pa[cc], desc_mnmajor<kFwdWideKeys>(va[i], cc));
      }
    }
    wgmma_commit();
    v_held = decltype(n)::value;
  };

  fence_acc(s);
  s_tile();
  wgmma_wait<0>();
  fence_acc(s);
  release_k(per_chunk);
  float4* x = reinterpret_cast<float4*>(smem + L.x());  // [2][8][128]
  for (int kt = 0; kt < n_kt; ++kt) {
    // S = the two partials: store this warpgroup's once the other has
    // read the last one, and add the other's to it.
    if (kt > 0) bar_sync(2 + w, 256);
#pragma unroll
    for (int j = 0; j < kFwdWideKeys / 8; ++j) {
      x[(w * 8 + j) * 128 + tid] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < kFwdWideKeys / 8; ++j) {
      const float4 y = x[((1 - w) * 8 + j) * 128 + tid];
      s[j][0] += y.x;
      s[j][1] += y.y;
      s[j][2] += y.z;
      s[j][3] += y.w;
    }
    if (kt + 1 < n_kt) bar_arrive(3 - w, 256);

    // The online softmax, as in flash_fwd_body.
    const int k0 = kt * kFwdWideKeys;
    const bool edge = k0 + kFwdWideKeys > sk || (causal && k0 + kFwdWideKeys - 1 > q0);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kFwdWideKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t * 2 + (e & 1);
          if (!valid_pair(row[e >> 1], col, sq, sk, causal)) s[j][e] = kNegInf;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFwdWideKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float corr[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
      mb[r] = mx[r] * kLog2e;
    }
#pragma unroll
    for (int j = 0; j < kFwdWideKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
        if (edge && !valid_pair(row[e >> 1], k0 + j * 8 + t * 2 + (e & 1),
                                sq, sk, causal)) {
          p = 0.f;
        }
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    uint32_t pa[kFwdWideKeys / 16][4];
#pragma unroll
    for (int cc = 0; cc < kFwdWideKeys / 16; ++cc) acc_to_a_as<InT>(pa[cc], s[2 * cc], s[2 * cc + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j) {
        acc[i][j][0] *= corr[0];
        acc[i][j][1] *= corr[0];
        acc[i][j][2] *= corr[1];
        acc[i][j][3] *= corr[1];
      }
    }

    // P V of this tile, then the next tile's S behind it; both retire here.
    if (n_own == 2) {
      pv(std::integral_constant<int, 2>{}, pa);
    } else if (n_own == 1) {
      pv(std::integral_constant<int, 1>{}, pa);
    }
    if (kt + 1 < n_kt) s_tile();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_frag(pa);
    release_v(v_held);
    v_held = 0;
    if (kt + 1 < n_kt) release_k(per_chunk);
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
    OutT* orow = o + ((size_t)bh * sq + row[r]) * d + first * kWide;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= n_own) break;
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j) {
        *reinterpret_cast<typename Pair<OutT>::T*>(orow + i * kWide + j * 8 + t * 2) =
            Pair<OutT>::of(acc[i][j][2 * r] * inv, acc[i][j][2 * r + 1] * inv);
      }
    }
    if (t == 0 && w == 0 && c0 == 0) lse[(size_t)bh * sq + row[r]] = m[r] + logf(l[r]);
  }
}

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_dkv_chunk_body(const InT* __restrict__ q, const InT* __restrict__ k,
                    const InT* __restrict__ v, const InT* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, OutT* __restrict__ dk,
                    OutT* __restrict__ dv, int sq, int sk, int d,
                    float qscale, int causal) {
  using L = BwdChunkSmem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sRing = smem_u32(smem);
  const uint32_t sStats = sRing + L::kStats;

  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kWideRows;
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dk += (size_t)bh * sk * d + c * kWide;
  dv += (size_t)bh * sk * d + c * kWide;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  const int n_qt = (sq + kDkvCols - 1) / kDkvCols;
  const int qt0 = causal ? k0 / kDkvCols : 0;
  const int n_items = (n_qt > qt0 ? n_qt - qt0 : 0) * nc;

  // Item it = q tile qt0 + it / nc, k-chunk (c + 1 + it % nc) % nc: K's,
  // V's, Qs's and dO's chunks in a stage at 0, 1, 2, 3 chunk tiles, and
  // the q tile's lse and delta with its last chunk.
  auto issue = [&](int it) {
    if (it < n_items) {
      const int qt = qt0 + it / nc, j = it % nc;
      const int col = ((c + 1 + j) % nc) * kWide;
      const int stage = it % kWideStages;
      const uint32_t st = sRing + stage * L::kStage;
      load_chunk_async<kWideRows, kWideThreads>(st, k, k0, sk, d, col);
      load_chunk_async<kWideRows, kWideThreads>(st + kChunkTile, v, k0, sk,
                                                d, col);
      load_chunk_async<kDkvCols, kWideThreads>(st + 2 * kChunkTile, q,
                                               qt * kDkvCols, sq, d, col);
      load_chunk_async<kDkvCols, kWideThreads>(st + 3 * kChunkTile, dout,
                                               qt * kDkvCols, sq, d, col);
      if (j == nc - 1) {
        const int qi = qt * kDkvCols + threadIdx.x % kDkvCols;
        const float* src = threadIdx.x < kDkvCols ? lse : delta;
        cp_async4(sStats + stage * 512 + threadIdx.x * 4,
                  src + (qi < sq ? qi : 0), qi < sq);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float dka[kWide / 8][4], dva[kWide / 8][4];
#pragma unroll
  for (int i = 0; i < kWide / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  }
  float st[kDkvCols / 8][4], dpt[kDkvCols / 8][4];

  for (int it = 0; it < n_items; ++it) {
    const int stage = it % kWideStages;
    cp_async_wait<1>();
    scale_tile<kWide, kDkvCols, kWideThreads, InT>(
        smem + stage * L::kStage + 2 * kChunkTile, qscale);
    fence_proxy_async();
    __syncthreads();
    issue(it + 2);
    const int qt = qt0 + it / nc, j = it % nc;
    const uint32_t sK = sRing + stage * L::kStage;
    const uint32_t sV = sK + kChunkTile;
    const uint32_t sQ = sK + 2 * kChunkTile;
    const uint32_t sO = sK + 3 * kChunkTile;

    // S^T (+)= K Qs^T and dP^T (+)= V dO^T over this k-chunk.
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kDkvCols, InT>(st, desc_kmajor<kWideRows>(sK, 0, kk),
                              desc_kmajor<kDkvCols>(sQ, 0, kk), j | kk);
    }
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kDkvCols, InT>(dpt, desc_kmajor<kWideRows>(sV, 0, kk),
                              desc_kmajor<kDkvCols>(sO, 0, kk), j | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);
    if (j != nc - 1) continue;

    // The stage holds chunk c of Qs and dO: P^T, dV, dS^T and dK as in
    // flash_dkv_body.
    const int q0 = qt * kDkvCols;
    const float* sLse = reinterpret_cast<const float*>(smem + L::kStats + stage * 512);
    const float* sDel = sLse + kDkvCols;
    const bool edge = q0 + kDkvCols > sq || (causal && q0 < k0 + 63);
#pragma unroll
    for (int jj = 0; jj < kDkvCols / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = jj * 8 + t * 2 + (e & 1);
        float p = exp2f(fmaf(st[jj][e], kLog2e, -sLse[qc] * kLog2e));
        if (edge && !valid_pair(q0 + qc, krow[e >> 1], sq, sk, causal)) p = 0.f;
        st[jj][e] = p;
      }
    }
    uint32_t pa[kDkvCols / 16][4];
#pragma unroll
    for (int cc = 0; cc < kDkvCols / 16; ++cc) acc_to_a_as<InT>(pa[cc], st[2 * cc], st[2 * cc + 1]);
    fence_acc(dva);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < kDkvCols / 16; ++cc) {
      wgmma_rs<kWide, InT>(dva, pa[cc], desc_mnmajor<kDkvCols>(sO, cc));
    }
    wgmma_commit();
    uint32_t dsa[kDkvCols / 16][4];
#pragma unroll
    for (int jj = 0; jj < kDkvCols / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[jj][e] *= dpt[jj][e] - sDel[jj * 8 + t * 2 + (e & 1)];
      }
    }
#pragma unroll
    for (int cc = 0; cc < kDkvCols / 16; ++cc) acc_to_a_as<InT>(dsa[cc], st[2 * cc], st[2 * cc + 1]);
    wgmma_wait<0>();
    fence_acc(dva);
    fence_frag(pa);
    fence_acc(dka);
    fence_frag(dsa);
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < kDkvCols / 16; ++cc) {
      wgmma_rs<kWide, InT>(dka, dsa[cc], desc_mnmajor<kDkvCols>(sQ, cc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dka);
    fence_frag(dsa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    OutT* dkr = dk + (size_t)krow[r] * d;
    OutT* dvr = dv + (size_t)krow[r] * d;
#pragma unroll
    for (int i = 0; i < kWide / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(dkr + i * 8 + t * 2) =
          Pair<OutT>::of(dka[i][2 * r], dka[i][2 * r + 1]);
      *reinterpret_cast<typename Pair<OutT>::T*>(dvr + i * 8 + t * 2) =
          Pair<OutT>::of(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// One ring of a _wide K2/K3 warpgroup (j 0 or 1, m items a tile): its
// slots and barriers; the next slot to read and its phase; the next slot
// to let go, its phase, and the item that refills it.
struct BwdRing {
  uint32_t slots, full, empty;
  int j, m, items;
  int rd, ph, rel, rel_ph, next;
};

template <bool DKV, typename InT, typename OutT>
__device__ __forceinline__ void
flash_bwd_wide_body(const void* tx1, const void* tx2, const void* ty1,
                    const void* ty2, const float* __restrict__ lse,
                    const float* __restrict__ delta, OutT* __restrict__ out1,
                    OutT* __restrict__ out2, int n_bh, int sq, int sk, int d,
                    float qscale, float scale, int causal) {
  // X1, X2: the own rows' operands of S and dP (K3: Qs, dO; K2: K, V);
  // Y1, Y2: the streamed tile's (K3: K, V; K2: Qs, dO). out1 is dQ (K3)
  // or dK (K2), out2 dV.
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int nc = d / kWide;
  const BwdWideSmem L(nc);
  const uint32_t bars = base + L.bars();  // the resident operands' "full" first
  constexpr int kG = DKV ? 2 : 4;         // output chunks a CTA owns
  constexpr int kT = kBwdWideCols;        // rows of a streamed tile

  // Block x: the heads fastest, then the 64-row tiles, heaviest causal
  // tile first, then the groups of kG output chunks.
  int blk = blockIdx.x;
  const int n_rt = ((DKV ? sk : sq) + kBwdWideRows - 1) / kBwdWideRows;
  const int bh = blk % n_bh;
  blk /= n_bh;
  const int r0 = (DKV ? blk % n_rt : n_rt - 1 - blk % n_rt) * kBwdWideRows;
  const int c0 = blk / n_rt * kG;
  const int ng = min(kG, nc - c0);
  // Streamed tiles t0 .. t_end - 1: K2 the q tiles from the diagonal on,
  // K3 the key tiles up to it.
  int t0 = 0, t_end = ((DKV ? sq : sk) + kT - 1) / kT;
  if (causal) {
    if (DKV) {
      t0 = r0 / kT;
    } else {
      t_end = min(t_end, (min(r0 + kBwdWideRows, sq) - 1) / kT + 1);
    }
  }
  const int n_tiles = max(t_end - t0, 0);
  const int per = L.nr ? 1 : 2;  // ring items a partial chunk: Y, or X and Y

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int ww = 0; ww < 2; ++ww) {
      for (int j = 0; j < 2; ++j) {
        const uint32_t b = bars + L.ring_bars(ww, j);
        for (int s = 0; s < L.r; ++s) {
          mbar_init(b + 8 * s, 1);
          mbar_init(b + 8 * (L.r + s), 4);
        }
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  // This warpgroup's partial chunks w, w + 2, ... (n_s of them), and its
  // output chunks own0, own0 + 2, ... of the group (n_own; K2 at most 1).
  const int n_s = (nc - w + 1) / 2;
  const int own0 = c0 + w;
  const int n_own = w < ng ? (ng - w + 1) / 2 : 0;
  // Partial chunk i, in ring order: the parity chunks ascending, K2's
  // owned one moved last while resident; and whether the RS products
  // read its Y slot in ring j (held until they retire: K3's K, K2's
  // owned Qs and dO).
  const int io = (own0 - w) / 2;
  auto chunk = [&](int i) {
    if (DKV && n_own && i >= io) {
      return i == n_s - 1 ? own0 : w + 2 * (i + 1);
    }
    return w + 2 * i;
  };
  auto held = [&](int j, int i) {
    return L.nr && n_own && (DKV ? i == n_s - 1 : j == 0);
  };

  auto make_ring = [&](int j, int m) {
    BwdRing R;
    R.slots = base + L.ring(w, j);
    R.full = bars + L.ring_bars(w, j);
    R.empty = R.full + 8 * L.r;
    R.j = j;
    R.m = m;
    R.items = n_tiles * m;
    R.rd = R.ph = R.rel = R.rel_ph = 0;
    R.next = L.r;
    return R;
  };
  // Ring 0 feeds S and (K3 above nc = 4) the reloads of dQ's K chunks,
  // ring 1 dP. K2 runs with its operands resident (the launcher's nc = 4).
  BwdRing rg0 = make_ring(0, n_s * per + (L.nr ? 0 : n_own));
  BwdRing rg1 = make_ring(1, n_s * per);

  // Rows row0.. of chunk c: a box of 64 rows (X) or kT (Y).
  auto load = [&](uint32_t dst, const void* map, int c, int row0,
                  uint32_t bar) {
    tma_load_4d(dst, map, 0, row0, 2 * c, bh, bar);
  };
  // Item i of ring R into slot s: tile t0 + i / m; per partial chunk the
  // X chunk when it rides the ring, then the tile's Y chunk; then the
  // reloads of the owned Y chunks.
  auto issue = [&](BwdRing& R, int i, int s) {
    const int tile = t0 + i / R.m, p = i % R.m;
    const uint32_t full = R.full + 8 * s, dst = R.slots + s * L.slot;
    if (per == 2 && p < 2 * n_s && p % 2 == 0) {
      mbar_expect_tx(full, kChunkTile);
      load(dst, R.j ? tx2 : tx1, chunk(p / 2), r0, full);
    } else {
      const int c = p < n_s * per ? chunk(p / per) : own0 + 2 * (p - n_s * per);
      mbar_expect_tx(full, kBwdHalfTile);
      load(dst, R.j ? ty2 : ty1, c, tile * kT, full);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    if (w == 0 && L.nr) {
      mbar_expect_tx(bars, 2 * L.nr * kChunkTile);
      for (int c = 0; c < L.nr; ++c) {
        load(base + c * kChunkTile, tx1, c, r0, bars);
        load(base + (L.nr + c) * kChunkTile, tx2, c, r0, bars);
      }
    }
    for (int i = 0; i < min(L.r, rg0.items); ++i) issue(rg0, i, i);
    for (int i = 0; i < min(L.r, rg1.items); ++i) issue(rg1, i, i);
  }

  auto acquire = [&](BwdRing& R) {
    mbar_wait(R.full + 8 * R.rd, R.ph);
    const uint32_t a = R.slots + R.rd * L.slot;
    if (++R.rd == L.r) R.rd = 0, R.ph ^= 1;
    return a;
  };
  // Let the n oldest slots a ring holds go (one arrival a warp, after the
  // warp's wgmma wait); thread 0 refills each once all four warps have.
  auto release = [&](BwdRing& R, int n) {
    for (int i = 0; i < n; ++i) {
      if (lane == 0) mbar_arrive(R.empty + 8 * R.rel);
      if (tid == 0 && R.next < R.items) {
        mbar_wait(R.empty + 8 * R.rel, R.rel_ph);
        issue(R, R.next, R.rel);
      }
      ++R.next;
      if (++R.rel == L.r) R.rel = 0, R.rel_ph ^= 1;
    }
  };
  // Slots to let go once the batches that read them retire: those of the
  // batches before the newest, and the newest's.
  int pend0 = 0, pend1 = 0, new0 = 0, new1 = 0;
  auto committed = [&](int n0, int n1) {
    wgmma_commit();
    pend0 += new0;
    pend1 += new1;
    new0 = n0;
    new1 = n1;
  };
  auto retire = [&](bool all) {
    if (all) {
      wgmma_wait<0>();
      pend0 += new0;
      pend1 += new1;
      new0 = new1 = 0;
    } else {
      wgmma_wait<1>();
    }
    release(rg0, pend0);
    release(rg1, pend1);
    pend0 = pend1 = 0;
  };
  // q * scale in place over a slot this warpgroup has taken, then
  // published to wgmma.
  auto scale_slot = [&](uint32_t a, int bytes) {
    scale_words<InT>(smem + (a - base), bytes / 16, tid, 128, qscale);
    fence_proxy_async();
    bar_sync(4 + w, 128);
  };

  if (L.nr && n_tiles > 0) {
    mbar_wait(bars, 0);
    if (!DKV) {  // K3's Qs: scale it once, then publish it to wgmma
      scale_words<InT>(smem, L.nr * kChunkTile / 16, threadIdx.x, 256, qscale);
      fence_proxy_async();
      bar_sync(1, 256);
    }
  }
  float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};  // K3: this thread's rows
  if (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] < sq) {
        lse2[r] = lse[(size_t)bh * sq + row[r]] * kLog2e;
        del[r] = delta[(size_t)bh * sq + row[r]];
      }
    }
  }
  // K2: the q tile's lse * log2 e, then delta, a buffer per tile parity.
  float* stats = reinterpret_cast<float*>(smem + L.stats());

  float acc[2][kWide / 8][4];  // K3: dQ of own0, own0 + 2; K2: dK, dV of own0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kWide / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  float s[kT / 8][4], dp[kT / 8][4];
  // K3's dS, apart from S: written over S, it made ptxas serialize every
  // wgmma of the kernel (its note C7515).
  float ds[kT / 8][4];
  uint32_t fa[kT / 16][4], fb[kT / 16][4];  // K3: dS; K2: P^T, dS^T
  uint32_t ya0 = 0, ya1 = 0, yb = 0;        // the slots the RS products read

  // One k-chunk batch of a partial from ring R: a (+)= X_c Y_c^T over
  // chunk(i)'s 128 columns (ring 0: S, ring 1: dP). Returns Y_c's slot.
  auto partial = [&](BwdRing& R, float (&a)[kT / 8][4], int i) {
    const int c = chunk(i);
    uint32_t xa = base + (R.j * L.nr + c) * kChunkTile;
    if (!L.nr) {
      xa = acquire(R);
      if (!DKV && R.j == 0) scale_slot(xa, kChunkTile);
    }
    const uint32_t ya = acquire(R);
    if (DKV && R.j == 0) scale_slot(ya, kBwdHalfTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kT, InT>(a, desc_kmajor<64>(xa, 0, kk),
                        desc_kmajor<kT>(ya, 0, kk), i | kk);
    }
    const int n = L.nr ? (held(R.j, i) ? 0 : 1) : 2;
    committed(R.j ? 0 : n, R.j ? n : 0);
    retire(!L.nr);
    return ya;
  };
  // The partials of tile it (K2 first stages its lse and delta).
  auto partials = [&](int it) {
    if (DKV && threadIdx.x < 2 * kT) {
      const int q = (t0 + it) * kT + threadIdx.x % kT;
      float v = 0.f;
      if (q < sq) {
        v = threadIdx.x < kT ? lse[(size_t)bh * sq + q] * kLog2e
                             : delta[(size_t)bh * sq + q];
      }
      stats[(it & 1) * 2 * kT + threadIdx.x] = v;
    }
    fence_acc(s);
    fence_acc(dp);
    if (DKV) {
      for (int i = 0; i < n_s; ++i) {
        const uint32_t a = partial(rg0, s, i);
        const uint32_t b = partial(rg1, dp, i);
        if (held(0, i)) ya0 = a, yb = b;
      }
    } else {
      for (int i = 0; i < n_s; ++i) partial(rg1, dp, i);
      for (int i = 0; i < n_s; ++i) {
        const uint32_t a = partial(rg0, s, i);
        if (held(0, i)) {
          if (i == 0) {
            ya0 = a;
          } else {
            ya1 = a;
          }
        }
      }
    }
  };
  // K3: dQ += dS K over this warpgroup's n owned chunks, one batch.
  auto dq_product = [&](auto n) {
    if (!L.nr) {  // the reloads of K's owned chunks
      ya0 = acquire(rg0);
      if (decltype(n)::value == 2) ya1 = acquire(rg0);
    }
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_frag(fa);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < decltype(n)::value; ++i) {
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) {
        wgmma_rs<kWide, InT>(acc[i], fa[cc],
                             desc_mnmajor<kT>(i ? ya1 : ya0, cc));
      }
    }
    committed(decltype(n)::value, 0);
  };

  float4* x = reinterpret_cast<float4*>(smem + L.x());  // [w][S, dP][4][128]
  if (n_tiles > 0) {
    partials(0);
    retire(true);
    fence_acc(s);
    fence_acc(dp);
  }
  for (int it = 0; it < n_tiles; ++it) {
    // S and dP = the two partials: store this warpgroup's once the other
    // has read the last ones, and add the other's to them.
    if (it > 0) bar_sync(2 + w, 256);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      x[((w * 2) * 4 + j) * 128 + tid] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      x[((w * 2 + 1) * 4 + j) * 128 + tid] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
    }
    bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float4 y = x[(((1 - w) * 2) * 4 + j) * 128 + tid];
      s[j][0] += y.x;
      s[j][1] += y.y;
      s[j][2] += y.z;
      s[j][3] += y.w;
      const float4 z = x[(((1 - w) * 2 + 1) * 4 + j) * 128 + tid];
      dp[j][0] += z.x;
      dp[j][1] += z.y;
      dp[j][2] += z.z;
      dp[j][3] += z.w;
    }
    if (it + 1 < n_tiles) bar_arrive(3 - w, 256);

    const int k0 = (t0 + it) * kT;  // the tile's first streamed row
    if (!DKV && n_own) {
      // dS = P (dP - delta), P = exp(S - lse), masked to 0 on the tiles
      // that cross the diagonal or the key tail (rows past sq are not
      // stored, and each row of dQ takes only its own row of dS).
      const bool edge = k0 + kT > sk || (causal && k0 + kT - 1 > r0);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], kLog2e, -lse2[e >> 1]));
          if (edge && !valid_pair(row[e >> 1], k0 + j * 8 + t * 2 + (e & 1),
                                  sq, sk, causal)) {
            p = 0.f;
          }
          ds[j][e] = p * (dp[j][e] - del[e >> 1]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) acc_to_a_as<InT>(fa[cc], ds[2 * cc], ds[2 * cc + 1]);
      if (n_own == 2) {
        dq_product(std::integral_constant<int, 2>{});
      } else {
        dq_product(std::integral_constant<int, 1>{});
      }
    }
    if (DKV && n_own) {
      // P^T = exp(S^T - lse), masked to 0 on the edge tiles (keys past sk
      // reach only their own, unstored, rows of dK and dV); dV += P^T dO;
      // dS^T = P^T (dP^T - delta); dK += dS^T Qs.
      const float* st = stats + (it & 1) * 2 * kT;
      const bool edge = k0 + kT > sq || (causal && k0 < r0 + kBwdWideRows - 1);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + t * 2 + (e & 1);
          float p = exp2f(fmaf(s[j][e], kLog2e, -st[qc]));
          if (edge && !valid_pair(k0 + qc, row[e >> 1], sq, sk, causal)) p = 0.f;
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) acc_to_a_as<InT>(fa[cc], s[2 * cc], s[2 * cc + 1]);
      fence_acc(acc[1]);
      fence_frag(fa);
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) {
        wgmma_rs<kWide, InT>(acc[1], fa[cc], desc_mnmajor<kT>(yb, cc));
      }
      committed(0, 1);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= dp[j][e] - st[kT + j * 8 + t * 2 + (e & 1)];
        }
      }
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) acc_to_a_as<InT>(fb[cc], s[2 * cc], s[2 * cc + 1]);
      fence_acc(acc[0]);
      fence_frag(fb);
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < kT / 16; ++cc) {
        wgmma_rs<kWide, InT>(acc[0], fb[cc], desc_mnmajor<kT>(ya0, cc));
      }
      committed(1, 0);
    }

    // The next tile's partials behind the RS products; all retire here.
    if (it + 1 < n_tiles) partials(it + 1);
    retire(true);
    fence_acc(s);
    fence_acc(dp);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    fence_frag(fa);
    fence_frag(fb);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= (DKV ? sk : sq)) continue;
    const size_t at = ((size_t)bh * (DKV ? sk : sq) + row[r]) * d + own0 * kWide;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= n_own || (DKV && i > 0)) break;
#pragma unroll
      for (int j = 0; j < kWide / 8; ++j) {
        const int col = i * 2 * kWide + j * 8 + t * 2;
        if (DKV) {
          *reinterpret_cast<typename Pair<OutT>::T*>(out1 + at + col) =
              Pair<OutT>::of(acc[0][j][2 * r], acc[0][j][2 * r + 1]);
          *reinterpret_cast<typename Pair<OutT>::T*>(out2 + at + col) =
              Pair<OutT>::of(acc[1][j][2 * r], acc[1][j][2 * r + 1]);
        } else {
          *reinterpret_cast<typename Pair<OutT>::T*>(out1 + at + col) =
              Pair<OutT>::of(acc[i][j][2 * r] * scale,
                             acc[i][j][2 * r + 1] * scale);
        }
      }
    }
  }
}

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_dkv_wide_body(const void* tk, const void* tv, const void* tq,
                    const void* tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, OutT* __restrict__ dk,
                    OutT* __restrict__ dv, int n_bh, int sq, int sk, int d,
                    float qscale, int causal) {
  flash_bwd_wide_body<true, InT, OutT>(tk, tv, tq, tdo, lse, delta, dk, dv,
                                       n_bh, sq, sk, d, qscale, 1.f, causal);
}

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_dq_wide_body(const void* tq, const void* tdo, const void* tk,
                   const void* tv, const float* __restrict__ lse,
                   const float* __restrict__ delta, OutT* __restrict__ dq,
                   int n_bh, int sq, int sk, int d, float qscale, float scale,
                   int causal) {
  flash_bwd_wide_body<false, InT, OutT>(tq, tdo, tk, tv, lse, delta, dq,
                                        nullptr, n_bh, sq, sk, d, qscale,
                                        scale, causal);
}

// The kernels of one form: flash_{fwd,dkv,dq}<PREFIX>_kernel<D> for
// operands InT and outputs OutT (the bf16 forms keep the names they had
// before the other forms existed: flash_fwd_kernel, flash_fwd_f32_kernel).
#define HVD_FLASH_KERNELS(PREFIX, InT, OutT)                                  \
  template <int D>                                                            \
  __global__ void __launch_bounds__(kFwdThreads) flash_fwd##PREFIX##_kernel(  \
      const InT* __restrict__ q, const InT* __restrict__ k,                   \
      const InT* __restrict__ v, OutT* __restrict__ o,                        \
      float* __restrict__ lse, int sq, int sk, float qscale, int causal) {    \
    flash_fwd_body<D>(q, k, v, o, lse, sq, sk, qscale, causal);               \
  }                                                                           \
  template <int D>                                                            \
  __global__ void __launch_bounds__(DkvSmem<D>::kThreads)                     \
      flash_dkv##PREFIX##_kernel(                                             \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, const InT* __restrict__ dout,            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dk, OutT* __restrict__ dv, int sq, int sk,       \
          float qscale, int causal) {                                         \
    flash_dkv_body<D>(q, k, v, dout, lse, delta, dk, dv, sq, sk, qscale,      \
                      causal);                                                \
  }                                                                           \
  template <int D>                                                            \
  __global__ void __launch_bounds__(DqSmem<D>::kThreads)                      \
      flash_dq##PREFIX##_kernel(                                              \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, const InT* __restrict__ dout,            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dq, int sq, int sk, float qscale, float scale,   \
          int causal) {                                                       \
    flash_dq_body<D>(q, k, v, dout, lse, delta, dq, sq, sk, qscale, scale,    \
                     causal);                                                 \
  }                                                                           \
  __global__ void __launch_bounds__(kFwdWideThreads)                         \
      flash_fwd##PREFIX##_wide_kernel(                                        \
          const __grid_constant__ CUtensorMap tq,                             \
          const __grid_constant__ CUtensorMap tk,                             \
          const __grid_constant__ CUtensorMap tv, OutT* __restrict__ o,       \
          float* __restrict__ lse, int bh, int sq, int sk, int d,             \
          float qscale, int causal) {                                         \
    flash_fwd_wide_body<InT, OutT>(&tq, &tk, &tv, o, lse, bh, sq, sk, d,      \
                                   qscale, causal);                           \
  }                                                                           \
  __global__ void __launch_bounds__(kBwdWideThreads)                         \
      flash_dkv##PREFIX##_wide_kernel(                                        \
          const __grid_constant__ CUtensorMap tk,                             \
          const __grid_constant__ CUtensorMap tv,                             \
          const __grid_constant__ CUtensorMap tq,                             \
          const __grid_constant__ CUtensorMap tdo,                            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dk, OutT* __restrict__ dv, int bh, int sq,       \
          int sk, int d, float qscale, int causal) {                          \
    flash_dkv_wide_body<InT, OutT>(&tk, &tv, &tq, &tdo, lse, delta, dk, dv,   \
                                   bh, sq, sk, d, qscale, causal);            \
  }                                                                           \
  __global__ void __launch_bounds__(kWideThreads)                            \
      flash_dkv##PREFIX##_chunk_kernel(                                       \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, const InT* __restrict__ dout,            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dk, OutT* __restrict__ dv, int sq, int sk,       \
          int d, float qscale, int causal) {                                  \
    flash_dkv_chunk_body<InT, OutT>(q, k, v, dout, lse, delta, dk, dv, sq,    \
                                    sk, d, qscale, causal);                   \
  }                                                                           \
  __global__ void __launch_bounds__(kBwdWideThreads)                         \
      flash_dq##PREFIX##_wide_kernel(                                         \
          const __grid_constant__ CUtensorMap tq,                             \
          const __grid_constant__ CUtensorMap tdo,                            \
          const __grid_constant__ CUtensorMap tk,                             \
          const __grid_constant__ CUtensorMap tv,                             \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dq, int bh, int sq, int sk, int d, float qscale, \
          float scale, int causal) {                                          \
    flash_dq_wide_body<InT, OutT>(&tq, &tdo, &tk, &tv, lse, delta, dq, bh,    \
                                  sq, sk, d, qscale, scale, causal);          \
  }                                                                           \
  struct FlashKernels##PREFIX {                                               \
    template <int D>                                                          \
    static auto fwd() { return flash_fwd##PREFIX##_kernel<D>; }               \
    template <int D>                                                          \
    static auto dkv() { return flash_dkv##PREFIX##_kernel<D>; }               \
    template <int D>                                                          \
    static auto dq() { return flash_dq##PREFIX##_kernel<D>; }                 \
    static auto fwd_wide() { return flash_fwd##PREFIX##_wide_kernel; }        \
    static auto dkv_wide() { return flash_dkv##PREFIX##_wide_kernel; }        \
    static auto dkv_chunk() { return flash_dkv##PREFIX##_chunk_kernel; }      \
    static auto dq_wide() { return flash_dq##PREFIX##_wide_kernel; }          \
  };

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Launchers of one form; Ks is its FlashKernels struct.
template <int D, typename Ks, typename InT, typename OutT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, float qscale,
                       int causal, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::kBytes;
  const auto kernel = Ks::template fwd<D>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows, Chunks<D>::kN);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (OutT*)o, (float*)lse,
      sq, sk, qscale, causal);
  return cudaGetLastError();
}

template <int D, typename Ks, typename InT, typename OutT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk,
                       float qscale, int causal, cudaStream_t stream) {
  using L = DkvSmem<D>;
  const auto kernel = Ks::template dkv<D>();
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sk + L::kRows - 1) / L::kRows, Chunks<D>::kN);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (const InT*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, sq, sk,
      qscale, causal);
  return cudaGetLastError();
}

template <int D, typename Ks, typename InT, typename OutT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, float qscale,
                      float scale, int causal, cudaStream_t stream) {
  using L = DqSmem<D>;
  const auto kernel = Ks::template dq<D>();
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + L::kRows - 1) / L::kRows, Chunks<D>::kN);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (const InT*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dq, sq, sk, qscale,
      scale, causal);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up in libcuda (which the CUDA runtime
// has loaded) at first use, so the library links nothing more.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A [n_bh, rows, d] 16-bit tensor seen as [n_bh, d / 64, rows, 64] (the
// 64-column blocks outside the rows), in boxes of box_rows rows x 64
// columns x 2 blocks, 128-byte swizzled: one box is a [box_rows, 128]
// chunk in the sw128 layout (block 0's rows, then block 1's).
// Coordinates (column in the block, row, block, head); box rows past
// `rows` land as zeros. The copy moves 16-bit words, bf16 and fp16
// alike. False if the encoding is refused (a base not 16-byte aligned).
inline bool chunk_map(CUtensorMap* map, const void* base, int n_bh, int rows,
                      int d, int box_rows = 64) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)rows, (cuuint64_t)d / 64,
                              (cuuint64_t)n_bh};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, 128,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launchers of one form's _wide kernels: d a multiple of kWide above 256.
// K1: one block per (64-row q tile, head, group of G chunks), in block x.
template <typename Ks, typename InT, typename OutT>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk, int d,
                            float qscale, int causal, cudaStream_t stream) {
  const auto kernel = Ks::fwd_wide();
  const int smem = FwdWideSmem(d / kWide).bytes();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!chunk_map(&tq, q, bh, sq, d) || !chunk_map(&tk, k, bh, sk, d) ||
      !chunk_map(&tv, v, bh, sk, d)) {
    return cudaErrorInvalidValue;
  }
  const long long blocks =
      (long long)((sq + kFwdWideRows - 1) / kFwdWideRows) * bh *
      ((d / kWide + kFwdWideGroup - 1) / kFwdWideGroup);
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kFwdWideThreads, smem, stream>>>(
      tq, tk, tv, (OutT*)o, (float*)lse, bh, sq, sk, d, qscale, causal);
  return cudaGetLastError();
}

// K2 (DKV) or K3: one block per (64-row tile, head, group of chunks), in
// block x; the own rows' maps in 64-row boxes, the streamed ones' in
// kBwdWideCols-row boxes.
template <bool DKV, typename K, typename OutT>
cudaError_t launch_bwd_wide(K kernel, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* out1, void* out2, int bh,
                            int sq, int sk, int d, float qscale, float scale,
                            int causal, cudaStream_t stream) {
  // K2's pairs of output chunks read their operands resident: d = 512.
  if (DKV && d != 4 * kWide) return cudaErrorInvalidValue;
  const int smem = BwdWideSmem(d / kWide).bytes();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int own = DKV ? sk : sq, str = DKV ? sq : sk;
  CUtensorMap x1, x2, y1, y2;
  if (!chunk_map(&x1, DKV ? k : q, bh, own, d, kBwdWideRows) ||
      !chunk_map(&x2, DKV ? v : dout, bh, own, d, kBwdWideRows) ||
      !chunk_map(&y1, DKV ? q : k, bh, str, d, kBwdWideCols) ||
      !chunk_map(&y2, DKV ? dout : v, bh, str, d, kBwdWideCols)) {
    return cudaErrorInvalidValue;
  }
  const int group = DKV ? 2 : 4;
  const long long blocks = (long long)((own + kBwdWideRows - 1) / kBwdWideRows) *
                           bh * ((d / kWide + group - 1) / group);
  if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if constexpr (DKV) {
    kernel<<<(unsigned)blocks, kBwdWideThreads, smem, stream>>>(
        x1, x2, y1, y2, (const float*)lse, (const float*)delta, (OutT*)out1,
        (OutT*)out2, bh, sq, sk, d, qscale, causal);
  } else {
    kernel<<<(unsigned)blocks, kBwdWideThreads, smem, stream>>>(
        x1, x2, y1, y2, (const float*)lse, (const float*)delta, (OutT*)out1,
        bh, sq, sk, d, qscale, scale, causal);
  }
  return cudaGetLastError();
}

template <typename Ks, typename InT, typename OutT>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int d, float qscale, int causal,
                            cudaStream_t stream) {
  if (d != 4 * kWide) {  // one chunk a CTA, grid z the chunks
    const auto kernel = Ks::dkv_chunk();
    cudaError_t err = prepare(kernel, BwdChunkSmem::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (sk + kWideRows - 1) / kWideRows, d / kWide);
    kernel<<<grid, kWideThreads, BwdChunkSmem::kBytes, stream>>>(
        (const InT*)q, (const InT*)k, (const InT*)v, (const InT*)dout,
        (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, sq, sk,
        d, qscale, causal);
    return cudaGetLastError();
  }
  return launch_bwd_wide<true, decltype(Ks::dkv_wide()), OutT>(
      Ks::dkv_wide(), q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
      qscale, 1.f, causal, stream);
}

template <typename Ks, typename InT, typename OutT>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int sq,
                           int sk, int d, float qscale, float scale,
                           int causal, cudaStream_t stream) {
  return launch_bwd_wide<false, decltype(Ks::dq_wide()), OutT>(
      Ks::dq_wide(), q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, d,
      qscale, scale, causal, stream);
}

// The head dims the library is built for; flash_attention.py's HEAD_DIMS
// lists the same values.
template <int... Ds>
struct HeadDims {};
using BuiltHeadDims = HeadDims<16, 32, 48, 64, 80, 96, 112, 128, 144, 160,
                               176, 192, 208, 224, 240, 256>;

// launch(std::integral_constant<int, D>) for the built D equal to d, else
// cudaErrorInvalidValue.
template <typename F, int... Ds>
cudaError_t dispatch_d(HeadDims<Ds...>, int d, F launch) {
  cudaError_t err = cudaErrorInvalidValue;
  ((d == Ds && ((err = launch(std::integral_constant<int, Ds>{})), true)) || ...);
  return err;
}

}  // namespace

// Plain C entry points of one form, bound with ctypes:
// hvd_flash_{fwd,dkv,dq}<SUFFIX>. Each returns a cudaError_t (0 on
// success); the caller raises on anything else.
#define HVD_FLASH_ENTRIES(SUFFIX, Ks, InT, OutT)                              \
  extern "C" int hvd_flash_fwd##SUFFIX(                                       \
      const void* q, const void* k, const void* v, void* o, void* lse,        \
      int bh, int sq, int sk, int d, float qscale, int causal,                \
      void* stream) {                                                         \
    if (d > 256) {                                                             \
      if (d % kWide) return cudaErrorInvalidValue;                             \
      return launch_fwd_wide<Ks, InT, OutT>(q, k, v, o, lse, bh, sq, sk, d,   \
                                            qscale, causal,                   \
                                            (cudaStream_t)stream);            \
    }                                                                         \
    return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {                       \
      return launch_fwd<decltype(D)::value, Ks, InT, OutT>(                   \
          q, k, v, o, lse, bh, sq, sk, qscale, causal, (cudaStream_t)stream); \
    });                                                                       \
  }                                                                           \
  extern "C" int hvd_flash_dkv##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv, int bh,         \
      int sq, int sk, int d, float qscale, int causal, void* stream) {        \
    if (d > 256) {                                                             \
      if (d % kWide) return cudaErrorInvalidValue;                             \
      return launch_dkv_wide<Ks, InT, OutT>(q, k, v, dout, lse, delta, dk,    \
                                            dv, bh, sq, sk, d, qscale,        \
                                            causal, (cudaStream_t)stream);    \
    }                                                                         \
    return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {                       \
      return launch_dkv<decltype(D)::value, Ks, InT, OutT>(                   \
          q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, qscale, causal,      \
          (cudaStream_t)stream);                                              \
    });                                                                       \
  }                                                                           \
  extern "C" int hvd_flash_dq##SUFFIX(                                        \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, int bh, int sq, int sk,   \
      int d, float qscale, float scale, int causal, void* stream) {           \
    if (d > 256) {                                                             \
      if (d % kWide) return cudaErrorInvalidValue;                             \
      return launch_dq_wide<Ks, InT, OutT>(q, k, v, dout, lse, delta, dq, bh, \
                                           sq, sk, d, qscale, scale, causal,  \
                                           (cudaStream_t)stream);             \
    }                                                                         \
    return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {                       \
      return launch_dq<decltype(D)::value, Ks, InT, OutT>(                    \
          q, k, v, dout, lse, delta, dq, bh, sq, sk, qscale, scale, causal,   \
          (cudaStream_t)stream);                                              \
    });                                                                       \
  }
