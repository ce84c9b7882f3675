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
// dim above 256 to one) and nc = d / 128 its chunks. Each CTA owns one
// 128-column chunk c = blockIdx.z of its output (O in K1, dK and dV in
// K2, dQ in K3), as the 256-wide tiles above do. The products that sum
// over d (Q K^T, and dO V^T in K2 and K3) stream d through the ring one
// 128-column k-chunk at a time and accumulate S (and dP) in registers
// across the chunks, so a stage holds what a D = 128 tile holds whatever
// d is. One ring item is one k-chunk of one streamed tile: the owned
// rows' chunk (Q, or K2's K and V) beside the streamed rows' chunk (K,
// or Qs and dO, and V), re-read from L2 for every streamed tile. K2 and
// K3 visit the chunks from c + 1 round to c, so the last item of a tile
// holds the chunk c operand of its RS product (dO and Qs in K2, K in K3)
// and no extra load is needed; K1 loads V's chunk c with its last item.
// Three stages, one item ahead in flight; every product retires in the
// item that issued it. The work grows as nc: each CTA recomputes S (and
// dP) over the whole d. A correct first form, not a tuned one.

constexpr int kWide = 128;         // columns of one chunk
constexpr int kWideStages = 3;     // ring items
constexpr int kWideRows = 64;      // rows a K2/K3 CTA owns: one warpgroup
constexpr int kWideThreads = 128;
constexpr int kChunkTile = 64 * kWide * 2;  // a [64, 128] 16-bit chunk

struct FwdWideSmem {                     // byte offsets in one stage
  static constexpr int kK = kFwdRows * kWide * 2;  // Q chunk [128, 128] at 0
  static constexpr int kV = kK + kChunkTile;
  static constexpr int kStage = kV + kChunkTile;
  static constexpr int kBytes = kWideStages * kStage + 1024;
};

struct BwdWideSmem {                     // K2 and K3: four [64, 128] chunks
  static constexpr int kStage = 4 * kChunkTile;
  static constexpr int kStats = kWideStages * kStage;  // K2: lse, delta
  static constexpr int kBytes = kStats + kWideStages * 512 + 1024;
};

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_fwd_wide_body(const InT* __restrict__ q, const InT* __restrict__ k,
                    const InT* __restrict__ v, OutT* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int d,
                    float qscale, int causal) {
  using L = FwdWideSmem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sRing = smem_u32(smem);

  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  q += (size_t)bh * sq * d;
  o += (size_t)bh * sq * d + c * kWide;
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64;  // this warpgroup's first q row
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};

  int n_kt = (sk + kFwdCols - 1) / kFwdCols;
  int n_mine = r0 < sq ? n_kt : 0;
  if (causal) {
    n_kt = min(n_kt, (min(q0 + kFwdRows, sq) - 1) / kFwdCols + 1);
    if (r0 < sq) n_mine = min(n_kt, (min(r0 + 64, sq) - 1) / kFwdCols + 1);
  }
  const int n_items = n_kt * nc;

  // Item it = key tile it / nc, k-chunk it % nc: Q's and K's chunk, and
  // V's chunk c with the tile's last chunk; one commit group per item.
  auto issue = [&](int it) {
    if (it < n_items) {
      const int kt = it / nc, dc = it % nc;
      const uint32_t st = sRing + (it % kWideStages) * L::kStage;
      load_chunk_async<kFwdRows, kFwdThreads>(st, q, q0, sq, d, dc * kWide);
      load_chunk_async<kFwdCols, kFwdThreads>(st + L::kK, k, kt * kFwdCols,
                                              sk, d, dc * kWide);
      if (dc == nc - 1) {
        load_chunk_async<kFwdCols, kFwdThreads>(st + L::kV, v, kt * kFwdCols,
                                                sk, d, c * kWide);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float acc[kWide / 8][4];
#pragma unroll
  for (int i = 0; i < kWide / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float s[kFwdCols / 8][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_items; ++it) {
    // Item it has landed; scale this thread's own Q copies, publish the
    // stage to wgmma, and refill the stage item it-1 used.
    const int st_off = (it % kWideStages) * L::kStage;
    cp_async_wait<1>();
    scale_tile<kWide, kFwdRows, kFwdThreads, InT>(smem + st_off, qscale);
    fence_proxy_async();
    __syncthreads();
    issue(it + 2);
    const int kt = it / nc, dc = it % nc;
    if (kt >= n_mine) continue;  // wholly above this warpgroup's rows

    // S (+)= Qs K^T over this k-chunk; the first chunk overwrites S.
    const uint32_t sQ = sRing + st_off;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kFwdCols, InT>(s, desc_kmajor<kFwdRows>(sQ, wg * 64, kk),
                              desc_kmajor<kFwdCols>(sQ + L::kK, 0, kk),
                              dc | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    if (dc != nc - 1) continue;

    // The online softmax and O += P V, as in flash_fwd_body.
    const int k0 = kt * kFwdCols;
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
    for (int cc = 0; cc < kFwdCols / 16; ++cc) acc_to_a_as<InT>(pa[cc], s[2 * cc], s[2 * cc + 1]);
#pragma unroll
    for (int i = 0; i < kWide / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
    fence_acc(acc);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < kFwdCols / 16; ++cc) {
      wgmma_rs<kWide, InT>(acc, pa[cc], desc_mnmajor<kFwdCols>(sQ + L::kV, cc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
  }
  cp_async_wait<0>();

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
    OutT* orow = o + (size_t)row[r] * d;
#pragma unroll
    for (int i = 0; i < kWide / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(orow + i * 8 + t * 2) =
          Pair<OutT>::of(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (t == 0 && c == 0) lse[row[r]] = m[r] + logf(l[r]);
  }
}

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_dkv_wide_body(const InT* __restrict__ q, const InT* __restrict__ k,
                    const InT* __restrict__ v, const InT* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, OutT* __restrict__ dk,
                    OutT* __restrict__ dv, int sq, int sk, int d,
                    float qscale, int causal) {
  using L = BwdWideSmem;
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

template <typename InT, typename OutT>
__device__ __forceinline__ void
flash_dq_wide_body(const InT* __restrict__ q, const InT* __restrict__ k,
                   const InT* __restrict__ v, const InT* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, OutT* __restrict__ dq,
                   int sq, int sk, int d, float qscale, float scale,
                   int causal) {
  using L = BwdWideSmem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sRing = smem_u32(smem);

  const int nc = d / kWide, c = blockIdx.z;
  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWideRows;
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  dq += (size_t)bh * sq * d + c * kWide;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], del[2];  // lse in base 2, and delta, of this thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < sq ? lse[row[r]] * kLog2e : 0.f;
    del[r] = row[r] < sq ? delta[row[r]] : 0.f;
  }

  int n_kt = (sk + kDqCols - 1) / kDqCols;
  if (causal) n_kt = min(n_kt, (min(q0 + kWideRows, sq) - 1) / kDqCols + 1);
  const int n_items = n_kt * nc;

  // Item it = key tile it / nc, k-chunk (c + 1 + it % nc) % nc: Qs's,
  // dO's, K's and V's chunks in a stage at 0, 1, 2, 3 chunk tiles.
  auto issue = [&](int it) {
    if (it < n_items) {
      const int kt = it / nc;
      const int col = ((c + 1 + it % nc) % nc) * kWide;
      const uint32_t st = sRing + (it % kWideStages) * L::kStage;
      load_chunk_async<kWideRows, kWideThreads>(st, q, q0, sq, d, col);
      load_chunk_async<kWideRows, kWideThreads>(st + kChunkTile, dout, q0, sq,
                                                d, col);
      load_chunk_async<kDqCols, kWideThreads>(st + 2 * kChunkTile, k,
                                              kt * kDqCols, sk, d, col);
      load_chunk_async<kDqCols, kWideThreads>(st + 3 * kChunkTile, v,
                                              kt * kDqCols, sk, d, col);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float dqa[kWide / 8][4];
#pragma unroll
  for (int i = 0; i < kWide / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  float s[kDqCols / 8][4], dp[kDqCols / 8][4];

  for (int it = 0; it < n_items; ++it) {
    const int st_off = (it % kWideStages) * L::kStage;
    cp_async_wait<1>();
    scale_tile<kWide, kWideRows, kWideThreads, InT>(smem + st_off, qscale);
    fence_proxy_async();
    __syncthreads();
    issue(it + 2);
    const int kt = it / nc, j = it % nc;
    const uint32_t sQ = sRing + st_off;
    const uint32_t sO = sQ + kChunkTile;
    const uint32_t sK = sQ + 2 * kChunkTile;
    const uint32_t sV = sQ + 3 * kChunkTile;

    // S (+)= Qs K^T and dP (+)= dO V^T over this k-chunk.
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kDqCols, InT>(s, desc_kmajor<kWideRows>(sQ, 0, kk),
                             desc_kmajor<kDqCols>(sK, 0, kk), j | kk);
    }
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
      wgmma_ss<kDqCols, InT>(dp, desc_kmajor<kWideRows>(sO, 0, kk),
                             desc_kmajor<kDqCols>(sV, 0, kk), j | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    if (j != nc - 1) continue;

    // The stage holds chunk c of K: dS and dQ += dS K as in flash_dq_body.
    const int k0 = kt * kDqCols;
    const bool edge = k0 + kDqCols > sk || (causal && k0 + kDqCols - 1 > q0);
#pragma unroll
    for (int jj = 0; jj < kDqCols / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[jj][e], kLog2e, -lse2[e >> 1]));
        if (edge && !valid_pair(row[e >> 1], k0 + jj * 8 + t * 2 + (e & 1),
                                sq, sk, causal)) {
          p = 0.f;
        }
        s[jj][e] = p * (dp[jj][e] - del[e >> 1]);
      }
    }
    uint32_t dsa[kDqCols / 16][4];
#pragma unroll
    for (int cc = 0; cc < kDqCols / 16; ++cc) acc_to_a_as<InT>(dsa[cc], s[2 * cc], s[2 * cc + 1]);
    fence_acc(dqa);
    fence_frag(dsa);
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < kDqCols / 16; ++cc) {
      wgmma_rs<kWide, InT>(dqa, dsa[cc], desc_mnmajor<kDqCols>(sK, cc));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    fence_frag(dsa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    OutT* dqr = dq + (size_t)row[r] * d;
#pragma unroll
    for (int i = 0; i < kWide / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(dqr + i * 8 + t * 2) =
          Pair<OutT>::of(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
    }
  }
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
  __global__ void __launch_bounds__(kFwdThreads)                             \
      flash_fwd##PREFIX##_wide_kernel(                                        \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, OutT* __restrict__ o,                    \
          float* __restrict__ lse, int sq, int sk, int d, float qscale,       \
          int causal) {                                                       \
    flash_fwd_wide_body<InT, OutT>(q, k, v, o, lse, sq, sk, d, qscale,        \
                                   causal);                                   \
  }                                                                           \
  __global__ void __launch_bounds__(kWideThreads)                            \
      flash_dkv##PREFIX##_wide_kernel(                                        \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, const InT* __restrict__ dout,            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dk, OutT* __restrict__ dv, int sq, int sk,       \
          int d, float qscale, int causal) {                                  \
    flash_dkv_wide_body<InT, OutT>(q, k, v, dout, lse, delta, dk, dv, sq, sk, \
                                   d, qscale, causal);                        \
  }                                                                           \
  __global__ void __launch_bounds__(kWideThreads)                            \
      flash_dq##PREFIX##_wide_kernel(                                         \
          const InT* __restrict__ q, const InT* __restrict__ k,               \
          const InT* __restrict__ v, const InT* __restrict__ dout,            \
          const float* __restrict__ lse, const float* __restrict__ delta,     \
          OutT* __restrict__ dq, int sq, int sk, int d, float qscale,         \
          float scale, int causal) {                                          \
    flash_dq_wide_body<InT, OutT>(q, k, v, dout, lse, delta, dq, sq, sk, d,   \
                                  qscale, scale, causal);                     \
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

// Launchers of one form's _wide kernels: d a multiple of kWide above 256,
// grid z its chunks.
template <typename Ks, typename InT, typename OutT>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk, int d,
                            float qscale, int causal, cudaStream_t stream) {
  const auto kernel = Ks::fwd_wide();
  cudaError_t err = prepare(kernel, FwdWideSmem::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows, d / kWide);
  kernel<<<grid, kFwdThreads, FwdWideSmem::kBytes, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (OutT*)o, (float*)lse,
      sq, sk, d, qscale, causal);
  return cudaGetLastError();
}

template <typename Ks, typename InT, typename OutT>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int sq, int sk, int d, float qscale, int causal,
                            cudaStream_t stream) {
  const auto kernel = Ks::dkv_wide();
  cudaError_t err = prepare(kernel, BwdWideSmem::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sk + kWideRows - 1) / kWideRows, d / kWide);
  kernel<<<grid, kWideThreads, BwdWideSmem::kBytes, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (const InT*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, sq, sk,
      d, qscale, causal);
  return cudaGetLastError();
}

template <typename Ks, typename InT, typename OutT>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int sq,
                           int sk, int d, float qscale, float scale,
                           int causal, cudaStream_t stream) {
  const auto kernel = Ks::dq_wide();
  cudaError_t err = prepare(kernel, BwdWideSmem::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kWideRows - 1) / kWideRows, d / kWide);
  kernel<<<grid, kWideThreads, BwdWideSmem::kBytes, stream>>>(
      (const InT*)q, (const InT*)k, (const InT*)v, (const InT*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dq, sq, sk, d, qscale,
      scale, causal);
  return cudaGetLastError();
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
