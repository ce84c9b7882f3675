// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, D] bf16, contiguous;
// lse and delta are [BH, S] fp32 (the [BH, S, 1] tensors of the Python
// side). Each kernel also has an fp32-output form (flash_*_f32_kernel,
// the hvd_flash_*_f32 entry points) for ring attention, whose merge adds
// n per-block results and would stack n bf16 roundings: the same body,
// templated on the output type, keeps the fp32 accumulator values and
// stores them as float2 pairs where the bf16 form packs them (Pair). D is one of BuiltHeadDims below (any multiple of 16 up to 128
// compiles); sq and sk take any length >= 1, causal or not. A head dim
// short of a whole number of 64-column blocks (32, 80, 96) is stored in
// shared memory at the next one, zero filled (tile_width): Q K^T and
// dO V^T take only D/16 k-steps, and P V, dS K, P^T dO and dS^T Qs run
// N = tile_width wide, their columns past D zero and never stored.
// All three kernels share one convention with the JAX package
// (horovod_tpu/ops/flash_attention.py):
//   - q is multiplied by the scale in bf16 before the QK^T product
//     (`qscale` is the scale already rounded to bf16 by the caller);
//   - masked scores are -1e30, not -inf;
//   - rows past the sequence are loaded as zeros before any product, and
//     nothing beyond the sequence is read;
//   - P is cast to bf16 before P.V, dS to bf16 before dS.Q and dS.K;
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

template <int D>
struct FwdSmem {                               // byte offsets
  static constexpr int kW = tile_width<D>();      // stored tile width
  static constexpr int kTile = kFwdCols * kW * 2;  // one K or V tile
  static constexpr int kRing = kFwdRows * kW * 2;  // Q [128, D] first
  // stage s: K at kRing + 2 s kTile, V right after it
  static constexpr int kBytes = kRing + kFwdStages * 2 * kTile + 1024;
};

template <int D, typename OutT>
__device__ __forceinline__ void
flash_fwd_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, OutT* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float qscale,
               int causal) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sRing = sQ + L::kRing;

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  q += (size_t)bh * sq * D;
  o += (size_t)bh * sq * D;
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

  // K and V of key tile kt into ring stage kt % kFwdStages; one commit
  // group per tile, empty past the last.
  auto issue = [&](int kt) {
    if (kt < n_kt) {
      const uint32_t tile = sRing + (kt % kFwdStages) * 2 * L::kTile;
      load_tile_async<D, kFwdCols, kFwdThreads>(tile, k, kt * kFwdCols, sk);
      load_tile_async<D, kFwdCols, kFwdThreads>(tile + L::kTile, v,
                                                kt * kFwdCols, sk);
    }
    cp_async_commit();
  };

  load_tile_async<D, kFwdRows, kFwdThreads>(sQ, q, q0, sq);
  cp_async_commit();
  for (int kt = 0; kt < kFwdStages - 1; ++kt) issue(kt);
  cp_async_wait<kFwdStages - 1>();  // this thread's Q chunks have landed
  scale_tile<D, kFwdRows, kFwdThreads>(smem, qscale);

  float acc[L::kW / 8][4];
#pragma unroll
  for (int i = 0; i < L::kW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    // Tile kt has landed (and Q is scaled) for every thread; the stage
    // tile kt-1 used is free, so tile kt+kFwdStages-1 goes into it now.
    cp_async_wait<kFwdStages - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(kt + kFwdStages - 1);
    if (kt >= n_mine) continue;  // wholly above this warpgroup's rows

    const uint32_t sK = sRing + (kt % kFwdStages) * 2 * L::kTile;
    const uint32_t sV = sK + L::kTile;
    const int k0 = kt * kFwdCols;

    // S = Qs K^T (64 rows x kFwdCols keys per warpgroup).
    float s[kFwdCols / 8][4];
#pragma unroll
    for (int j = 0; j < kFwdCols / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kFwdCols>(s, desc_kmajor<kFwdRows>(sQ, wg * 64, kk),
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
    for (int c = 0; c < kFwdCols / 16; ++c) acc_to_a(pa[c], s[2 * c], s[2 * c + 1]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
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
      wgmma_rs<D>(acc, pa[c], desc_mnmajor<kFwdCols>(sV, c));
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
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(orow + i * 8 + t * 2) =
          Pair<OutT>::of(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (t == 0) lse[row[r]] = m[r] + logf(l[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, float qscale,
                 int causal) {
  flash_fwd_body<D>(q, k, v, o, lse, sq, sk, qscale, causal);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, float qscale,
                     int causal) {
  flash_fwd_body<D>(q, k, v, o, lse, sq, sk, qscale, causal);
}

// ---------------------------------------------------------------------------
// dK / dV (K2)
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 128;     // key rows a CTA owns: two warpgroups
constexpr int kDkvCols = 64;      // q rows per streamed tile
constexpr int kDkvStages = 4;     // Qs/dO tiles in the ring
constexpr int kDkvThreads = 256;

template <int D>
struct DkvSmem {                                  // byte offsets
  static constexpr int kW = tile_width<D>();       // stored tile width
  static constexpr int kKV = kDkvRows * kW * 2;    // K at 0, V at kKV
  static constexpr int kTile = kDkvCols * kW * 2;  // one Qs or dO tile
  // stage s: Qs at kRing + 2 s kTile, dO right after it
  static constexpr int kRing = 2 * kKV;
  // stage s: lse[64] then delta[64] at kStats + 512 s
  static constexpr int kStats = kRing + kDkvStages * 2 * kTile;
  static constexpr int kBytes = kStats + kDkvStages * 512 + 1024;
};

template <int D, typename OutT>
__device__ __forceinline__ void
flash_dkv_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, OutT* __restrict__ dk,
               OutT* __restrict__ dv, int sq, int sk, float qscale,
               int causal) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + L::kKV;
  const uint32_t sRing = sK + L::kRing;
  const uint32_t sStats = sK + L::kStats;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvRows;  // low key tiles carry the most causal work
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + wg * 64;  // this warpgroup's first key row
  const int krow[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};

  const int n_qt = (sq + kDkvCols - 1) / kDkvCols;
  const int qt0 = causal ? k0 / kDkvCols : 0;

  // Qs, dO, lse and delta of q tile qt into ring stage (qt - qt0) %
  // kDkvStages; one commit group per tile, empty past the last.
  auto issue = [&](int qt) {
    if (qt < n_qt) {
      const int stage = (qt - qt0) % kDkvStages;
      const uint32_t tile = sRing + stage * 2 * L::kTile;
      load_tile_async<D, kDkvCols, kDkvThreads>(tile, q, qt * kDkvCols, sq);
      load_tile_async<D, kDkvCols, kDkvThreads>(tile + L::kTile, dout,
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

  load_tile_async<D, kDkvRows, kDkvThreads>(sK, k, k0, sk);
  load_tile_async<D, kDkvRows, kDkvThreads>(sV, v, k0, sk);
  for (int i = 0; i < kDkvStages - 1; ++i) issue(qt0 + i);

  float dka[L::kW / 8][4], dva[L::kW / 8][4];
#pragma unroll
  for (int i = 0; i < L::kW / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) % kDkvStages;
    // Tile qt has landed; scale this thread's own Qs chunks, then publish
    // the tile to wgmma. The stage tile qt-1 used is free for tile
    // qt+kDkvStages-1.
    cp_async_wait<kDkvStages - 2>();
    scale_tile<D, kDkvCols, kDkvThreads>(
        smem + L::kRing + stage * 2 * L::kTile, qscale);
    fence_proxy_async();
    __syncthreads();
    issue(qt + kDkvStages - 1);
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
      wgmma_ss<kDkvCols>(st, desc_kmajor<kDkvRows>(sK, wg * 64, kk),
                         desc_kmajor<kDkvCols>(sQ, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDkvCols>(dpt, desc_kmajor<kDkvRows>(sV, wg * 64, kk),
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
    for (int c = 0; c < kDkvCols / 16; ++c) acc_to_a(pa[c], st[2 * c], st[2 * c + 1]);
    fence_acc(dva);
    fence_frag(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) {
      wgmma_rs<D>(dva, pa[c], desc_mnmajor<kDkvCols>(sO, c));
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
    for (int c = 0; c < kDkvCols / 16; ++c) acc_to_a(dsa[c], st[2 * c], st[2 * c + 1]);
    wgmma_wait<0>();
    fence_acc(dva);
    fence_frag(pa);

    // dK += dS^T Qs.
    fence_acc(dka);
    fence_frag(dsa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kDkvCols / 16; ++c) {
      wgmma_rs<D>(dka, dsa[c], desc_mnmajor<kDkvCols>(sQ, c));
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
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(dkr + i * 8 + t * 2) =
          Pair<OutT>::of(dka[i][2 * r], dka[i][2 * r + 1]);
      *reinterpret_cast<typename Pair<OutT>::T*>(dvr + i * 8 + t * 2) =
          Pair<OutT>::of(dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int sq, int sk, float qscale,
                 int causal) {
  flash_dkv_body<D>(q, k, v, dout, lse, delta, dk, dv, sq, sk, qscale,
                    causal);
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads)
flash_dkv_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, float qscale,
                     int causal) {
  flash_dkv_body<D>(q, k, v, dout, lse, delta, dk, dv, sq, sk, qscale,
                    causal);
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
constexpr int kDqThreads = 256;

template <int D>
struct DqSmem {                                  // byte offsets
  static constexpr int kW = tile_width<D>();      // stored tile width
  static constexpr int kQ = kDqRows * kW * 2;     // Qs at 0, dO at kQ
  static constexpr int kTile = kDqCols * kW * 2;  // one K or V tile
  // stage s: K at kRing + 2 s kTile, V right after it
  static constexpr int kRing = 2 * kQ;
  static constexpr int kBytes = kRing + kDqStages * 2 * kTile + 1024;
};

template <int D, typename OutT>
__device__ __forceinline__ void
flash_dq_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, OutT* __restrict__ dq,
              int sq, int sk, float qscale, float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + L::kQ;
  const uint32_t sRing = sQ + L::kRing;

  const int bh = blockIdx.x;
  // Heaviest (last) causal tiles first: they start while the grid fills.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
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
    n_kt = min(n_kt, (min(q0 + kDqRows, sq) - 1) / kDqCols + 1);
    if (r0 < sq) n_mine = min(n_kt, (min(r0 + 64, sq) - 1) / kDqCols + 1);
  }

  // K and V of key tile kt into ring stage kt % kDqStages; one commit
  // group per tile, empty past the last.
  auto issue = [&](int kt) {
    if (kt < n_kt) {
      const uint32_t tile = sRing + (kt % kDqStages) * 2 * L::kTile;
      load_tile_async<D, kDqCols, kDqThreads>(tile, k, kt * kDqCols, sk);
      load_tile_async<D, kDqCols, kDqThreads>(tile + L::kTile, v,
                                              kt * kDqCols, sk);
    }
    cp_async_commit();
  };

  load_tile_async<D, kDqRows, kDqThreads>(sQ, q, q0, sq);
  load_tile_async<D, kDqRows, kDqThreads>(sO, dout, q0, sq);
  cp_async_commit();
  for (int kt = 0; kt < kDqLead; ++kt) issue(kt);
  cp_async_wait<kDqLead>();  // this thread's Q and dO chunks have landed
  scale_tile<D, kDqRows, kDqThreads>(smem, qscale);

  float dqa[L::kW / 8][4];
#pragma unroll
  for (int i = 0; i < L::kW / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  float s[kDqCols / 8][4], dp[kDqCols / 8][4];  // S and dP of the tile in hand
  uint32_t dsa[kDqCols / 16][4];                // its dS: the dQ product's A

  // Tile kt has landed (and Qs is scaled) for every thread; tile
  // kt+kDqLead goes into the stage that tile kt+kDqLead-kDqStages used.
  auto next_tile = [&](int kt) {
    cp_async_wait<kDqLead - 1>();
    fence_proxy_async();
    __syncthreads();
    issue(kt + kDqLead);
  };
  // S = Qs K^T and dP = dO V^T of key tile kt (64 rows x kDqCols keys
  // per warpgroup), one batch; the first k-step overwrites S and dP.
  auto s_dp = [&](int kt) {
    const uint32_t sK = sRing + (kt % kDqStages) * 2 * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDqCols>(s, desc_kmajor<kDqRows>(sQ, wg * 64, kk),
                        desc_kmajor<kDqCols>(sK, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDqCols>(dp, desc_kmajor<kDqRows>(sO, wg * 64, kk),
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
      for (int c = 0; c < kDqCols / 16; ++c) acc_to_a(dsa[c], s[2 * c], s[2 * c + 1]);

      // dQ += dS K: dS from registers, K MN-major.
      const uint32_t sK = sRing + (kt % kDqStages) * 2 * L::kTile;
      fence_acc(dqa);
      fence_frag(dsa);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kDqCols / 16; ++c) {
        wgmma_rs<D>(dqa, dsa[c], desc_mnmajor<kDqCols>(sK, c));
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
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<typename Pair<OutT>::T*>(dqr + i * 8 + t * 2) =
          Pair<OutT>::of(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kDqThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int sq, int sk, float qscale, float scale, int causal) {
  flash_dq_body<D>(q, k, v, dout, lse, delta, dq, sq, sk, qscale, scale,
                   causal);
}

template <int D>
__global__ void __launch_bounds__(kDqThreads)
flash_dq_f32_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int sq, int sk, float qscale, float scale, int causal) {
  flash_dq_body<D>(q, k, v, dout, lse, delta, dq, sq, sk, qscale, scale,
                   causal);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// The kernel of each output type: the bf16 forms and the fp32 forms.
template <int D> auto fwd_kernel(bf16*) { return flash_fwd_kernel<D>; }
template <int D> auto fwd_kernel(float*) { return flash_fwd_f32_kernel<D>; }
template <int D> auto dkv_kernel(bf16*) { return flash_dkv_kernel<D>; }
template <int D> auto dkv_kernel(float*) { return flash_dkv_f32_kernel<D>; }
template <int D> auto dq_kernel(bf16*) { return flash_dq_kernel<D>; }
template <int D> auto dq_kernel(float*) { return flash_dq_f32_kernel<D>; }

template <int D, typename OutT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, float qscale,
                       int causal, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::kBytes;
  const auto kernel = fwd_kernel<D>((OutT*)nullptr);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (OutT*)o, (float*)lse,
      sq, sk, qscale, causal);
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk,
                       float qscale, int causal, cudaStream_t stream) {
  constexpr int smem = DkvSmem<D>::kBytes;
  const auto kernel = dkv_kernel<D>((OutT*)nullptr);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sk + kDkvRows - 1) / kDkvRows);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, sq, sk,
      qscale, causal);
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, float qscale,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int smem = DqSmem<D>::kBytes;
  const auto kernel = dq_kernel<D>((OutT*)nullptr);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kDqRows - 1) / kDqRows);
  kernel<<<grid, kDqThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dq, sq, sk, qscale,
      scale, causal);
  return cudaGetLastError();
}

// The head dims the library is built for; flash_attention.py's HEAD_DIMS
// lists the same values.
template <int... Ds>
struct HeadDims {};
using BuiltHeadDims = HeadDims<32, 64, 80, 96, 128>;

// launch(std::integral_constant<int, D>) for the built D equal to d, else
// cudaErrorInvalidValue.
template <typename F, int... Ds>
cudaError_t dispatch_d(HeadDims<Ds...>, int d, F launch) {
  cudaError_t err = cudaErrorInvalidValue;
  ((d == Ds && ((err = launch(std::integral_constant<int, Ds>{})), true)) || ...);
  return err;
}

// One entry point's body for each output type.
template <typename OutT>
int fwd_entry(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int sq, int sk, int d, float qscale,
              int causal, void* stream) {
  return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {
    return launch_fwd<decltype(D)::value, OutT>(
        q, k, v, o, lse, bh, sq, sk, qscale, causal, (cudaStream_t)stream);
  });
}

template <typename OutT>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int sq, int sk, int d, float qscale, int causal, void* stream) {
  return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {
    return launch_dkv<decltype(D)::value, OutT>(
        q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, qscale, causal,
        (cudaStream_t)stream);
  });
}

template <typename OutT>
int dq_entry(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int sq,
             int sk, int d, float qscale, float scale, int causal,
             void* stream) {
  return dispatch_d(BuiltHeadDims{}, d, [&](auto D) {
    return launch_dq<decltype(D)::value, OutT>(
        q, k, v, dout, lse, delta, dq, bh, sq, sk, qscale, scale, causal,
        (cudaStream_t)stream);
  });
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns a cudaError_t
// (0 on success); the caller raises on anything else.
extern "C" {

// The bf16-output forms, then the fp32-output forms (_f32) with the same
// arguments.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int sq, int sk, int d, float qscale,
                  int causal, void* stream) {
  return fwd_entry<bf16>(q, k, v, o, lse, bh, sq, sk, d, qscale, causal,
                         stream);
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int sq, int sk, int d,
                  float qscale, int causal, void* stream) {
  return dkv_entry<bf16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                         qscale, causal, stream);
}

int hvd_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int sq, int sk, int d, float qscale,
                 float scale, int causal, void* stream) {
  return dq_entry<bf16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, qscale,
                        scale, causal, stream);
}

int hvd_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int sq, int sk, int d, float qscale,
                      int causal, void* stream) {
  return fwd_entry<float>(q, k, v, o, lse, bh, sq, sk, d, qscale, causal,
                          stream);
}

int hvd_flash_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int sq, int sk, int d,
                      float qscale, int causal, void* stream) {
  return dkv_entry<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                          qscale, causal, stream);
}

int hvd_flash_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int sq, int sk, int d, float qscale,
                     float scale, int causal, void* stream) {
  return dq_entry<float>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                         qscale, scale, causal, stream);
}

}  // extern "C"
