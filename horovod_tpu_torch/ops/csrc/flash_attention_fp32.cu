// Flash attention on fp32 operands, the fp32 forms of K1-K3
// (flash_attention.cuh has the 16-bit forms, on wgmma): every product on
// the tensor cores in split TF32.
//
// flash_fwd_fp32_kernel  replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel
// flash_dkv_fp32_kernel  replaces horovod_tpu/ops/flash_attention.py::_dkv_kernel
// flash_dq_fp32_kernel   replaces horovod_tpu/ops/flash_attention.py::_dq_kernel
//   on fp32 operands, where JAX's products are fp32 x fp32 with fp32
//   accumulation (preferred_element_type=jnp.float32 on fp32 inputs).
//
// Every product runs on mma.sync m16n8k8 .tf32 in the split form
// (3xTF32): each fp32 operand x is big, x rounded to TF32 as cvt.rna
// rounds, plus small = x - big, which the tensor core reads rounded
// toward zero; each product is small*big + big*small + big*big
// accumulated in fp32, which keeps ~21 of fp32's 24 bits where a single
// TF32 pass keeps ~11.
//
// Bounds on an H100 SXM at the flagship's attention (BH=48, S=2048,
// D=128, causal), at a third of the 494.7 TFLOP/s TF32 peak: the
// forward's two products, 51.6 GFLOP, 0.313 ms; K2's 103 GFLOP, 0.63 ms;
// K3's 77 GFLOP, 0.47 ms (0.77, 1.54 and 1.15 ms at the 67 TFLOP/s FMA
// peak). mma.sync itself peaks at ~61% of that TF32 rate on an H100
// (experiments/flash_fwd_split.py: 301-305 TFLOP/s), so 0.51, 1.03 and
// 0.77 ms is the floor of this route. At D = 512 (BH = 24) the forward's
// work doubles: bound 0.626 ms, floor 1.02 ms. What the route leaves on
// the table: the three passes (a third of the TF32 rate), mma.sync's
// ~61% of it (wgmma reads tf32 from shared memory K-major only: it fits
// S = Qs K^T but P V would need V transposed), and the split itself, three
// integer or float operations a value on the issue slots the products
// need, which every warp repeats for the tiles it shares.
//
// Layout: q, k, v, o, do, dq, dk, dv are [BH, S, d] fp32, contiguous, d a
// multiple of 4 up to 256 (the wrapper pads every head dim to a multiple
// of 16) or, above 256, a multiple of 128; lse and delta are [BH, S]
// fp32. The numerics are JAX's on fp32: q * scale in fp32, masked scores
// -1e30 with P = 0, the exponentials as exp2f(fmaf(s, log2 e, -x log2 e))
// (x the running max m in K1, lse in K2 and K3, as the 16-bit forms take
// it), lse = m + log(max(l, 1e-30)), dS = P (dP - delta), dQ scaled once
// at the end. Each output has one owner CTA: no atomics, and repeats are
// bit-identical. Heaviest causal blocks are scheduled first. Kernels
// launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// The split, the fragments and the ring (every kernel's)
// ---------------------------------------------------------------------------
//
// Why mma.sync and not wgmma: wgmma reads tf32 operands from shared
// memory K-major only (the transpose bit exists for 16-bit types), so
// O += P V, dV += P^T dO, dK += dS^T Qs and dQ += dS K would need
// transposed copies; mma.sync takes its fragments from registers, loaded
// in any layout.
//
// Fragments. In a product over d, a 16-column block gives each thread one
// LDS.128 a row: k-step 0 takes columns 4t and 4t + 1 as its slots t and
// t + 4, k-step 1 columns 4t + 2 and 4t + 3 (the same permutation for A
// and B, so the sum is unchanged). A first product's accumulator holds
// (row g, columns 2t, 2t + 1) of each 8-column n-tile: read as the A
// fragment of the second product with slot t = streamed row 2t and slot
// t + 4 = row 2t + 1, it needs no shuffle; B then loads rows 2t and 2t + 1
// of the streamed tile, columns 4g..4g+3 of a 32-column block with one
// LDS.128 each, and gives column 4g + j to n-tile j, so a thread's
// accumulator holds columns 8t..8t+7 of each block: two float4 stores a
// row. Tiles are [rows][128] fp32 with the 16-byte chunk ch of row r at
// ch ^ swz(r) (low three bits): swz(r) = 2 ((r >> 1) & 3) ^ 4 (r & 1)
// makes both read patterns (rows g = 2p, 2p + 1 at chunks t; rows 2t,
// 2t + 1 at chunk g) conflict-free. Tiles land by cp.async in a two-stage
// ring, the next step's copies under this step's products; columns past
// d and rows past sq or sk land as zeros, and nothing past them is read
// from global memory or written.

constexpr int kChunk = 128;          // columns of a stored tile: one d chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;        // every CTA: two groups of four warps

// x = big + small. big is x rounded to TF32 as cvt.rna.tf32.f32 rounds a
// finite value (half an ulp of the 13 dropped bits added to the
// magnitude, then those bits cleared: two integer operations, where
// cvt.rna also tests for NaN and infinity); small = x - big is exact and
// goes to the tensor core as it is, which reads a .tf32 register's top
// 19 bits (small rounded toward zero).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in three passes: small A big B, big A small B, big A big B.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

__device__ __forceinline__ int swz(int r) {
  return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of rows row0..row0+R-1, columns col0..col0+127 of a
// [seq, d] matrix into a swizzled [R][128] tile; rows past seq and
// columns past d land as zeros.
template <int R>
__device__ __forceinline__ void fetch_tile(float* tile, const float* src,
                                           int row0, int seq, int d,
                                           int col0) {
#pragma unroll
  for (int i = 0; i < R * 32 / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p >> 5, ch = p & 31, col = col0 + 4 * ch;
    const bool ok = row0 + r < seq && col < d;
    cp16(tile + r * kChunk + ((ch ^ swz(r)) << 2),
         ok ? src + (size_t)(row0 + r) * d + col : src, ok);
  }
}

// lse then delta of rows row0..row0+BN-1 (zeros past seq) into dst[2 BN].
template <int BN>
__device__ __forceinline__ void fetch_stats(float* dst, const float* lse,
                                            const float* delta, int row0,
                                            int seq) {
  const int i = threadIdx.x;
  if (i < 2 * BN) {
    const int r = row0 + i % BN;
    const float* src = i < BN ? lse : delta;
    cp4(dst + i, r < seq ? src + r : src, r < seq);
  }
}

// acc[n] += (rows a0..a0+15 of tile A) . (rows 8n..8n+7 of tile B) over
// nb 16-column blocks; A (SA) or B (SB) is multiplied by qscale first.
template <int BN, bool SA, bool SB>
__device__ __forceinline__ void rows_product(float (&acc)[BN / 8][4],
                                             const float* sA, int a0,
                                             const float* sB, float qscale,
                                             int nb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = swz(g);
  // chunk 4b + t of a row with swizzle h: block b's float offset is
  // 32 (b / 2) plus off0 for an even b, off1 for an odd one
  const int off0 = (t ^ h) << 2, off1 = ((4 + t) ^ h) << 2;
  const float* pa = sA + (a0 + g) * kChunk;
  const float* pb = sB + g * kChunk;
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const int o = 32 * (b >> 1) + (b & 1 ? off1 : off0);
    float4 x = lds4(pa + o), y = lds4(pa + 8 * kChunk + o);
    if (SA) {
      x = make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
      y = make_float4(y.x * qscale, y.y * qscale, y.z * qscale, y.w * qscale);
    }
    uint32_t ab[2][4], as[2][4];
    split(x.x, ab[0][0], as[0][0]);
    split(y.x, ab[0][1], as[0][1]);
    split(x.y, ab[0][2], as[0][2]);
    split(y.y, ab[0][3], as[0][3]);
    split(x.z, ab[1][0], as[1][0]);
    split(y.z, ab[1][1], as[1][1]);
    split(x.w, ab[1][2], as[1][2]);
    split(y.w, ab[1][3], as[1][3]);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      float4 z = lds4(pb + n * 8 * kChunk + o);
      if (SB) {
        z = make_float4(z.x * qscale, z.y * qscale, z.z * qscale,
                        z.w * qscale);
      }
      uint32_t bb[2][2], bs[2][2];
      split(z.x, bb[0][0], bs[0][0]);
      split(z.y, bb[0][1], bs[0][1]);
      split(z.z, bb[1][0], bs[1][0]);
      split(z.w, bb[1][1], bs[1][1]);
      mma3(acc[n], ab[0], as[0], bb[0], bs[0]);
      mma3(acc[n], ab[1], as[1], bb[1], bs[1]);
    }
  }
}

// acc[m][j] += A (a first product's 16 x BN accumulator, as it stands)
// times the BN rows of tile B (times qscale when SB), over the columns
// of 32-column blocks m0 + m below nm; n-tile j of a block takes columns
// 4g + j.
template <int BN, int NM, bool SB>
__device__ __forceinline__ void cols_product(float (&acc)[NM][4][4],
                                             const float (&a)[BN / 8][4],
                                             const float* sB, float qscale,
                                             int m0, int nm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // rows 2t and 2t + 1 (swizzles 2t and 2t ^ 4), chunk g of a block
  const float* p0 = sB + 2 * t * kChunk + 32 * m0 + ((g ^ (2 * t)) << 2);
  const float* p1 = sB + (2 * t + 1) * kChunk + 32 * m0 +
                    ((g ^ (2 * t) ^ 4) << 2);
#pragma unroll
  for (int k = 0; k < BN / 8; ++k) {
    uint32_t ab[4], as[4];
    split(a[k][0], ab[0], as[0]);   // row g,     slot t:     column 2t
    split(a[k][2], ab[1], as[1]);   // row g + 8, slot t
    split(a[k][1], ab[2], as[2]);   // row g,     slot t + 4: column 2t + 1
    split(a[k][3], ab[3], as[3]);   // row g + 8, slot t + 4
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (m0 + m >= nm) break;
      float4 u = lds4(p0 + 8 * k * kChunk + 32 * m);
      float4 w = lds4(p1 + 8 * k * kChunk + 32 * m);
      if (SB) {
        u = make_float4(u.x * qscale, u.y * qscale, u.z * qscale,
                        u.w * qscale);
        w = make_float4(w.x * qscale, w.y * qscale, w.z * qscale,
                        w.w * qscale);
      }
      const float uu[4] = {u.x, u.y, u.z, u.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[2], bs[2];
        split(uu[j], bb[0], bs[0]);
        split(ww[j], bb[1], bs[1]);
        mma3(acc[m][j], ab, as, bb, bs);
      }
    }
  }
}

// Store rows row0 + g and row0 + g + 8 (those below seq) of the
// columns of blocks m0 + m below nm and below dc, times mul: row g's c0
// of n-tiles 0..3 are columns 8t..8t+3 of the block, its c1 8t+4..8t+7.
template <int NM>
__device__ __forceinline__ void store_cols(float* out, int ld, int row0,
                                           int seq,
                                           const float (&acc)[NM][4][4],
                                           int m0, int nm, int dc,
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    if (m0 + m >= nm) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row >= seq) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 32 * (m0 + m) + 8 * t + 4 * e;
        if (col >= dc) continue;
        const int i = 2 * half + e;
        *reinterpret_cast<float4*>(out + (size_t)row * ld + col) =
            make_float4(acc[m][0][i] * mul, acc[m][1][i] * mul,
                        acc[m][2][i] * mul, acc[m][3][i] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The forward: K1 on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------
//
// A CTA of 8 warps, 16 rows of q a warp, walks the key tiles of BN = 64
// rows (the heaviest causal q tiles first), each tile's copies issued
// under the previous tile's products. Per tile a warp adds S = Qs K^T over
// d (Qs = q * qscale in fp32, formed as the fragments load), masks S only
// where the tile crosses the diagonal or the key tail, moves its rows'
// running max m and sum l in registers, and adds the tile's P V to its
// rescaled O accumulator (16 rows x 128 columns), P read from S's
// accumulator as the A fragment (no shuffle). The tensor core's sums
// start from zero for each tile's P V and each d chunk's S and join the
// running sums in fp32 (add_pv). A warp whose rows all lie before a
// causal tile skips it. At the end O /= max(l, 1e-30) and lse = m +
// log(max(l, 1e-30)).
//
// Head dims up to 128 (G = 1): a CTA owns 128 rows, 16 a warp. Qs's
// 128 x 128 tile lands once and stays; each ring stage holds one key
// tile's K and V.
//
// Above 128 (G = 2): a CTA owns 64 rows in two groups of four warps that
// share them (warp & 3), and a pair of 128-column output chunks, 2z and
// 2z + 1 (grid z), one a group. S is computed once a tile for both
// groups: group g takes keys 32g..32g+31 of it, over the whole d, with
// Q's and K's d chunks in the ring in turn (one step each) and then a
// step holding the V chunks of the two output chunks. There the two
// groups swap their rows' maxima, then their P in fragment order (a
// thread's values at [warp][value][lane], as the backward's exchange),
// through shared memory, and each adds P V over all 64 keys into its
// chunk; their row sums are added at the end. Of the two ways to serve
// more than one output chunk this takes the shared S (P through shared
// memory: two __syncthreads a tile and 16 KB) over the backward's
// recompute (each chunk's CTA computing S over the whole d: 1.5x the
// products at d = 256, 2.5x at 512), since the forward has one product
// over d where the backward has two and no room to keep both; with pairs
// S is computed once at d <= 256 and once a pair above (1.5x at 512). A
// warp keeps 16 x 128 accumulators at every d, and a d of any length
// runs.

// acc (O, 16 rows x 128 columns) = acc * corr (by row) + P V over one
// key tile, 64 columns at a time. The tensor core's fp32 sums are not
// rounded to nearest: they lean toward zero, and in one accumulator over
// a whole key range (O += P V tile after tile) the lean grew with the
// range, to 3.3e-5 of max |O| at 2048 keys not causal (limit 2e-5).
// Each half's products therefore start from zero, and join O in one
// fmaf a value.
template <int BN>
__device__ __forceinline__ void add_pv(float (&acc)[4][4][4],
                                       const float (&corr)[2],
                                       const float (&p)[BN / 8][4],
                                       const float* sV, int nm) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (2 * half >= nm) break;
    float pv[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[m][j][e] = 0.f;
    cols_product<BN, 2, false>(pv, p, sV, 1.f, 2 * half, nm);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * half + m][j][e] =
              fmaf(acc[2 * half + m][j][e], corr[e >> 1], pv[m][j][e]);
        }
  }
}

template <int G>
struct FwdSmem {
  static constexpr int kRows = 128 / G;        // q rows a CTA owns
  static constexpr int kBN = 64;               // keys a tile
  static constexpr int kKeys = kBN / G;        // keys of a warp's S
  static constexpr int kT = kBN * kChunk;      // one K or V (chunk) tile
  static constexpr int kRing = G == 1 ? kRows * kChunk : 0;   // Qs stays
  static constexpr int kStage = 2 * kT;        // K, V; or Q and K chunks
  static constexpr int kExchange = kRing + 2 * kStage;
  static constexpr int kMax = kExchange + 8 * 16 * kKeys;     // after P
  static constexpr int kSum = kMax + 2 * kRows;
  static constexpr int kFloats = G == 1 ? kExchange : kSum + 2 * kRows;
  static constexpr int kBytes = kFloats * 4;
  static_assert(G == 1 || kRows * kChunk + kT <= kStage, "ring stage");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int d,
                      float qscale, int causal) {
  using L = FwdSmem<G>;
  constexpr int BN = L::kBN, NK = L::kKeys / 8;   // n-tiles of a warp's S
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nc = (d + kChunk - 1) / kChunk;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;  // heaviest first
  q += (size_t)bh * sq * d;
  o += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = G == 1 ? 0 : warp >> 2;
  const int w0 = (G == 1 ? warp : warp & 3) * 16;   // the warp's first row
  const int oc = G == 1 ? 0 : 2 * blockIdx.z + grp; // its output chunk
  const int key0 = grp * L::kKeys;                  // its keys of a tile
  const int row_lo = q0 + w0 + g;                   // its rows: +0, +8
  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + L::kRows, sq) - 1) / BN + 1);
  const int per_tile = G == 1 ? 1 : nc + 1;
  const int n_steps = n_kt * per_tile;
  float* const ring = smem + L::kRing;

  auto issue = [&](int s) {
    float* st = ring + (s & 1) * L::kStage;
    const int k0 = (s / per_tile) * BN, j = s % per_tile;
    if constexpr (G == 1) {
      fetch_tile<BN>(st, k, k0, sk, d, 0);
      fetch_tile<BN>(st + L::kT, v, k0, sk, d, 0);
    } else if (j < nc) {
      fetch_tile<L::kRows>(st, q, q0, sq, d, j * kChunk);
      fetch_tile<BN>(st + L::kRows * kChunk, k, k0, sk, d, j * kChunk);
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = (2 * blockIdx.z + c) * kChunk;
        if (col < d) fetch_tile<BN>(st + c * L::kT, v, k0, sk, d, col);
      }
    }
  };

  float acc[4][4][4];   // O: rows row_lo, row_lo + 8, chunk oc
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  float sa[NK][4];      // S, then P, of the warp's keys of the tile
  if (n_steps > 0) {
    if constexpr (G == 1) fetch_tile<L::kRows>(smem, q, q0, sq, d, 0);
    issue(0);
  }
  cp_commit();
  const int dc = min(kChunk, d - oc * kChunk), nm = (dc + 31) / 32;
  for (int s = 0; s < n_steps; ++s) {
    cp_wait_all();
    __syncthreads();   // step s landed; every thread is done with s - 1
    if (s + 1 < n_steps) issue(s + 1);
    cp_commit();
    const int k0 = (s / per_tile) * BN, j = s % per_tile;
    const float* st = ring + (s & 1) * L::kStage;
    const bool dead = causal && q0 + w0 + 15 < k0;  // no key of the tile
    if constexpr (G == 1) {
      if (dead) continue;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
      rows_product<BN, true, false>(sa, smem, w0, st, qscale, (d + 15) / 16);
    } else if (j < nc) {
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
      }
      // A chunk's products from zero, then one add; none where all the
      // warp's keys lie past its rows.
      if (!(causal && q0 + w0 + 15 < k0 + key0)) {
        float sc[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
        rows_product<L::kKeys, true, false>(
            sc, st, w0, st + (L::kRows + key0) * kChunk, qscale,
            (min(kChunk, d - j * kChunk) + 15) / 16);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[n][e] += sc[n][e];
      }
      continue;
    }
    // S is complete: mask, the rows' maxima (shared by the two groups
    // when G == 2), P, l and O rescaled.
    const bool edge = k0 + key0 + L::kKeys > sk ||
                      (causal && k0 + key0 + L::kKeys - 1 > q0 + w0);
    uint32_t ok = 0xffffffffu;
    float mt[2] = {kNegInf, kNegInf};
    if (!dead) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = k0 + key0 + 8 * n + 2 * t + (e & 1);
            const int row = row_lo + 8 * (e >> 1);
            if (!(key < sk && (!causal || row >= key))) {
              sa[n][e] = kNegInf;
              ok &= ~(1u << (4 * n + e));
            }
          }
          mt[e >> 1] = fmaxf(mt[e >> 1], sa[n][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      }
    }
    if constexpr (G == 2) {
      float* const sMax = smem + L::kMax;
      if (!dead && t == 0) {
        sMax[grp * L::kRows + w0 + g] = mt[0];
        sMax[grp * L::kRows + w0 + g + 8] = mt[1];
      }
      __syncthreads();   // both groups' maxima are in shared memory
      if (!dead) {
        mt[0] = fmaxf(mt[0], sMax[(grp ^ 1) * L::kRows + w0 + g]);
        mt[1] = fmaxf(mt[1], sMax[(grp ^ 1) * L::kRows + w0 + g + 8]);
      }
    }
    float* const sP = smem + L::kExchange + lane;
    float corr[2];
    if (!dead) {
      float nml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mx = fmaxf(mrow[h], mt[h]);
        corr[h] = exp2f((mrow[h] - mx) * kLog2e);
        nml[h] = -mx * kLog2e;
        mrow[h] = mx;
        lrow[h] *= corr[h];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok >> (4 * n + e)) & 1u
                              ? exp2f(fmaf(sa[n][e], kLog2e, nml[e >> 1]))
                              : 0.f;
          sa[n][e] = p;
          lrow[e >> 1] += p;
          if (G == 2) sP[(warp * NK * 4 + 4 * n + e) * 32] = p;
        }
    }
    if constexpr (G == 1) {
      add_pv<BN>(acc, corr, sa, st + L::kT, nm);
    } else {
      __syncthreads();   // both groups' P are in shared memory
      if (dead || oc >= nc) continue;
      const float* const sPo = sP + (warp ^ 4) * NK * 4 * 32;
      float pa[BN / 8][4];   // P of all the tile's keys
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = kk / NK == grp ? sa[kk % NK][e]
                                     : sPo[(4 * (kk % NK) + e) * 32];
        }
      add_pv<BN>(acc, corr, pa, st + grp * L::kT, nm);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
  if constexpr (G == 2) {   // each group summed P over its half of the keys
    float* const sSum = smem + L::kSum;
    if (t == 0) {
      sSum[grp * L::kRows + w0 + g] = lrow[0];
      sSum[grp * L::kRows + w0 + g + 8] = lrow[1];
    }
    __syncthreads();
    lrow[0] += sSum[(grp ^ 1) * L::kRows + w0 + g];
    lrow[1] += sSum[(grp ^ 1) * L::kRows + w0 + g + 8];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] = fmaxf(lrow[h], 1e-30f);
    inv[h] = 1.f / lrow[h];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][jj][e] *= inv[e >> 1];
  if (oc < nc) store_cols<4>(o + oc * kChunk, d, q0 + w0, sq, acc, 0, nm, dc, 1.f);
  if (t == 0 && oc == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < sq) lse[row] = mrow[h] + logf(lrow[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward: K2 (dK, dV) and K3 (dQ)
// ---------------------------------------------------------------------------
//
// One design for every head dim. A CTA of 8 warps owns 64 rows (keys in
// K2, queries in K3) and one 128-column chunk c = blockIdx.z of its
// output, and walks the tiles of BN rows of the other operand (BN = 64
// for d <= 128, else 32), one step a tile per 128-column d chunk: a step
// adds that chunk's columns to the two products over d, S = X1 Y1^T and
// dP = X2 Y2^T (K2: X = K, V and Y = Qs, dO, so S^T and dP^T; K3: X =
// Qs, dO and Y = K, V). The chunks are visited from c + 1 round to c, so
// the last step of a tile holds Y's chunk c, which the second products
// read. For d <= 128 (one chunk) X stays in shared memory for the whole
// walk; above, X's chunk rides in the ring with Y's, and each CTA
// recomputes S and dP over the whole d (1.5x the work at d = 256, 2.5-3x at
// 512: recompute was chosen over 16 x d accumulators a warp, which do
// not fit in registers above 128 columns).
//
// Warp roles. Warps 0-3 (group 0) compute S, warps 4-7 (group 1) dP, each
// for 16 owned rows (warp & 3), so each product over d is computed once.
// The two exchange their results through shared memory in fragment order
// (a thread's values at [warp & 3][value][lane]: no bank conflicts):
// K2: group 0 writes P^T and accumulates dV += P^T dO, group 1 reads P^T,
// forms dS^T and accumulates dK += dS^T Qs (16 x 128 accumulators a
// warp). K3: group 0 writes P, group 1 dP, each reads the other's and
// forms the same dS bit for bit; group g accumulates dQ += dS K over
// output columns 64g..64g+63.
//
constexpr int kOwn = 64;             // rows a backward CTA owns

// Shared memory of the backward kernels, in floats: X (when it stays),
// the two-stage ring ([X chunk when it rides] [Y1][Y2] [lse delta] for
// K2), and the exchange (K2: P^T; K3: P and dP).
template <bool DKV, int BN, bool RES>
struct BwdSmem {
  static constexpr int kX = kOwn * kChunk;
  static constexpr int kY = BN * kChunk;
  static constexpr int kStage = (RES ? 0 : 2 * kX) + 2 * kY + (DKV ? 2 * BN : 0);
  static constexpr int kRing = (RES ? 2 * kX : 0);
  static constexpr int kExchange = kRing + 2 * kStage;
  static constexpr int kFloats = kExchange + (DKV ? 1 : 2) * kOwn * BN;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int BN, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int sk, int d,
                      float qscale, int causal) {
  using L = BwdSmem<true, BN, RES>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nc = (d + kChunk - 1) / kChunk, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kOwn;   // heaviest first: low keys see most q
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  dk += (size_t)bh * sk * d + c * kChunk;
  dv += (size_t)bh * sk * d + c * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, grp = warp >> 2, w0 = (warp & 3) * 16;
  const int qt0 = causal ? k0 / BN : 0;
  const int n_steps = max(0, (sq + BN - 1) / BN - qt0) * nc;
  float* const ring = smem + L::kRing;
  float* const sP = smem + L::kExchange + (warp & 3) * (BN / 2) * 32 + lane;

  auto issue = [&](int s) {
    float* st = ring + (s & 1) * L::kStage;
    const int col = ((c + 1 + s % nc) % nc) * kChunk;
    const int q0 = (qt0 + s / nc) * BN;
    if constexpr (!RES) {
      fetch_tile<kOwn>(st, k, k0, sk, d, col);
      fetch_tile<kOwn>(st + L::kX, v, k0, sk, d, col);
      st += 2 * L::kX;
    }
    fetch_tile<BN>(st, q, q0, sq, d, col);
    fetch_tile<BN>(st + L::kY, dout, q0, sq, d, col);
    fetch_stats<BN>(st + 2 * L::kY, lse, delta, q0, sq);
  };

  float acc[4][4][4];   // dV (group 0) or dK (group 1), chunk c
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  float sa[BN / 8][4];  // S^T (group 0) or dP^T (group 1), then P^T, dS^T
  if (n_steps > 0) {
    if constexpr (RES) {
      fetch_tile<kOwn>(smem, k, k0, sk, d, 0);
      fetch_tile<kOwn>(smem + L::kX, v, k0, sk, d, 0);
    }
    issue(0);
  }
  cp_commit();
  const int dc = min(kChunk, d - c * kChunk), nm = (dc + 31) / 32;
  for (int s = 0; s < n_steps; ++s) {
    cp_wait_all();
    __syncthreads();   // step s landed; every thread is done with s - 1
    if (s + 1 < n_steps) issue(s + 1);
    cp_commit();
    const int j = s % nc, col = ((c + 1 + j) % nc) * kChunk;
    const float* st = ring + (s & 1) * L::kStage;
    const float* sX = RES ? smem : st;
    const float* sY = st + (RES ? 0 : 2 * L::kX);
    if (j == 0) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
    }
    const int nb = (min(kChunk, d - col) + 15) / 16;
    if (grp == 0) {   // S^T = K Qs^T
      rows_product<BN, false, true>(sa, sX, w0, sY, qscale, nb);
    } else {          // dP^T = V dO^T
      rows_product<BN, false, false>(sa, sX + L::kX, w0, sY + L::kY, 1.f, nb);
    }
    if (j != nc - 1) continue;
    const int q0 = (qt0 + s / nc) * BN;
    const float* sL = sY + 2 * L::kY;   // lse [BN], delta [BN]
    if (grp == 0) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cq = 8 * n + 2 * t + (e & 1), qi = q0 + cq;
          const int key = k0 + w0 + g + 8 * (e >> 1);
          const bool ok = qi < sq && key < sk && (!causal || qi >= key);
          const float p =
              ok ? exp2f(fmaf(sa[n][e], kLog2e, -sL[cq] * kLog2e)) : 0.f;
          sa[n][e] = p;   // P^T
          sP[(4 * n + e) * 32] = p;
        }
    }
    __syncthreads();   // P^T is in shared memory
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cq = 8 * n + 2 * t + (e & 1);
          sa[n][e] = sP[(4 * n + e) * 32] * (sa[n][e] - sL[BN + cq]);  // dS^T
        }
    }
    if (grp == 0) {   // dV += P^T dO (chunk c)
      cols_product<BN, 4, false>(acc, sa, sY + L::kY, 1.f, 0, nm);
    } else {          // dK += dS^T Qs
      cols_product<BN, 4, true>(acc, sa, sY, qscale, 0, nm);
    }
  }
  store_cols<4>(grp ? dk : dv, d, k0 + w0, sk, acc, 0, nm, dc, 1.f);
}

template <int BN, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int sq, int sk, int d, float qscale, float scale,
                     int causal) {
  using L = BwdSmem<false, BN, RES>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nc = (d + kChunk - 1) / kChunk, c = blockIdx.z;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;  // heaviest first
  q += (size_t)bh * sq * d;
  dout += (size_t)bh * sq * d;
  dq += (size_t)bh * sq * d + c * kChunk;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  k += (size_t)bh * sk * d;
  v += (size_t)bh * sk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, grp = warp >> 2, w0 = (warp & 3) * 16;
  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + kOwn, sq) - 1) / BN + 1);
  const int n_steps = n_kt * nc;
  const int r_lo = q0 + w0 + g, r_hi = r_lo + 8;
  const float lse2[2] = {(r_lo < sq ? lse[r_lo] : 0.f) * kLog2e,
                         (r_hi < sq ? lse[r_hi] : 0.f) * kLog2e};
  const float del_r[2] = {r_lo < sq ? delta[r_lo] : 0.f,
                          r_hi < sq ? delta[r_hi] : 0.f};
  float* const ring = smem + L::kRing;
  const int slot = (warp & 3) * (BN / 2) * 32 + lane;
  float* const sP = smem + L::kExchange + slot;
  float* const sDP = sP + kOwn * BN;

  auto issue = [&](int s) {
    float* st = ring + (s & 1) * L::kStage;
    const int col = ((c + 1 + s % nc) % nc) * kChunk;
    const int k0 = (s / nc) * BN;
    if constexpr (!RES) {
      fetch_tile<kOwn>(st, q, q0, sq, d, col);
      fetch_tile<kOwn>(st + L::kX, dout, q0, sq, d, col);
      st += 2 * L::kX;
    }
    fetch_tile<BN>(st, k, k0, sk, d, col);
    fetch_tile<BN>(st + L::kY, v, k0, sk, d, col);
  };

  float acc[2][4][4];   // dQ, columns 64 grp .. 64 grp + 63 of chunk c
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  float sa[BN / 8][4];  // S (group 0) or dP (group 1), then dS
  if (n_steps > 0) {
    if constexpr (RES) {
      fetch_tile<kOwn>(smem, q, q0, sq, d, 0);
      fetch_tile<kOwn>(smem + L::kX, dout, q0, sq, d, 0);
    }
    issue(0);
  }
  cp_commit();
  const int dc = min(kChunk, d - c * kChunk), nm = (dc + 31) / 32;
  for (int s = 0; s < n_steps; ++s) {
    cp_wait_all();
    __syncthreads();   // step s landed; every thread is done with s - 1
    if (s + 1 < n_steps) issue(s + 1);
    cp_commit();
    const int j = s % nc, col = ((c + 1 + j) % nc) * kChunk;
    const float* st = ring + (s & 1) * L::kStage;
    const float* sX = RES ? smem : st;
    const float* sY = st + (RES ? 0 : 2 * L::kX);
    if (j == 0) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = 0.f;
    }
    const int nb = (min(kChunk, d - col) + 15) / 16;
    if (grp == 0) {   // S = Qs K^T
      rows_product<BN, true, false>(sa, sX, w0, sY, qscale, nb);
    } else {          // dP = dO V^T
      rows_product<BN, false, false>(sa, sX + L::kX, w0, sY + L::kY, 1.f, nb);
    }
    if (j != nc - 1) continue;
    const int k0 = (s / nc) * BN;
    if (grp == 0) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = e >> 1 ? r_hi : r_lo;
          const bool ok = row < sq && key < sk && (!causal || row >= key);
          const float p =
              ok ? exp2f(fmaf(sa[n][e], kLog2e, -lse2[e >> 1])) : 0.f;
          sa[n][e] = p;
          sP[(4 * n + e) * 32] = p;
        }
    } else {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sDP[(4 * n + e) * 32] = sa[n][e];
    }
    __syncthreads();   // P and dP are in shared memory
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = grp ? sP[(4 * n + e) * 32] : sa[n][e];
        const float dp = grp ? sa[n][e] : sDP[(4 * n + e) * 32];
        sa[n][e] = p * (dp - del_r[e >> 1]);   // dS, the same in both groups
      }
    cols_product<BN, 2, false>(acc, sa, sY, 1.f, 2 * grp, nm);  // dQ += dS K
  }
  store_cols<2>(dq, d, q0 + w0, sq, acc, 2 * grp, nm, dc, scale);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Plain C entry points with the arguments of the 16-bit forms' (d is the
// head dim), bound with ctypes; each returns a cudaError_t.
extern "C" {

int hvd_flash_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int sq, int sk, int d, float qscale,
                       int causal, void* stream) {
  if (d < 4 || d % 4 || (d > 256 && d % kChunk)) return cudaErrorInvalidValue;
  auto run = [&](auto kernel, int smem, int rows, int nz) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (sq + rows - 1) / rows, nz);
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  };
  if (d <= kChunk) {
    return run(flash_fwd_fp32_kernel<1>, FwdSmem<1>::kBytes, FwdSmem<1>::kRows, 1);
  }
  const int nc = (d + kChunk - 1) / kChunk;
  return run(flash_fwd_fp32_kernel<2>, FwdSmem<2>::kBytes, FwdSmem<2>::kRows,
             (nc + 1) / 2);
}

int hvd_flash_dkv_fp32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       float qscale, int causal, void* stream) {
  if (d < 4 || d % 4 || (d > 256 && d % kChunk)) return cudaErrorInvalidValue;
  const dim3 grid(bh, (sk + kOwn - 1) / kOwn, (d + kChunk - 1) / kChunk);
  auto run = [&](auto kernel, int smem) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, sq, sk, d, qscale, causal);
    return cudaGetLastError();
  };
  if (d <= kChunk) {
    return run(flash_dkv_fp32_kernel<64, true>, BwdSmem<true, 64, true>::kBytes);
  }
  return run(flash_dkv_fp32_kernel<32, false>, BwdSmem<true, 32, false>::kBytes);
}

int hvd_flash_dq_fp32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, int d, float qscale,
                      float scale, int causal, void* stream) {
  if (d < 4 || d % 4 || (d > 256 && d % kChunk)) return cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + kOwn - 1) / kOwn, (d + kChunk - 1) / kChunk);
  auto run = [&](auto kernel, int smem) {
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, sq, sk, d, qscale, scale, causal);
    return cudaGetLastError();
  };
  if (d <= kChunk) {
    return run(flash_dq_fp32_kernel<64, true>, BwdSmem<false, 64, true>::kBytes);
  }
  return run(flash_dq_fp32_kernel<32, false>, BwdSmem<false, 32, false>::kBytes);
}

}  // extern "C"
