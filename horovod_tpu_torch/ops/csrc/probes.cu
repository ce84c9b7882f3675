// Streaming probes for Hopper (sm_90a): what a plain copy, a +1 map and a
// stats-style column reduce reach on the card, at the shapes of the
// batch-norm kernels (fused_bn.cu), whose practical ceiling they measure.
//
// Layout: x, y are [M, C] bf16, row-major, C a multiple of 8 and the
// pointers 16-byte aligned; M a multiple of the row tile bm. A (bm, C)
// row tile is the unit of work, as a step of the probes' Pallas grids.
//
// probe_map_kernel<false> replaces
//   experiments/pallas_shape_probe.py::make_copy (kernel copy_kernel) and
//   experiments/pallas_mem_probe.py::copy_kernel via make_pallas_map;
// probe_map_kernel<true>  replaces pallas_mem_probe.py::addone_kernel:
//   y = x, or y = bf16(x + 1) (added in fp32, rounded once). Bound:
//   2*M*C*2 bytes (read x, write y); at [802816, 256], 822 MB, 245 us at
//   3.35 TB/s. A (bm, C) tile of a row-major matrix is one contiguous
//   range of bm*C*2 bytes (a multiple of 16), so it moves by 1-D TMA bulk
//   copies and needs no tensor map. The grid is persistent:
//   min(tiles, k * SMs) CTAs, k <= kMaxCtasPerSm as shared memory allows
//   (one with this ring); CTA b streams tiles b, b + grid, b + 2*grid, ...
//   whole and in order, each cut into kStageBytes stages (the last one
//   short), through a ring of kStages shared-memory slots that runs
//   across tile boundaries: a slot is filled by cp.async.bulk global ->
//   shared (completing its mbarrier) and drained by cp.async.bulk shared
//   -> global (a bulk group); it is refilled once the store kStoreLag
//   groups back has read it, so the next tile's loads are in flight while
//   this tile's stores drain. The ring's depth (192 KB), not the tile
//   count, sets the bytes in flight per SM. Loads and stores carry an L2
//   evict_first policy: 822 MB cross the 50 MB L2 once. For the copy one
//   thread issues everything and no thread touches the data; for +1 the
//   CTA's threads map each stage in shared memory (16-byte words), then
//   fence the async proxy and meet at a barrier before thread 0 stores
//   it. What binds besides the bytes is the tile geometry, which the
//   probe measures: one stream of whole tiles per SM reads and writes
//   132 places at once, where a copy cut into small pieces dispatched in
//   address order keeps them close (experiments/probe_split.py); few
//   large tiles leave SMs idle (98 tiles of 4 MB on 132 SMs), and 196
//   tiles run a second round on 64 SMs.
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

#include "hopper_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// The map's ring (ops/probes.py mirrors these four and the schedule).
constexpr int kStageBytes = 16384;  // one ring slot; a multiple of 16
constexpr int kStages = 12;         // slots: 192 KB, one CTA an SM
constexpr int kStoreLag = 1;        // bulk stores left reading at a refill
constexpr int kMaxCtasPerSm = 2;
constexpr int kRingBytes = kStages * kStageBytes + kStages * 8;
constexpr int kCopyThreads = 32;    // one warp; thread 0 issues the copies
constexpr int kAddThreads = 256;
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

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// The stages of one CTA's tiles in order: tile b, b + grid, ..., each cut
// into kStageBytes pieces from its first byte, the last piece short.
struct StageWalk {
  int64_t tile, off, tile_bytes, stride;
  __device__ int64_t at() const { return tile * tile_bytes + off; }
  __device__ uint32_t len() const {
    const int64_t left = tile_bytes - off;
    return (uint32_t)(left < kStageBytes ? left : kStageBytes);
  }
  __device__ void next() {
    off += kStageBytes;
    if (off >= tile_bytes) {
      off = 0;
      tile += stride;
    }
  }
};

// Fill a slot with the stage s points at: its bytes complete bar's phase.
__device__ __forceinline__ void load_stage(uint32_t slot, uint32_t bar,
                                           const char* x, const StageWalk& s,
                                           uint64_t policy) {
  mbar_expect_tx(bar, s.len());
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(slot),
      "l"(x + s.at()), "r"(s.len()), "r"(bar), "l"(policy)
      : "memory");
}

// Drain a slot to the stage s points at, as one bulk group.
__device__ __forceinline__ void store_stage(char* y, uint32_t slot,
                                            const StageWalk& s,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(y + s.at()), "r"(slot), "r"(s.len()),
      "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Stream this CTA's tiles of x through the ring into y (ADDONE: +1 on
// the way). tiles * tile_bytes is the matrix; the ring is dynamic shared
// memory of kRingBytes: the slots, then one mbarrier per slot.
template <bool ADDONE>
__global__ void __launch_bounds__(ADDONE ? kAddThreads : kCopyThreads)
probe_map_kernel(const char* __restrict__ x, char* __restrict__ y,
                 int64_t tiles, int64_t tile_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  const uint32_t slots = smem_u32(ring);
  const uint32_t bars = slots + kStages * kStageBytes;
  const int tid = threadIdx.x;
  const int64_t per_tile = (tile_bytes + kStageBytes - 1) / kStageBytes;
  const int64_t n =
      per_tile * ((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  StageWalk ld{blockIdx.x, 0, tile_bytes, gridDim.x};
  StageWalk st = ld;
  uint64_t policy = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
    policy = evict_first_policy();
    for (int64_t j = 0; j < n && j < kStages - kStoreLag; ++j, ld.next()) {
      load_stage(slots + j * kStageBytes, bars + 8 * j, x, ld, policy);
    }
  }
  if (ADDONE) __syncthreads();
  for (int64_t i = 0; i < n; ++i, st.next()) {
    const int slot = (int)(i % kStages);
    const uint32_t buf = slots + slot * kStageBytes;
    if (ADDONE || tid == 0) mbar_wait(bars + 8 * slot, (i / kStages) & 1);
    if (ADDONE) {
      uint4* w = reinterpret_cast<uint4*>(ring + slot * kStageBytes);
      for (int v = tid; v < (int)(st.len() / 16); v += kAddThreads) {
        w[v] = add_one(w[v]);
      }
      fence_proxy_async();
      __syncthreads();
    }
    if (tid == 0) {
      store_stage(y, buf, st, policy);
      // ld is at stage i + kStages - kStoreLag, whose slot the store of
      // stage i - kStoreLag read last.
      if (i + kStages - kStoreLag < n) {
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStoreLag)
                     : "memory");
        const int refill = (int)((i + kStages - kStoreLag) % kStages);
        load_stage(slots + refill * kStageBytes, bars + 8 * refill, x, ld,
                   policy);
        ld.next();
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The map's grid on the current device: min(tiles, k * SMs), k the CTAs
// of a form an SM holds with its ring, at most kMaxCtasPerSm. The shared
// memory opt-in and the queries run once per device and form.
cudaError_t map_grid(bool addone, int64_t tiles, int* grid) {
  static int per_device[64][2][2];   // {SMs, k}, 0 until queried
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int* q = per_device[dev][addone];
  if (q[1] == 0) {
    const void* fn = addone ? (const void*)probe_map_kernel<true>
                            : (const void*)probe_map_kernel<false>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&q[0], cudaDevAttrMultiProcessorCount, dev);
    }
    int k = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &k, fn, addone ? kAddThreads : kCopyThreads, kRingBytes);
    }
    if (err != cudaSuccess) return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    q[1] = k < kMaxCtasPerSm ? k : kMaxCtasPerSm;
  }
  const int64_t most = (int64_t)q[0] * q[1];
  *grid = (int)(tiles < most ? tiles : most);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// y = x (addone = 0) or y = bf16(x + 1) (addone = 1) over [m, c], bm-row
// tiles streamed whole by min(tiles, k * SMs) persistent CTAs. Returns a
// cudaError_t (0 on success).
int hvd_probe_map(const void* x, void* y, int m, int c, int bm, int addone,
                  void* stream) {
  if (bad_args(m, c, bm)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = m / bm, tile_bytes = (int64_t)bm * c * 2;
  int grid = 0;
  cudaError_t err = map_grid(addone != 0, tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  if (addone) {
    probe_map_kernel<true><<<grid, kAddThreads, kRingBytes, s>>>(
        (const char*)x, (char*)y, tiles, tile_bytes);
  } else {
    probe_map_kernel<false><<<grid, kCopyThreads, kRingBytes, s>>>(
        (const char*)x, (char*)y, tiles, tile_bytes);
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
