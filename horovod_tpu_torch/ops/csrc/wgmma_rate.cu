// The rate of each wgmma form of hopper_tile.cuh alone, for
// experiments/flash_fwd_split.py. It replaces no TPU kernel and runs on no
// train path: it measures what K1's and K2's products could reach.
//
// One CTA of two warpgroups (256 threads), meant to be launched once per
// SM. Each warpgroup loops over a 64-deep product from fixed tiles in
// shared memory (the operands never change, so only the tensor cores and
// the fences are timed), waiting after each batch as K1 does:
//   mode 0: RS m64n128k16, B MN-major (K1's O += P V), 4 k-steps;
//   mode 1: RS m64n128k16, B K-major, 4 k-steps;
//   mode 2: SS m64n64k16, B K-major (K1's S = Qs K^T at D=128), 8 k-steps;
//   mode 3: SS m64n128k16, B K-major, 4 k-steps.
// Every mode does 2 * 64 * 128 * 64 flops per warpgroup and iteration.
// The result (a sum of accumulator elements) is written to out only so
// that the products are not optimised away.

#include "hopper_tile.cuh"

namespace {

constexpr int kRateThreads = 256;
constexpr int kRateSmem = 2 * 128 * 128 * 2 + 1024;   // two tiles + align

template <int MODE>
__global__ void __launch_bounds__(kRateThreads)
    wgmma_rate_kernel(float* out, int iters) {
  extern __shared__ __align__(16) unsigned char raw[];
  const uint32_t r = smem_u32(raw);
  unsigned char* sm = raw + (((r + 1023) & ~1023u) - r);
  const uint32_t sA = smem_u32(sm), sB = sA + 128 * 128 * 2;
  for (int i = threadIdx.x; i < 128 * 128 / 4; i += kRateThreads)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0x3c003c00u, 0, 0x3c00u, 0);
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  float acc[16][4] = {};
  float s[8][4] = {};
  uint32_t pa[4][4];
  for (int c = 0; c < 4; ++c)
    for (int e = 0; e < 4; ++e) pa[c][e] = 0x3c003c00u + c + e;
  for (int it = 0; it < iters; ++it) {
    fence_acc(acc);
    fence_acc(s);
    fence_frag(pa);
    wgmma_fence();
    if (MODE == 0) {
      for (int c = 0; c < 4; ++c)
        wgmma_rs_n128<1>(acc, pa[c], desc_mnmajor<64>(sB, c), 1);
    } else if (MODE == 1) {
      for (int c = 0; c < 4; ++c)
        wgmma_rs_n128<0>(acc, pa[c], desc_kmajor<128>(sB, 0, c), 1);
    } else if (MODE == 2) {
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_n64<0>(s, desc_kmajor<128>(sA, wg * 64, kk),
                        desc_kmajor<64>(sB, 0, kk), 1);
    } else {
      for (int c = 0; c < 4; ++c)
        wgmma_ss_n128<0>(acc, desc_kmajor<128>(sA, wg * 64, c),
                         desc_kmajor<128>(sB, 0, c), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(s);
    fence_frag(pa);
  }
  float t = 0.f;
  for (int i = 0; i < 16; ++i) t += acc[i][0];
  for (int i = 0; i < 8; ++i) t += s[i][0];
  out[blockIdx.x * kRateThreads + threadIdx.x] = t;
}

}  // namespace

extern "C" {

// mode 0-3 as above; out holds blocks * 256 floats. Returns a cudaError_t
// (0 on success).
int hvd_wgmma_rate(int mode, void* out, int iters, int blocks,
                   void* stream) {
  if (mode < 0 || mode > 3 || iters < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  void (*k)(float*, int) = mode == 0   ? wgmma_rate_kernel<0>
                           : mode == 1 ? wgmma_rate_kernel<1>
                           : mode == 2 ? wgmma_rate_kernel<2>
                                       : wgmma_rate_kernel<3>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kRateSmem);
  if (err != cudaSuccess) return (int)err;
  k<<<blocks, kRateThreads, kRateSmem, (cudaStream_t)stream>>>(
      (float*)out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
