// The bf16 forms of K1-K3 with fp32 outputs (ring attention's blocks):
// flash_{fwd,dkv,dq}_f32_kernel, entry points hvd_flash_{fwd,dkv,dq}_f32.
// The bodies are in flash_attention.cuh.

#include "flash_attention.cuh"

namespace {
HVD_FLASH_KERNELS(_f32, bf16, float)
}  // namespace

HVD_FLASH_ENTRIES(_f32, FlashKernels_f32, bf16, float)
