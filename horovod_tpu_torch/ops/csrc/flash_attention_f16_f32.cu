// The fp16 forms of K1-K3 with fp32 outputs (ring attention asks for fp32
// blocks whatever the operands' dtype): flash_{fwd,dkv,dq}_f16_f32_kernel,
// entry points hvd_flash_{fwd,dkv,dq}_f16_f32. The bodies are in
// flash_attention.cuh.

#include "flash_attention.cuh"

namespace {
HVD_FLASH_KERNELS(_f16_f32, half, float)
}  // namespace

HVD_FLASH_ENTRIES(_f16_f32, FlashKernels_f16_f32, half, float)
