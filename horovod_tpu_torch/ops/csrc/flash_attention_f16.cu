// The fp16 forms of K1-K3 with fp16 outputs: flash_{fwd,dkv,dq}_f16_kernel,
// entry points hvd_flash_{fwd,dkv,dq}_f16. The bf16 bodies of
// flash_attention.cuh on wgmma's f16 type, with JAX's casts in fp16: the
// scale rounded to fp16 and q * scale in fp16, P and dS rounded to fp16
// before their products, fp32 accumulation.

#include "flash_attention.cuh"

namespace {
HVD_FLASH_KERNELS(_f16, half, half)
}  // namespace

HVD_FLASH_ENTRIES(_f16, FlashKernels_f16, half, half)
