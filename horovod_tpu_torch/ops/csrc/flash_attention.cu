// The bf16 forms of K1-K3 with bf16 outputs: flash_fwd_kernel,
// flash_dkv_kernel and flash_dq_kernel, entry points hvd_flash_fwd,
// hvd_flash_dkv and hvd_flash_dq. The bodies, and what each kernel
// replaces, are in flash_attention.cuh.

#include "flash_attention.cuh"

namespace {
HVD_FLASH_KERNELS(, bf16, bf16)
}  // namespace

HVD_FLASH_ENTRIES(, FlashKernels, bf16, bf16)
