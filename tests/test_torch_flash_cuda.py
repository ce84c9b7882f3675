"""The CUDA flash kernels against their plain PyTorch versions on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a card they skip.
On a machine with one (the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerance: max |kernel - plain| <= 2e-2 * max |plain| on O, dQ, dK, dV
(bf16 outputs, fp32 sums in another order), 1e-3 absolute on lse.
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [  # (bh, seq, head_dim, causal)
    (4, 256, 128, True),
    (3, 200, 128, True),
    (2, 130, 64, False),
    (2, 64, 64, True),
]


@pytest.fixture
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from horovod_tpu_torch.ops import _build
    _build.library()


def _inputs(bh, s, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


@pytest.mark.parametrize("bh,s,d,causal", SHAPES)
def test_kernels_match_plain(cuda_kernels, bh, s, d, causal):
    q, k, v, do = _inputs(bh, s, d, seed=s + d)
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, scale, causal)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale, causal)
    dq = fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal)
    torch.cuda.synchronize()
    assert _rel(o, o_ref) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(got, ref) <= 2e-2


def test_autograd_counts_launches(cuda_kernels):
    q, k, v, do = (x.view(1, 2, 256, 128).transpose(1, 2).requires_grad_()
                   for x in _inputs(2, 256, 128, seed=9))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, True)
    out.backward(do.detach())
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dkv": 1,
                                  "flash_dq": 1}
    assert out.shape == q.shape and torch.isfinite(q.grad.float()).all()


def test_wrappers_reject_what_the_kernel_does_not_take(cuda_kernels):
    q = torch.zeros(2, 64, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q, q, q, 0.1, True)
    q = torch.zeros(2, 64, 64, dtype=torch.float32, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q, q, q, 0.1, True)
