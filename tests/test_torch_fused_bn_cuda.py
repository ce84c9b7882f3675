"""The CUDA batch-norm kernels against their plain PyTorch versions on the
card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a card they skip.
On a machine with one (the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_fused_bn_cuda.py

Tolerances: y, dx and dr within 1e-2 * max |plain| (bf16 outputs); the
sums s1 and s2 within 1e-4 of the sum of their terms' magnitudes (fp32
sums in another order). Repeated reductions must agree bit for bit.
"""

import pytest
import torch

from horovod_tpu_torch.ops import fused_bn as fbn

pytestmark = pytest.mark.cuda

SHAPES = [  # (M, C)
    (802816, 256), (3211264, 64), (12544, 2048),
    (256, 256), (256, 64), (392, 128), (30, 96), (512, 384),
    (37, 5), (1, 8),
]
VARIANTS = [(True, True), (True, False), (False, False), (False, True)]


@pytest.fixture
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from horovod_tpu_torch.ops import _build
    _build.library()


def _inputs(m, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mat():
        return torch.randn(m, c, generator=g, device="cuda").bfloat16()

    def vec(lo, hi):
        return lo + (hi - lo) * torch.rand(c, generator=g, device="cuda")

    x, da, r = mat(), mat(), mat()
    mean = x.float().mean(0)
    rstd = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
    scale = vec(0.5, 1.5) * rstd
    shift = vec(-0.1, 0.1) - mean * scale
    return x, da, r, mean, rstd, scale, shift


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _sum_err(got, want, mag):
    return float(((got - want).abs() / mag.clamp_min(1e-30)).max())


@pytest.mark.parametrize("relu,residual", VARIANTS)
@pytest.mark.parametrize("m,c", SHAPES)
def test_kernels_match_plain(cuda_kernels, m, c, relu, residual):
    x, da, r, mean, rstd, scale, shift = _inputs(m, c, seed=m + c)
    r = r if residual else None
    xf = x.float()

    s1, s2 = fbn.stats_cuda(x)
    p1, p2 = fbn.stats_reference(x)
    assert _sum_err(s1, p1, xf.abs().sum(0)) <= 1e-4
    assert _sum_err(s2, p2, (xf * xf).sum(0)) <= 1e-4

    y = fbn.norm_cuda(x, r, scale, shift, relu)
    assert _rel(y, fbn.norm_reference(x, r, scale, shift, relu)) <= 1e-2

    g1, g2 = fbn.bwd_reduce_cuda(x, da, r, mean, rstd, scale, shift, relu)
    q1, q2 = fbn.bwd_reduce_reference(x, da, r, mean, rstd, scale, shift,
                                      relu)
    dy = fbn._masked_grad(xf, da, r, scale, shift, relu)
    assert _sum_err(g1, q1, dy.abs().sum(0)) <= 1e-4
    assert _sum_err(g2, q2, (dy * (xf - mean) * rstd).abs().sum(0)) <= 1e-4

    dx, dr = fbn.bwd_dx_cuda(x, da, r, mean, rstd, scale, shift, q1, q2,
                             1.0 / m, relu)
    want_dx, want_dr = fbn.bwd_dx_reference(x, da, r, mean, rstd, scale,
                                            shift, q1, q2, 1.0 / m, relu)
    assert _rel(dx, want_dx) <= 1e-2
    if residual:
        assert _rel(dr, want_dr) <= 1e-2
    else:
        assert dr is None
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,c", [(802816, 256), (12544, 2048), (37, 5)])
def test_reductions_repeat_bit_for_bit(cuda_kernels, m, c):
    x, da, r, mean, rstd, scale, shift = _inputs(m, c, seed=3)
    a = fbn.stats_cuda(x)
    b = fbn.stats_cuda(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a = fbn.bwd_reduce_cuda(x, da, r, mean, rstd, scale, shift, True)
    b = fbn.bwd_reduce_cuda(x, da, r, mean, rstd, scale, shift, True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_autograd_counts_launches(cuda_kernels):
    x, da, r, *_ = _inputs(4 * 8 * 8, 64, seed=5)
    x = x.view(4, 8, 8, 64).requires_grad_()
    r = r.view(4, 8, 8, 64).requires_grad_()
    gamma = torch.ones(64, device="cuda", requires_grad=True)
    beta = torch.zeros(64, device="cuda", requires_grad=True)
    fbn.reset_launch_counts()
    y, mean, var = fbn.bn_act(x, gamma, beta, residual=r, impl="pallas")
    y.backward(da.view(4, 8, 8, 64))
    assert fbn.launch_counts() == {"bn_stats": 1, "bn_norm": 1,
                                   "bn_bwd_reduce": 1, "bn_bwd_dx": 1}
    for t in (x.grad, r.grad, gamma.grad, beta.grad):
        assert torch.isfinite(t.float()).all()
    fbn.reset_launch_counts()
    fbn.bn_act(x.detach(), gamma, beta, impl="jnp")
    assert sum(fbn.launch_counts().values()) == 0


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_kernels):
    x = torch.zeros(64, 32, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(32, device="cuda")
    with pytest.raises(TypeError):
        fbn.stats_cuda(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        fbn.stats_cuda(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        fbn.norm_cuda(x, x[:32], v, v, True)
    with pytest.raises(ValueError, match="per-channel"):
        fbn.norm_cuda(x, None, v[:16], v, True)
    with pytest.raises(ValueError, match="per-channel"):
        fbn.bwd_dx_cuda(x, x, None, v, v, v, v, v, v.double(), 1 / 64, True)
    with pytest.raises(ValueError, match="contiguous over"):
        fbn.bn_act(x.t(), v, v, impl="pallas")
