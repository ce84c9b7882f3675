"""The CUDA flash kernels against their plain PyTorch versions on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a card they skip.
On a machine with one (the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerance: max |kernel - plain| <= 2e-2 * max |plain| on O, dQ, dK, dV
(bf16 outputs, fp32 sums in another order), 1e-3 absolute on lse. The
shapes cover the tilings' edges: a 128-row q tile with its diagonal
across two 64-key tiles (S=384), one row past a tile (S=129), the
second 64-row warpgroup of a q tile partly past the sequence (S=100)
and, in the last q tile, wholly past it (S=192), ragged tails causal
and not, and both head dims. Repeats are bit-identical (no
atomics), and operands that are views into larger NaN-filled buffers
give what clean copies give (nothing past the sequence is read).

The fp32-output forms (``out_dtype=torch.float32``, what ring attention
launches) are held to their plain fp32 versions at the same shapes and
tolerance, write fp32, repeat bit for bit, count apart from the bf16
forms, and round to exactly the bf16 forms' outputs.
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
    (2, 384, 128, True),
    (1, 129, 128, True),
    (2, 1000, 128, True),
    (3, 200, 64, True),
    (2, 300, 128, False),
    (2, 100, 128, True),
    (2, 192, 128, False),
    (3, 200, 96, True),
    (2, 130, 96, False),
    (2, 300, 80, True),
    (2, 130, 32, True),
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


def _all_kernels(q, k, v, do, lse, delta, causal):
    scale = q.shape[-1] ** -0.5
    o, lse_k = fa.flash_fwd_cuda(q, k, v, scale, causal)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, causal)
    dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, causal)
    return o, lse_k, dk, dv, dq


def _stats(q, k, v, do, causal):
    o, lse = fa.flash_fwd_reference(q, k, v, q.shape[-1] ** -0.5, causal)
    return lse, (do.float() * o.float()).sum(-1, keepdim=True)


@pytest.mark.parametrize("d", [64, 128])
def test_repeats_are_bit_identical(cuda_kernels, d):
    q, k, v, do = _inputs(3, 333, d, seed=5 + d)
    lse, delta = _stats(q, k, v, do, True)
    first = _all_kernels(q, k, v, do, lse, delta, True)
    again = _all_kernels(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,d,causal", [(129, 128, True), (200, 64, False),
                                        (64, 128, True), (1, 64, True)])
def test_nothing_past_the_sequence_is_read(cuda_kernels, s, d, causal):
    """bh = 1 operands that are views buf[:s] of buffers whose rows past
    s are NaN give the results of clean copies, bit for bit."""
    pad = 192
    clean = [x.view(s, d) for x in _inputs(1, s, d, seed=s + d + 7)]
    lse, delta = (x.view(s, 1) for x in _stats(*(x[None] for x in clean),
                                                causal))
    views = []
    for x in clean + [lse, delta]:
        buf = torch.full((s + pad, x.shape[1]), float("nan"), dtype=x.dtype,
                         device="cuda")
        buf[:s] = x
        views.append(buf[:s][None])
    got = _all_kernels(*views, causal)
    want = _all_kernels(*(x[None] for x in clean + [lse, delta]), causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_autograd_counts_launches(cuda_kernels):
    q, k, v, do = (x.view(1, 2, 256, 128).transpose(1, 2).requires_grad_()
                   for x in _inputs(2, 256, 128, seed=9))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, True)
    out.backward(do.detach())
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dkv": 1,
                                  "flash_dq": 1, "flash_fwd_f32": 0,
                                  "flash_dkv_f32": 0, "flash_dq_f32": 0}
    assert out.shape == q.shape and torch.isfinite(q.grad.float()).all()


def test_wrappers_reject_what_the_kernel_does_not_take(cuda_kernels):
    q = torch.zeros(2, 64, 72, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(q, q, q, 0.1, True)
    q = torch.zeros(2, 64, 64, dtype=torch.float32, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q, q, q, 0.1, True)


@pytest.mark.parametrize("bh,s,d,causal", SHAPES)
def test_fp32_forms_match_plain(cuda_kernels, bh, s, d, causal):
    q, k, v, do = _inputs(bh, s, d, seed=s + d + 11)
    scale = d ** -0.5
    f32 = torch.float32
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal, f32)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, out_dtype=f32)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, scale, causal,
                                  f32)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale, causal,
                               out_dtype=f32)
    dq = fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal,
                          out_dtype=f32)
    torch.cuda.synchronize()
    assert all(t.dtype == f32 for t in (o, dq, dk, dv, *want, o_ref))
    assert _rel(o, o_ref) <= 2e-2
    assert float((lse - lse_ref).abs().max()) <= 1e-3
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("d", [96, 128])
def test_fp32_forms_round_to_the_bf16_forms(cuda_kernels, d):
    """The two epilogues differ only in the store: the fp32 values,
    rounded to bf16, are the bf16 form's bits; the forms count apart."""
    q, k, v, do = _inputs(3, 333, d, seed=17 + d)
    lse, delta = _stats(q, k, v, do, True)
    scale = d ** -0.5
    fa.reset_launch_counts()
    bf = _all_kernels(q, k, v, do, lse, delta, True)
    f32 = (*fa.flash_fwd_cuda(q, k, v, scale, True, torch.float32),
           *fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, True,
                              torch.float32),
           fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, True,
                            torch.float32))
    again = (*fa.flash_fwd_cuda(q, k, v, scale, True, torch.float32),
             *fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, True,
                                torch.float32),
             fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, True,
                              torch.float32))
    torch.cuda.synchronize()
    for a, b in zip(f32, again):
        assert torch.equal(a, b)
    for a, b in zip(f32, bf):
        assert torch.equal(a.to(b.dtype), b)
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_dkv": 1,
                                  "flash_dq": 1, "flash_fwd_f32": 2,
                                  "flash_dkv_f32": 2, "flash_dq_f32": 2}


def test_fp32_forms_take_only_fp32_or_bf16_outputs(cuda_kernels):
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q, q, q, 0.1, True, out_dtype=torch.float16)
