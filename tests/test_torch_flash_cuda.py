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
and not, and both head dims, and head dim 264 (padded to 384 by the wrapper for
the ``_wide`` kernels). Repeats are bit-identical (no
atomics), and operands that are views into larger NaN-filled buffers
give what clean copies give (nothing past the sequence is read). The
wrappers refuse head dims of q and k that differ, a head dim of 0 and
float64 operands.

The fp32-output forms (``out_dtype=torch.float32``, what ring attention
launches) are held to their plain fp32 versions at the same shapes and
tolerance, write fp32, repeat bit for bit, count apart from the bf16
forms, and round to exactly the bf16 forms' outputs.

The fp16 forms (fp16 and fp32 outputs) and the fp32 forms, and
every form at head dims {8, 16, 48, 80, 112, 160, 192, 256, 264, 512,
640, 1152} (8 padded to 16 by the wrapper; 160-256 stored 256 wide, in
two column chunks; 264 padded to 384, 512, 640 and 1152 on the
``_wide`` kernels: the 16-bit forward holds Q and computes S once per
q tile up to 512, and above it once per group of four output chunks,
with Q streamed), are
held to their plain versions causal and not, with ragged sq != sk:
fp16 5e-3 of max |plain| (lse 1e-3 absolute), fp32 2e-5 of max |plain|
on O and lse, 1e-4 on dQ, dK and dV; each repeats bit for bit, and the
fp16 form's fp32 outputs round to the fp16 form's bits (at head dims 64,
256 and 512, as the bf16 form's do at 96, 128 and 512).

The 16-bit ``_wide`` backward (K2 and K3 above head dim 256: K3 owns 64
q rows and up to four output chunks, S and dP split between two
warpgroups by chunk parity, 32-key tiles through TMA rings; K2 the same
at head dim 512 and one output chunk a CTA at the others) at its edges:
head dims 264 (padded to 384: three chunks, one warpgroup's parity one
chunk short), 512 and 640 (two groups of K3); sequences of 100, 150 and
192 (a 32-row tile partly and wholly past the end, a 64-row tile partly
past it), causal and not, ragged sq != sk; every 16-bit form against its
plain version at the tolerances above, repeats bit for bit; and views
into NaN-filled buffers at those head dims give what clean copies give.
Its schedule's own claims, bit for bit: K3 at 640 (two groups, operands
streamed) on operands zero past column 512 gives K3 at 512 (one group,
operands resident) on the rest; and with column chunk 1 of every operand
a copy of chunk 0, chunks 0 and 1 of dQ, dK and dV (warpgroups 0 and 1)
are equal.
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
    (2, 130, 264, True),
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
                                        (64, 128, True), (1, 64, True),
                                        (100, 512, True), (150, 640, False),
                                        (192, 264, True)])
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
    assert fa.launch_counts() == _counts(flash_fwd=1, flash_dkv=1,
                                         flash_dq=1)
    assert out.shape == q.shape and torch.isfinite(q.grad.float()).all()


def _counts(**launched):
    return {**{n: 0 for n in fa.launch_counts()}, **launched}


def test_wrappers_reject_what_the_kernel_does_not_take(cuda_kernels):
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(2, 64, 32, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dims differ"):
        fa.flash_fwd_cuda(q, k, k, 0.1, True)
    q = torch.zeros(2, 64, 0, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim must be positive"):
        fa.flash_fwd_cuda(q, q, q, 0.1, True)
    q = torch.zeros(2, 64, 64, dtype=torch.float64, device="cuda")
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


def _keys(d, **launched):
    """_counts with each key under its ``_wide`` name above head dim 256."""
    wide = "_wide" if d > fa.HEAD_DIMS[-1] else ""
    return _counts(**{name + wide: n for name, n in launched.items()})


@pytest.mark.parametrize("d", [96, 128, 512])
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
    assert fa.launch_counts() == _keys(
        d, flash_fwd=1, flash_dkv=1, flash_dq=1, flash_fwd_f32=2,
        flash_dkv_f32=2, flash_dq_f32=2)


def test_fp32_forms_take_only_fp32_or_bf16_outputs(cuda_kernels):
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q, q, q, 0.1, True, out_dtype=torch.float16)


# The new forms: (operand dtype, out_dtype, tolerance of O and of the
# gradients as a share of max |plain|, lse tolerance, relative or not).
FORMS = {
    "bf16": (torch.bfloat16, None, 2e-2, 2e-2, 1e-3, False),
    "bf16_f32": (torch.bfloat16, torch.float32, 2e-2, 2e-2, 1e-3, False),
    "f16": (torch.float16, None, 5e-3, 5e-3, 1e-3, False),
    "f16_f32": (torch.float16, torch.float32, 5e-3, 5e-3, 1e-3, False),
    "fp32": (torch.float32, None, 2e-5, 1e-4, 2e-5, True),
}
WIDE_DIMS = (8, 16, 48, 80, 112, 160, 192, 256, 264, 512, 640, 1152)


@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200),
                                          (False, 130, 250),
                                          (True, 257, 70)])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_every_form_and_head_dim_matches_plain(cuda_kernels, form, d,
                                               causal, sq, sk):
    dtype, out, tol, gtol, ltol, lrel = FORMS[form]
    g = torch.Generator(device="cuda").manual_seed(d + sq)
    q, do = (torch.randn(3, sq, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(3, sk, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal, out)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, scale, causal,
                                  out)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, out)
        dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale,
                                   causal, out)
        dq = fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal,
                              out)
        runs.append((o, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    o, lse, dq, dk, dv = runs[0]
    assert o.dtype == o_ref.dtype and dq.dtype == want[0].dtype
    assert _rel(o, o_ref) <= tol
    lse_err = float((lse - lse_ref).abs().max())
    if lrel:
        lse_err /= float(lse_ref.abs().max())
    assert lse_err <= ltol
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(got, ref) <= gtol


@pytest.mark.parametrize("d", [64, 256, 512])
def test_fp16_fp32_outputs_round_to_the_fp16_forms(cuda_kernels, d):
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(2, 300, d, generator=g, device="cuda")
                   .half() for _ in range(4))
    lse, delta = _stats(q, k, v, do, True)
    scale = d ** -0.5
    fa.reset_launch_counts()
    h = (*fa.flash_fwd_cuda(q, k, v, scale, True),
         *fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, True),
         fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, True))
    f = (*fa.flash_fwd_cuda(q, k, v, scale, True, torch.float32),
         *fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, True,
                            torch.float32),
         fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, True,
                          torch.float32))
    torch.cuda.synchronize()
    for a, b in zip(f, h):
        assert torch.equal(a.to(b.dtype), b)
    assert fa.launch_counts() == _keys(
        d, flash_fwd_f16=1, flash_dkv_f16=1, flash_dq_f16=1,
        flash_fwd_f16_f32=1, flash_dkv_f16_f32=1, flash_dq_f16_f32=1)


@pytest.mark.parametrize("causal,sq,sk", [(True, 100, 100), (False, 150, 100),
                                          (True, 192, 150), (False, 100, 192)])
@pytest.mark.parametrize("d", [264, 512, 640])
@pytest.mark.parametrize("form", ["bf16", "bf16_f32", "f16", "f16_f32"])
def test_wide_backward_edges_match_plain(cuda_kernels, form, d, causal, sq,
                                         sk):
    dtype, out, _, gtol, _, _ = FORMS[form]
    g = torch.Generator(device="cuda").manual_seed(3 * d + sq + sk)
    q, do = (torch.randn(2, sq, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, sk, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    o_ref, lse = fa.flash_fwd_reference(q, k, v, scale, causal, out)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q, k, v, do, lse, delta, scale, causal, out)
    runs = [(fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, causal, out),
             *fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, causal, out))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for got, ref in zip(runs[0], want):
        assert got.dtype == ref.dtype
        assert _rel(got, ref) <= gtol


def _wide_operands(form, d, sq, sk, seed):
    dtype = FORMS[form][0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(2, sq, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, sk, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("causal,sq,sk", [(True, 150, 150),
                                          (False, 100, 192)])
@pytest.mark.parametrize("form", ["bf16", "bf16_f32", "f16", "f16_f32"])
def test_wide_dq_groups_do_not_change_the_bits(cuda_kernels, form, causal,
                                               sq, sk):
    """K3 at D = 640 (two groups of output chunks, S and dP computed
    anew in each, every operand streamed) on operands whose last 128
    columns are zero gives, bit for bit, K3 at D = 512 (one group, the
    own rows' operands resident) on the first 512 columns, and zeros in
    the last chunk; both take the same lse, delta and scale."""
    out = FORMS[form][1]
    q, k, v, do = _wide_operands(form, 640, sq, sk, 7 * sq + sk)
    for x in (q, k, v, do):
        x[..., 512:] = 0
    narrow = [x[..., :512].contiguous() for x in (q, k, v, do)]
    scale = 512 ** -0.5
    lse, delta = _stats(*narrow, causal)
    wide = fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, causal, out)
    dq = fa.flash_dq_cuda(*narrow, lse, delta, scale, causal, out)
    torch.cuda.synchronize()
    assert torch.equal(wide[..., :512], dq)
    assert not wide[..., 512:].any()


@pytest.mark.parametrize("d", [512, 640])
@pytest.mark.parametrize("form", ["bf16", "bf16_f32", "f16", "f16_f32"])
def test_both_warpgroups_hold_the_same_scores(cuda_kernels, form, d):
    """Output chunks 0 and 1 belong to warpgroups 0 and 1 (K3's dQ at
    both head dims, K2's pair at 512), each of which adds the other's
    partial S and dP to its own. With column chunk 1 of every operand a
    copy of chunk 0, the two chunks of those outputs come out bit for bit
    equal only if both warpgroups hold the same P and dS. (At 640 K2
    runs its one-chunk form, whose CTA for chunk c sums S^T over the
    k-chunks from c + 1 on, so its chunks' bits may differ.)"""
    out = FORMS[form][1]
    q, k, v, do = _wide_operands(form, d, 150, 150, d)
    for x in (q, k, v, do):
        x[..., 128:256] = x[..., :128]
    lse, delta = _stats(q, k, v, do, True)
    scale = d ** -0.5
    dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, True, out)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, True, out)
    torch.cuda.synchronize()
    grads = {"dq": dq, "dk": dk, "dv": dv} if d == 512 else {"dq": dq}
    for name, g in grads.items():
        assert g[..., :128].abs().max() > 0, name
        assert torch.equal(g[..., :128], g[..., 128:256]), name
