"""The split-TF32 numerics of the port's fp32 flash kernels against the
JAX package's fp32 forward and gradients.

The fp32 forms of K1 (O, lse), K2 (dK, dV) and K3 (dQ)
(``horovod_tpu_torch/ops/csrc/flash_attention_fp32.cu``) run every
product on the tensor cores in three TF32 passes: each fp32 operand x is
``big`` plus ``small``, ``big`` rounded to TF32 as PTX's
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, on the 13
low mantissa bits) and ``small = x - big`` read by the tensor core as a
TF32 value (its 13 low bits dropped: toward zero), and each product is
``small big + big small + big big`` accumulated in fp32. The kernels run
only on the card; this file emulates their product split in plain torch
and runs it through the kernels' formulas, so that the split's accuracy
is held to JAX's ``interpret=True`` kernels on fp32 inputs before any
chip run, at the limits the card holds the kernels to against their
plain versions (``chip_smoke.py`` phases 3b and 3c). The forward: q *
scale in fp32, the key tiles of 64 in the kernel's order, each with
``S`` split, masked scores -1e30, the running max m, ``P =
exp2(fma(s, log2 e, -m log2 e))`` (masked pairs 0), l rescaled by
``corr = exp2((m_old - m) log2 e)``, ``O = fma(O, corr, P V)`` with the
tile's P V split and summed apart, then ``O / max(l, 1e-30)`` and ``lse
= m + log(max(l, 1e-30))``; O and lse within 2e-5 of max |JAX|. The
backward: ``P = exp(S - lse)`` with masked pairs 0, ``dS = P (dP -
delta)``, dQ scaled once at the end; 1e-4 of max |JAX|. JAX's forward
runs once a case, for both directions. Inputs are drawn with numpy
from a seed. Head dims 16-512, causal and not, with ragged sq != sk as
in ``tests/test_torch_flash_wide.py``, and a sequence of three key
tiles for the forward's running max.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

DIMS = (16, 48, 128, 256, 320, 512)
SHAPES = ((True, 40, 40), (False, 24, 56), (True, 56, 24))  # causal, sq, sk
FWD_SHAPES = SHAPES + ((True, 150, 150),)   # three 64-key tiles
GRAD_TOL = 1e-4   # of max |JAX|
FWD_TOL = 2e-5    # of max |JAX|, O and lse
BN = 64           # keys of a forward tile
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32``: half an ulp of
    the 13 dropped bits added to the magnitude (the sign bit is apart,
    so a tie goes away from zero), then those bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` as the tensor core reads a ``.tf32`` register: the 13
    low mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels form it: three TF32 passes in fp32."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    a_small, b_small = tf32_rz(a - a_big), tf32_rz(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def split_bwd(qb, kb, vb, do, lse, delta, scale, causal):
    """(dq, dk, dv) of ``[BH, S, D]`` fp32 operands through the
    kernels' formulas, every product split."""
    sq, sk = qb.shape[1], kb.shape[1]
    qs = qb * torch.tensor(scale, dtype=torch.float32)
    valid = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        valid = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
    s = split_mm(qs, kb.transpose(1, 2))
    p = torch.where(valid, torch.exp(s - lse), 0.0)
    dp = split_mm(do, vb.transpose(1, 2))
    ds = p * (dp - delta)
    dv = split_mm(p.transpose(1, 2), do)
    dk = split_mm(ds.transpose(1, 2), qs)
    dq = split_mm(ds, kb) * scale
    return dq, dk, dv


def _fma(a, b, c) -> torch.Tensor:
    """fp32 ``fmaf(a, b, c)`` of fp32 tensors or floats: the product is
    exact in fp64."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def split_fwd(qb, kb, vb, scale, causal):
    """(o, lse [BH, S, 1]) of ``[BH, S, D]`` fp32 operands through the
    forward kernel's formulas, tile by tile, every product split."""
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    qs = qb * torch.tensor(scale, dtype=torch.float32)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, BN):
        keys = torch.arange(k0, min(k0 + BN, sk))[None, :]
        valid = rows >= keys if causal else torch.ones_like(rows >= keys)
        s = split_mm(qs, kb[:, k0:k0 + BN].transpose(1, 2))
        s = torch.where(valid, s, -1e30)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * log2e)
        p = torch.where(valid, torch.exp2(_fma(s, LOG2E, -mx * log2e)), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = _fma(acc, corr, split_mm(p, vb[:, k0:k0 + BN]))
        m = mx
    l = l.clamp_min(1e-30)
    return acc * (1 / l), m + torch.log(l)


@functools.lru_cache(maxsize=None)
def _case(d, causal, sq, sk):
    """The case's inputs ([BH, S, D] numpy, BH = 2) and JAX's fp32
    forward (o, lse)."""
    rs = np.random.RandomState(d + 2 * sq + 3 * sk + causal)
    q, g = (rs.standard_normal((1, sq, 2, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rs.standard_normal((1, sk, 2, d)).astype(np.float32)
            for _ in range(2))
    arrays = tuple(np.asarray(jfa._to_bh(jnp.asarray(x)))
                   for x in (q, k, v, g))
    o, lse = jfa._flash_fwd(*(jnp.asarray(x) for x in arrays[:3]),
                            d ** -0.5, causal, None, None, True)
    return arrays, (np.asarray(o), np.asarray(lse))


def _jax_grads(d, causal, sq, sk):
    """JAX's fp32 gradients (dq, dk, dv) of ``(o * g).sum()`` from the
    case's forward, as ``flash_attention``'s custom VJP forms them."""
    arrays, (o, lse) = _case(d, causal, sq, sk)
    qb, kb, vb, gb = (jnp.asarray(x) for x in arrays)
    delta = jnp.sum(gb * jnp.asarray(o), axis=-1, keepdims=True)
    return jfa._flash_bwd(qb, kb, vb, gb, jnp.asarray(lse), delta,
                          d ** -0.5, causal, None, None, True)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),   # 1.0, exact in TF32
    (0x3FC00000, 0x3FC00000),   # 1.5, exact
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),   # below the tie: down
    (0x3F801001, 0x3F802000),   # above the tie: up
    (0xBF800FFF, 0xBF800000),   # negative, below the tie
    (0x3FFFFFFF, 0x40000000),   # carries into the exponent: 2.0
    (0x00001000, 0x00002000),   # a subnormal tie
])
def test_tf32_rna_rounds_as_cvt_rna(bits, want):
    assert _round_bits(tf32_rna, bits) == want


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),   # exact
    (0x3F801FFF, 0x3F800000),   # just below the next TF32 value: down
    (0xBF801FFF, 0xBF800000),   # negative: toward zero too
    (0x39801234, 0x39800000),   # a small remainder's low bits dropped
])
def test_tf32_rz_drops_the_low_bits(bits, want):
    assert _round_bits(tf32_rz, bits) == want


def _round_bits(fn, bits: int) -> int:
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    return int(fn(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF)


def test_split_keeps_fp32_where_one_pass_does_not():
    rs = np.random.RandomState(7)
    a = torch.tensor(rs.standard_normal((64, 512)).astype(np.float32))
    b = torch.tensor(rs.standard_normal((512, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    split_err = float((split_mm(a, b).double() - exact).abs().max())
    one_err = float((tf32_rna(a) @ tf32_rna(b)).double().sub(exact)
                    .abs().max())
    fp32_err = float(((a @ b).double() - exact).abs().max())
    assert split_err <= 4 * fp32_err and one_err > 30 * split_err


@pytest.mark.parametrize("causal,sq,sk", FWD_SHAPES)
@pytest.mark.parametrize("d", DIMS)
def test_split_forward_matches_jax(d, causal, sq, sk):
    (qb, kb, vb, _), (want_o, want_lse) = _case(d, causal, sq, sk)
    o, lse = split_fwd(*(torch.tensor(x) for x in (qb, kb, vb)),
                       d ** -0.5, causal)
    assert o.dtype == torch.float32 and lse.shape == want_lse.shape
    assert _rel(o, want_o) <= FWD_TOL
    assert _rel(lse, want_lse) <= FWD_TOL


@pytest.mark.parametrize("causal,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DIMS)
def test_split_backward_matches_jax(d, causal, sq, sk):
    arrays, _ = _case(d, causal, sq, sk)
    qb, kb, vb, gb = (torch.tensor(x) for x in arrays)
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_reference(qb, kb, vb, scale, causal)
    delta = (gb * o).sum(-1, keepdim=True)
    grads = split_bwd(qb, kb, vb, gb, lse, delta, scale, causal)
    for got, want in zip(grads, _jax_grads(d, causal, sq, sk)):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= GRAD_TOL
