"""The split-TF32 numerics of the port's fp32 flash backward against the
JAX package's fp32 gradients.

The fp32 forms of K2 (dK, dV) and K3 (dQ)
(``horovod_tpu_torch/ops/csrc/flash_attention_fp32.cu``) run every
product on the tensor cores in three TF32 passes: each fp32 operand x is
``big`` plus ``small``, ``big`` rounded to TF32 as PTX's
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, on the 13
low mantissa bits) and ``small = x - big`` read by the tensor core as a
TF32 value (its 13 low bits dropped: toward zero), and each product is
``small big + big small + big big`` accumulated in fp32. The kernels run
only on the card; this file emulates their product split in plain torch
and runs it through the backward's formulas (q * scale in fp32, ``P = exp(S - lse)`` with masked
pairs 0, ``dS = P (dP - delta)``, dQ scaled once at the end), so that
the split's accuracy is held to JAX's ``flash_attention(...,
interpret=True)`` gradients on fp32 inputs before any chip run: 1e-4 of
max |JAX|, the limit the card holds the kernels to against their plain
versions (``chip_smoke.py`` phases 3b and 3c). Inputs are drawn with
numpy from a seed. Head dims 16-512, causal and not, with ragged
sq != sk as in ``tests/test_torch_flash_wide.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

DIMS = (16, 48, 128, 256, 320, 512)
SHAPES = ((True, 40, 40), (False, 24, 56), (True, 56, 24))  # causal, sq, sk
GRAD_TOL = 1e-4   # of max |JAX|


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


@pytest.mark.parametrize("causal,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DIMS)
def test_split_backward_matches_jax(d, causal, sq, sk):
    rs = np.random.RandomState(d + 2 * sq + 3 * sk + causal)
    q, g = (rs.standard_normal((1, sq, 2, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rs.standard_normal((1, sk, 2, d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, None, None, True)
        return (o * g).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qb, kb, vb, gb = (tfa._to_bh(torch.tensor(x)) for x in (q, k, v, g))
    o, lse = tfa.flash_fwd_reference(qb, kb, vb, scale, causal)
    delta = (gb * o).sum(-1, keepdim=True)
    grads = split_bwd(qb, kb, vb, gb, lse, delta, scale, causal)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.float32
        assert _rel(tfa._from_bh(got, 1, 2), want) <= GRAD_TOL
