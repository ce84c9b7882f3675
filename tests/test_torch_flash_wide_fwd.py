"""The schedule of the port's 16-bit flash forward above head dim 256
against the JAX package's forward.

The bf16 and fp16 forms of K1 above head dim 256
(``flash_fwd_wide_body`` in ``horovod_tpu_torch/ops/csrc/
flash_attention.cuh``) run only on the card. This file emulates their
arithmetic in plain torch so that the schedule is held to JAX's
``interpret=True`` forward before any chip run: one 64-row q tile at a
time, the key tiles of 64 up to the diagonal, q * scale in the operand
dtype, S as the sum of two fp32 partials (one warpgroup's over the
128-column chunks 0, 2, ..., the other's over 1, 3, ...; each adds the
other's to its own), masked scores -1e30, the running max m, ``P =
exp2(fma(s, log2 e, -m log2 e))`` (masked pairs 0), l and O rescaled by
``corr = exp2((m_old - m) log2 e)``, P rounded to the operand dtype
before ``P V`` in fp32, then ``O / max(l, 1e-30)`` and ``lse = m +
log(max(l, 1e-30))``. Above 512 columns the kernel's CTAs own four
output chunks each and compute the same S, so the result does not
depend on the groups. Tolerances (of max |JAX|), as
``tests/test_torch_flash_wide.py`` and ``tests/test_torch_flash_dtypes.py``
state them: bf16 3e-2 on O (one bf16 rounding of P at other points),
fp16 1e-3; lse 1e-3 absolute. Inputs are drawn with numpy from a seed.
Head dims 384, 512 and 640, causal and not, with ragged sq != sk, and a
sequence of three key tiles (150) for the running max across tiles and
q tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.experiments import wide_fwd_split
from horovod_tpu_torch.experiments.flash_fwd_split import cut_source
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa

DIMS = (384, 512, 640)
SHAPES = ((True, 40, 40), (False, 24, 56), (True, 56, 24),
          (True, 150, 150))                       # causal, sq, sk
TOL = {"bfloat16": 3e-2, "float16": 1e-3}          # O, of max |JAX|
LSE_TOL = 1e-3
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ROWS, KEYS, CHUNK = 64, 64, 128
LOG2E = 1.4426950408889634


def _partial(qs, k, parity):
    """One warpgroup's partial S: the 128-column chunks of its parity."""
    d = qs.shape[-1]
    cols = torch.cat([torch.arange(c, c + CHUNK)
                      for c in range(parity * CHUNK, d, 2 * CHUNK)])
    return qs[..., cols].float() @ k[..., cols].float().transpose(-1, -2)


def wide_fwd(qb, kb, vb, scale, causal):
    """(o in fp32, lse) by the kernel's schedule."""
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    qs = tfa._scaled_q(qb, scale)
    o = torch.zeros(bh, sq, d)
    lse = torch.zeros(bh, sq, 1)
    for q0 in range(0, sq, ROWS):
        rows = torch.arange(q0, q0 + ROWS)[:, None]
        n_kt = -(-sk // KEYS)
        if causal:
            n_kt = min(n_kt, (min(q0 + ROWS, sq) - 1) // KEYS + 1)
        qt = torch.zeros(bh, ROWS, d, dtype=qb.dtype)
        qt[:, :min(ROWS, sq - q0)] = qs[:, q0:q0 + ROWS]
        m = torch.full((bh, ROWS, 1), -1e30)
        l = torch.zeros(bh, ROWS, 1)
        acc = torch.zeros(bh, ROWS, d)
        for kt in range(n_kt):
            k0 = kt * KEYS
            kt_k = torch.zeros(bh, KEYS, d, dtype=kb.dtype)
            kt_v = torch.zeros(bh, KEYS, d, dtype=vb.dtype)
            kt_k[:, :min(KEYS, sk - k0)] = kb[:, k0:k0 + KEYS]
            kt_v[:, :min(KEYS, sk - k0)] = vb[:, k0:k0 + KEYS]
            s = _partial(qt, kt_k, 0) + _partial(qt, kt_k, 1)
            cols = torch.arange(k0, k0 + KEYS)[None, :]
            valid = (rows < sq) & (cols < sk)
            if causal:
                valid &= rows >= cols
            s = torch.where(valid, s, -1e30)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - mx) * LOG2E)
            p = torch.exp2(torch.addcmul(-mx * LOG2E, s,
                                         torch.tensor(LOG2E)))
            p = torch.where(valid, p, 0.0)
            m, l = mx, l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(vb.dtype).float() @ kt_v.float()
        l = l.clamp_min(1e-30)
        n = min(ROWS, sq - q0)
        o[:, q0:q0 + n] = (acc / l)[:, :n]
        lse[:, q0:q0 + n] = (m + torch.log(l))[:, :n]
    return o, lse


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wide_schedule_matches_jax(dtype, d, causal, sq, sk):
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(d + sq + 3 * sk + causal)
    q = rs.standard_normal((2, sq, d)).astype(np.float32)
    k, v = (rs.standard_normal((2, sk, d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5
    want_o, want_lse = jfa._flash_fwd(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                      scale, causal, 16, 16, True)
    o, lse = wide_fwd(*(torch.tensor(x).to(tdt) for x in (q, k, v)), scale,
                      causal)
    assert _rel(o.to(tdt).float(), np.asarray(want_o, np.float32)) <= TOL[dtype]
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)).max()) <= LSE_TOL


def test_both_warpgroups_hold_the_same_scores():
    """Each warpgroup adds the other's partial to its own: fp32 addition
    commutes, so both hold the same S bits, and so the same P."""
    rs = np.random.RandomState(7)
    a, b = (torch.tensor(rs.standard_normal(4096).astype(np.float32)
                         * 10.0 ** rs.randint(-6, 6, 4096)) for _ in range(2))
    assert torch.equal(a + b, b + a)


def test_turns_script_refuses_to_run_without_a_card(monkeypatch):
    from horovod_tpu_torch.experiments import wide_fwd_turns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        wide_fwd_turns.main(["--other", "."])


@pytest.mark.parametrize("cut", sorted(wide_fwd_split.CUTS))
def test_split_cuts_apply_to_the_source(cut):
    """Each cut of ``experiments/wide_fwd_split.py`` finds its pieces in
    the committed kernel source exactly once (a cut whose text drifted
    would stop the script on the card), and changes the source unless it
    is the base."""
    text = (_build.CSRC / "flash_attention.cuh").read_text()
    out = cut_source(text, cut, wide_fwd_split.CUTS)
    assert (out == text) == (cut == "base")
