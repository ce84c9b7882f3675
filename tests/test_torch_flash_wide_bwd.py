"""The schedule of the port's 16-bit flash backward above head dim 256
against the JAX package's backward.

The bf16 and fp16 forms of K2 and K3 above head dim 256
(``flash_bwd_wide_body`` in ``horovod_tpu_torch/ops/csrc/
flash_attention.cuh``: ``flash_dkv_wide_body`` and ``flash_dq_wide_body``)
run only on the card. This file emulates their arithmetic in plain torch
so that the schedule is held to JAX's ``_flash_bwd(..., interpret=True)``
before any chip run:

- K3 walks 64-row q tiles and, for each group of up to four 128-column
  output chunks, the 32-key tiles up to the diagonal; K2 walks 64-row key
  tiles and, for each pair of output chunks, the 32-row q tiles from the
  diagonal on. Each group computes S and dP (K2: S^T and dP^T) anew. At
  any head dim but 512 (four chunks) K2 runs its one-chunk-a-CTA form
  instead (``flash_dkv_chunk_body``), measured faster there: per
  128-column output chunk, the 64-row q tiles from the diagonal on, S^T
  and dP^T each one fp32 sum over the whole head dim;
- q * scale rounded to the operand dtype once (the scale rounded first);
- S and dP as the sum of two fp32 partials, one warpgroup's over the
  128-column chunks 0, 2, ... and the other's over 1, 3, ... (each adds
  the other's to its own);
- ``P = exp2(fma(s, log2 e, -lse log2 e))``, masked to 0 past the
  diagonal and past either sequence (tile rows past a sequence are zero
  as TMA lands them, and their outputs are not stored); ``dS = P (dP -
  delta)``;
- P and dS rounded to the operand dtype before ``P^T dO``, ``dS K`` and
  ``dS^T Qs`` in fp32; dQ times the fp32 scale at the end.

At D = 640 the emulation's dQ in two groups equals its dQ in one. That
the kernels hold these bits (both warpgroups the same S and dP, the
groups the same dQ) is checked on the card, in
``tests/test_torch_flash_cuda.py``.

Tolerances (of max |JAX| on dQ, dK and dV), as
``tests/test_torch_flash_wide.py`` and ``tests/test_torch_flash_dtypes.py``
state them: bf16 3e-2 (one bf16 rounding of P or dS at other points),
fp16 2e-3. Inputs are drawn with numpy from a seed; lse and delta come
from JAX's interpret-mode forward. Head dims 384, 512 and 640 (two
groups of K3, three pairs of K2), causal and not, with ragged sq != sk,
and 150 rows (ragged tiles on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.experiments import wide_bwd_split
from horovod_tpu_torch.experiments.flash_fwd_split import cut_source
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa

DIMS = (384, 512, 640)
SHAPES = ((True, 40, 40), (False, 24, 56), (True, 56, 24),
          (True, 150, 150))                       # causal, sq, sk
TOL = {"bfloat16": 3e-2, "float16": 2e-3}          # of max |JAX|
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ROWS, COLS, CHUNK = 64, 32, 128      # owned rows, streamed rows, chunk
LOG2E = 1.4426950408889634


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of [bh, s, ...], zero past the sequence."""
    out = torch.zeros(x.shape[0], n, *x.shape[2:], dtype=x.dtype)
    got = x[:, r0:r0 + n]
    out[:, :got.shape[1]] = got
    return out


def _cols(d, chunks):
    return torch.cat([torch.arange(c * CHUNK, (c + 1) * CHUNK)
                      for c in chunks])


def _partials(a, b, nc):
    """The two warpgroups' fp32 partials of a b^T, by chunk parity."""
    return [a[..., _cols(0, range(w, nc, 2))].float()
            @ b[..., _cols(0, range(w, nc, 2))].float().transpose(-1, -2)
            for w in (0, 1)]


def _p_ds(s, dp, lse2, delta, valid):
    p = torch.exp2(torch.addcmul(-lse2, s, torch.tensor(LOG2E)))
    p = torch.where(valid, p, 0.0)
    return p, p * (dp - delta)


def wide_dq(qb, kb, vb, dob, lse, delta, scale, causal, group=4):
    """K3's dQ in fp32 by the kernel's schedule, groups of ``group``
    output chunks."""
    bh, sq, d = qb.shape
    sk, nc, dt = kb.shape[1], d // CHUNK, qb.dtype
    qs = tfa._scaled_q(qb, scale)
    dq = torch.zeros(bh, sq, d)
    for r0 in range(0, sq, ROWS):
        n = min(ROWS, sq - r0)
        q_t, do_t = _rows(qs, r0, ROWS), _rows(dob, r0, ROWS)
        lse2, dl = _rows(lse, r0, ROWS) * LOG2E, _rows(delta, r0, ROWS)
        t_end = -(-sk // COLS)
        if causal:
            t_end = min(t_end, (min(r0 + ROWS, sq) - 1) // COLS + 1)
        rows = torch.arange(r0, r0 + ROWS)[:, None]
        for c0 in range(0, nc, group):
            own = range(c0, min(c0 + group, nc))
            acc = {c: torch.zeros(bh, ROWS, CHUNK) for c in own}
            for t in range(t_end):
                k_t, v_t = _rows(kb, t * COLS, COLS), _rows(vb, t * COLS, COLS)
                keys = torch.arange(t * COLS, (t + 1) * COLS)[None, :]
                valid = (rows < sq) & (keys < sk)
                if causal:
                    valid &= rows >= keys
                s0, s1 = _partials(q_t, k_t, nc)
                p0, p1 = _partials(do_t, v_t, nc)
                _, ds = _p_ds(s0 + s1, p0 + p1, lse2, dl, valid)
                for c in own:   # one accumulator a chunk, as the kernel
                    acc[c] += ds.to(dt).float() @ k_t[..., _cols(d, [c])].float()
            for c in own:
                dq[:, r0:r0 + n, _cols(d, [c])] = (acc[c] * scale)[:, :n]
    return dq


def chunk_dkv(qb, kb, vb, dob, lse, delta, scale, causal):
    """K2's (dK, dV) in fp32 by the one-chunk-a-CTA schedule: S^T and
    dP^T one fp32 sum each over a 64-row q tile."""
    bh, sq, d = qb.shape
    sk, dt = kb.shape[1], qb.dtype
    qs = tfa._scaled_q(qb, scale)
    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    for r0 in range(0, sk, ROWS):
        n = min(ROWS, sk - r0)
        k_t, v_t = _rows(kb, r0, ROWS), _rows(vb, r0, ROWS)
        keys = torch.arange(r0, r0 + ROWS)[:, None]
        for c in range(d // CHUNK):
            cc = _cols(d, [c])
            acc_k = torch.zeros(bh, ROWS, CHUNK)
            acc_v = torch.zeros(bh, ROWS, CHUNK)
            for q0 in range(r0 // ROWS * ROWS if causal else 0, sq, ROWS):
                q_t, do_t = _rows(qs, q0, ROWS), _rows(dob, q0, ROWS)
                lse2 = _rows(lse, q0, ROWS).transpose(1, 2) * LOG2E
                dl = _rows(delta, q0, ROWS).transpose(1, 2)
                qrows = torch.arange(q0, q0 + ROWS)[None, :]
                valid = (qrows < sq) & (keys < sk)
                if causal:
                    valid &= qrows >= keys
                s = k_t.float() @ q_t.float().transpose(1, 2)
                dp = v_t.float() @ do_t.float().transpose(1, 2)
                p, ds = _p_ds(s, dp, lse2, dl, valid)
                acc_v += p.to(dt).float() @ do_t[..., cc].float()
                acc_k += ds.to(dt).float() @ q_t[..., cc].float()
            dk[:, r0:r0 + n, cc] = acc_k[:, :n]
            dv[:, r0:r0 + n, cc] = acc_v[:, :n]
    return dk, dv


def wide_dkv(qb, kb, vb, dob, lse, delta, scale, causal, group=2):
    """K2's (dK, dV) in fp32 by the kernel's schedule, groups of
    ``group`` output chunks (the one-chunk-a-CTA form but at four)."""
    if qb.shape[-1] != 4 * CHUNK:
        return chunk_dkv(qb, kb, vb, dob, lse, delta, scale, causal)
    bh, sq, d = qb.shape
    sk, nc, dt = kb.shape[1], d // CHUNK, qb.dtype
    qs = tfa._scaled_q(qb, scale)
    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    for r0 in range(0, sk, ROWS):
        n = min(ROWS, sk - r0)
        k_t, v_t = _rows(kb, r0, ROWS), _rows(vb, r0, ROWS)
        t0 = r0 // COLS if causal else 0
        keys = torch.arange(r0, r0 + ROWS)[:, None]
        for c0 in range(0, nc, group):
            own = range(c0, min(c0 + group, nc))
            acc_k = {c: torch.zeros(bh, ROWS, CHUNK) for c in own}
            acc_v = {c: torch.zeros(bh, ROWS, CHUNK) for c in own}
            for t in range(t0, -(-sq // COLS)):
                q_t, do_t = _rows(qs, t * COLS, COLS), _rows(dob, t * COLS, COLS)
                lse2 = _rows(lse, t * COLS, COLS).transpose(1, 2) * LOG2E
                dl = _rows(delta, t * COLS, COLS).transpose(1, 2)
                qrows = torch.arange(t * COLS, (t + 1) * COLS)[None, :]
                valid = (qrows < sq) & (keys < sk)
                if causal:
                    valid &= qrows >= keys
                s0, s1 = _partials(k_t, q_t, nc)
                p0, p1 = _partials(v_t, do_t, nc)
                p, ds = _p_ds(s0 + s1, p0 + p1, lse2, dl, valid)
                for c in own:
                    cc = _cols(d, [c])
                    acc_v[c] += p.to(dt).float() @ do_t[..., cc].float()
                    acc_k[c] += ds.to(dt).float() @ q_t[..., cc].float()
            for c in own:
                dk[:, r0:r0 + n, _cols(d, [c])] = acc_k[c][:, :n]
                dv[:, r0:r0 + n, _cols(d, [c])] = acc_v[c][:, :n]
    return dk, dv


def _inputs(d, causal, sq, sk, seed=0):
    rs = np.random.RandomState(seed + d + sq + 3 * sk + causal)
    q, do = (rs.standard_normal((2, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rs.standard_normal((2, sk, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wide_bwd_schedule_matches_jax(dtype, d, causal, sq, sk):
    tdt, jdt = DTYPES[dtype]
    q, k, v, do = _inputs(d, causal, sq, sk)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    o, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, 16, 16, True)
    delta = np.sum(np.asarray(jdo, np.float32) * np.asarray(o, np.float32),
                   -1, keepdims=True)
    want = jfa._flash_bwd(jq, jk, jv, jdo, lse, jnp.asarray(delta), scale,
                          causal, 16, 16, True)
    tq, tk, tv, tdo = (torch.tensor(x).to(tdt) for x in (q, k, v, do))
    tl, td = torch.tensor(np.asarray(lse)), torch.tensor(delta)
    dq = wide_dq(tq, tk, tv, tdo, tl, td, scale, causal)
    dk, dv = wide_dkv(tq, tk, tv, tdo, tl, td, scale, causal)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(got.to(tdt).float(), ref) <= TOL[dtype]
    if d > 4 * CHUNK:   # K3's second group recomputes the first's S, dP
        assert torch.equal(dq, wide_dq(tq, tk, tv, tdo, tl, td, scale,
                                       causal, group=d // CHUNK))


def test_turns_script_refuses_to_run_without_a_card(monkeypatch):
    from horovod_tpu_torch.experiments import wide_bwd_turns
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        wide_bwd_turns.main(["--other", "."])


def test_split_script_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        wide_bwd_split.main(["--cuts", "base"])


@pytest.mark.parametrize("cut", sorted(wide_bwd_split.CUTS))
def test_split_cuts_apply_to_the_source(cut):
    """Each cut of ``experiments/wide_bwd_split.py`` finds its pieces in
    the committed kernel source exactly once (a cut whose text drifted
    would stop the script on the card), and changes the source unless it
    is the base."""
    text = (_build.CSRC / "flash_attention.cuh").read_text()
    out = cut_source(text, cut, wide_bwd_split.CUTS)
    assert (out == text) == (cut == "base")
