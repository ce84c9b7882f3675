"""Ring attention: sequence parallelism over one mesh axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``, in the same
``[batch, seq_shard, heads, head_dim]`` layout. The sequence is sharded
over the axis; rank i holds query block Q_i and key/value block
(K_i, V_i). The K/V blocks travel around the ring (rank i sends to
i + 1) while each rank accumulates its output with a streaming softmax,
so no rank ever holds the whole sequence. Causal masking uses global
positions: at step t rank i holds block j = (i - t) mod n.

- :func:`ring_attention` (plain): per step the [shard, shard] fp32
  scores, the running max, normaliser and numerator, as JAX's
  ``_ring_step``; autograd runs through :func:`~.collectives.ppermute`,
  whose backward is the inverse shift.
- :func:`ring_flash_attention`: per step the flash kernels' fp32-output
  forms on the (q shard, resident block) pair, merged with
  ``logaddexp``; a custom backward sends K/V around the ring again with
  fp32 dK/dV accumulators that travel with their block and arrive home
  after n shifts, and runs K2/K3 with the global lse and delta. Per
  step the branch is skip (the block lies wholly above the diagonal),
  diagonal (K1 causal on the shard pair) or past (K1 non-causal).

The step bodies :func:`ring_flash_fwd_step` and
:func:`ring_flash_bwd_step` take (q, the resident block, the carry, the
branch) and do no communication, so n virtual ranks of one sequence can
run in one process (``chip_smoke.py``) with the shift done by hand.

A shift after the last step would only bring K/V home unused, so the
port leaves it out (JAX's scan makes n); dK/dV make all n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.flash_attention import _flash_bwd, _flash_fwd, _from_bh, _to_bh
from .collectives import axis_index, axis_size, ppermute

SKIP, DIAG, PAST = 0, 1, 2


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with fp32 scores; output in q's dtype."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def ring_attention(q, k, v, *, mesh: DeviceMesh, axis: str = "sp",
                   causal: bool = True, scale: Optional[float] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Blockwise ring attention over ``axis`` of ``mesh``; q, k, v are
    this rank's ``[batch, seq_shard, heads, head_dim]`` shards, and so
    is the result. ``use_flash`` runs :func:`ring_flash_attention`."""
    if use_flash:
        return ring_flash_attention(q, k, v, mesh=mesh, axis=axis,
                                    causal=causal, scale=scale)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    m = torch.full((b, h, sq), float("-inf"), device=dev)
    l = torch.zeros(b, h, sq, device=dev)
    num = torch.zeros(b, sq, h, d, device=dev)
    for t in range(n):
        j = (idx - t) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        if causal:
            q_pos = idx * sq + torch.arange(sq, device=dev)[:, None]
            k_pos = j * sk + torch.arange(sk, device=dev)[None, :]
            scores = torch.where(q_pos >= k_pos, scores, float("-inf"))
        m_new = torch.maximum(m, scores.amax(-1))
        # A block wholly masked for a row keeps the old statistics; rows
        # with no mass yet carry zero numerator and normaliser, so their
        # correction is 0, not exp(-inf - -inf).
        m_new = torch.where(torch.isfinite(m_new), m_new, m)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(torch.isfinite(scores), p, 0.0)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                          v.float())
        num = num * corr.transpose(1, 2)[..., None] + pv
        l = l * corr + p.sum(-1)
        m = m_new
        if t < n - 1:
            k, v = ppermute((k, v), mesh, axis)
    l = l.clamp_min(1e-20)
    return (num / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_branch(idx: int, t: int, n: int, causal: bool) -> int:
    """SKIP, DIAG or PAST for rank ``idx`` at step ``t`` of ``n``."""
    if not causal:
        return PAST
    j = (idx - t) % n
    return SKIP if j > idx else (DIAG if j == idx else PAST)


def ring_flash_fwd_step(qb, kb, vb, out, lse, branch: int, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward step on ``[BH, S, D]`` operands: attend the q shard
    to the resident block and merge into the carry ``(out [BH,S,D]
    fp32, lse [BH,S,1] fp32)``, None before the first block.

    JAX's carry starts at out 0, lse -inf; merged with it, a block gives
    itself exactly (``logaddexp(-inf, x)`` is x, its weight exp(0) is
    1), so the first block becomes the carry as it is. The skip branch
    leaves the carry as it is (JAX merges a zero block of lse -inf,
    which changes nothing). Sentinels: the ``isfinite`` guards of the
    merge are pinned to -inf (no mass), so (-inf) - (-inf) never makes a
    NaN; the kernels give a massless row -1e30 (finite), which passes the
    guards and whose weight underflows to 0 against any real mass."""
    if branch == SKIP:
        return out, lse
    o_j, lse_j = _flash_fwd(qb, kb, vb, scale, branch == DIAG,
                            out_dtype=torch.float32)
    if out is None:
        return o_j, lse_j
    lse_new = torch.logaddexp(lse, lse_j)
    w_r = torch.where(torch.isfinite(lse), torch.exp(lse - lse_new), 0.0)
    w_j = torch.where(torch.isfinite(lse_j), torch.exp(lse_j - lse_new),
                      0.0)
    return out * w_r + o_j * w_j, lse_new


def ring_flash_bwd_step(qb, kb, vb, gb, lse, delta, dq, dk, dv,
                        branch: int, scale: float):
    """One backward step: the (q shard, resident block) pair's dQ, dK
    and dV from K2/K3 with the GLOBAL lse and delta, in fp32, added to
    the accumulators (dq stays home; dk/dv travel with the block). An
    accumulator is None until its first block, which it then is."""
    if branch == SKIP:
        return dq, dk, dv
    dq_j, dk_j, dv_j = _flash_bwd(qb, kb, vb, gb, lse, delta, scale,
                                  branch == DIAG, out_dtype=torch.float32)
    return tuple(new if acc is None else acc + new
                 for acc, new in ((dq, dq_j), (dk, dk_j), (dv, dv_j)))


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        b, sq, h, d = q.shape
        n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
        qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
        out = lse = None
        kc, vc = kb, vb
        for t in range(n):
            out, lse = ring_flash_fwd_step(qb, kc, vc, out, lse,
                                           ring_branch(idx, t, n, causal),
                                           scale)
            if t < n - 1:
                kc, vc = ppermute((kc, vc), mesh, axis)
        ob = out.to(q.dtype)
        ctx.save_for_backward(qb, kb, vb, ob, lse)
        ctx.args = (mesh, axis, causal, scale, b, h)
        return _from_bh(ob, b, h)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, ob, lse = ctx.saved_tensors
        mesh, axis, causal, scale, b, h = ctx.args
        n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
        gb = _to_bh(g.to(qb.dtype))
        # The softmax-jacobian diagonal of the global output: the same
        # for every block pair.
        delta = (gb.float() * ob.float()).sum(-1, keepdim=True)
        dq = dk = dv = None
        kc, vc = kb, vb
        for t in range(n):
            dq, dk, dv = ring_flash_bwd_step(
                qb, kc, vc, gb, lse, delta, dq, dk, dv,
                ring_branch(idx, t, n, causal), scale)
            if t < n - 1:
                kc, vc, dk, dv = ppermute((kc, vc, dk, dv), mesh, axis)
            else:
                dk, dv = ppermute((dk, dv), mesh, axis)
        return (_from_bh(dq.to(qb.dtype), b, h),
                _from_bh(dk.to(kb.dtype), b, h),
                _from_bh(dv.to(vb.dtype), b, h), None, None, None, None)


def ring_flash_attention(q, k, v, *, mesh: DeviceMesh, axis: str = "sp",
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with the flash kernels as the inner op: O(shard)
    memory per rank in forward and backward. On the CPU the kernels'
    plain versions run."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, mesh, axis, causal, float(scale))
