"""Flash attention for the port: three hand-written CUDA kernels for
Hopper (``csrc/flash_attention.cu``) behind a ``torch.autograd.Function``,
and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. The public
function takes and returns ``[batch, seq, heads, head_dim]``; inside,
the operands are ``[batch*heads, seq, head_dim]``. The numerics follow
the JAX kernels: q is scaled in its own dtype before ``q k^T`` (the scale
itself rounded to that dtype, as JAX's weak-typed scalar is), masked
scores are ``-1e30``, P and dS are cast to the operand dtype before their
products, every product accumulates in fp32, ``lse = m + log(max(l,
1e-30))`` and dQ is multiplied by the fp32 scale once at the end.

Dispatch is by device: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise. Each kernel wrapper counts its launches in
``flash_fwd_launches`` / ``flash_dkv_launches`` / ``flash_dq_launches``.

Each kernel and plain version takes ``out_dtype``, as JAX's ``_flash_fwd``
and ``_flash_bwd`` do: None (the operands' dtype) or fp32, which ring
attention asks for so that its merge of n per-block results does not
stack n bf16 roundings. The plain version casts where JAX's ``_finalize``
casts; on the card fp32 launches each kernel's fp32-output form, whose
launches count apart (``flash_*_f32`` in :func:`launch_counts`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library, ptr, raise_on, stream

NEG_INF = -1e30

flash_fwd_launches = 0
flash_dkv_launches = 0
flash_dq_launches = 0
flash_fwd_f32_launches = 0
flash_dkv_f32_launches = 0
flash_dq_f32_launches = 0

# The head dims csrc/flash_attention.cu is built for (BuiltHeadDims).
HEAD_DIMS = (32, 64, 80, 96, 128)


def launch_counts() -> dict:
    return {"flash_fwd": flash_fwd_launches, "flash_dkv": flash_dkv_launches,
            "flash_dq": flash_dq_launches,
            "flash_fwd_f32": flash_fwd_f32_launches,
            "flash_dkv_f32": flash_dkv_f32_launches,
            "flash_dq_f32": flash_dq_f32_launches}


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_dkv_launches, flash_dq_launches
    global flash_fwd_f32_launches, flash_dkv_f32_launches
    global flash_dq_f32_launches
    flash_fwd_launches = flash_dkv_launches = flash_dq_launches = 0
    flash_fwd_f32_launches = flash_dkv_f32_launches = 0
    flash_dq_f32_launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions: the full [S, S] score matrix, same casts/constants
# --------------------------------------------------------------------------

def _scaled_q(qb: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, the scale rounded to that dtype first."""
    return qb * torch.tensor(scale, dtype=qb.dtype, device=qb.device)


def _valid(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    return ok & (qpos >= kpos) if causal else ok


def flash_fwd_reference(qb, kb, vb, scale: float, causal: bool,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [BH,S,D] in ``out_dtype`` (default q's dtype), lse [BH,S,1]
    fp32)."""
    sq, sk = qb.shape[1], kb.shape[1]
    s = _scaled_q(qb, scale).float() @ kb.float().transpose(1, 2)
    valid = _valid(sq, sk, causal, qb.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(vb.dtype).float() @ vb.float()) / l
    return o.to(out_dtype or qb.dtype), m + torch.log(l)


def flash_bwd_reference(qb, kb, vb, do, lse, delta, scale: float,
                        causal: bool, out_dtype: Optional[torch.dtype] = None):
    """(dq, dk, dv), each [BH,S,D] in ``out_dtype`` (default its
    operand's dtype)."""
    sq, sk = qb.shape[1], kb.shape[1]
    qs = _scaled_q(qb, scale)
    s = qs.float() @ kb.float().transpose(1, 2)
    valid = _valid(sq, sk, causal, qb.device)
    p = torch.where(valid, torch.exp(s - lse), 0.0)
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    dp = do.float() @ vb.float().transpose(1, 2)
    ds = torch.where(valid, p * (dp - delta), 0.0)
    dk = ds.to(qb.dtype).float().transpose(1, 2) @ qs.float()
    dq = (ds.to(kb.dtype).float() @ kb.float()) * scale
    return (dq.to(out_dtype or qb.dtype), dk.to(out_dtype or kb.dtype),
            dv.to(out_dtype or vb.dtype))


# --------------------------------------------------------------------------
# Kernel wrappers (one per launch site)
# --------------------------------------------------------------------------

def _check(name, *tensors):
    d = tensors[0].shape[-1]
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev} "
                             f"(CUDA), got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous "
                             f"[BH, S, D], got shape {tuple(t.shape)}")
        if t.shape[-1] != d:
            raise ValueError(f"{name}: head dims differ")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")


def _check_stats(name, bh, sq, *stats):
    for t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != (bh, sq, 1)
                or not t.is_contiguous() or t.device.type != "cuda"):
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 "
                             f"[{bh}, {sq}, 1] on CUDA")


def _qscale(scale: float) -> float:
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def _f32_out(name, out_dtype) -> bool:
    """Whether ``out_dtype`` asks for the fp32-output form: None and
    bfloat16 give the bf16 form, float32 the fp32 form; no other output
    type is built."""
    if out_dtype in (None, torch.bfloat16):
        return False
    if out_dtype == torch.float32:
        return True
    raise TypeError(f"{name}: the kernel writes bfloat16 or float32, got "
                    f"out_dtype {out_dtype}")


def flash_fwd_cuda(qb, kb, vb, scale: float, causal: bool, out_dtype=None):
    """K1: (o, lse) from the forward kernel; o in fp32 when ``out_dtype``
    is fp32."""
    global flash_fwd_launches, flash_fwd_f32_launches
    _check("flash_fwd", qb, kb, vb)
    f32 = _f32_out("flash_fwd", out_dtype)
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    o = torch.empty_like(qb, dtype=torch.float32 if f32 else qb.dtype)
    lse = torch.empty(bh, sq, 1, dtype=torch.float32, device=qb.device)
    entry = library().hvd_flash_fwd_f32 if f32 else library().hvd_flash_fwd
    err = entry(ptr(qb), ptr(kb), ptr(vb), ptr(o), ptr(lse), bh, sq, sk, d,
                _qscale(scale), int(causal), stream(qb))
    raise_on(err, "flash_fwd_f32" if f32 else "flash_fwd")
    if f32:
        flash_fwd_f32_launches += 1
    else:
        flash_fwd_launches += 1
    return o, lse


def flash_dkv_cuda(qb, kb, vb, do, lse, delta, scale: float, causal: bool,
                   out_dtype=None):
    """K2: (dk, dv) from the key-block backward kernel; fp32 when
    ``out_dtype`` is fp32."""
    global flash_dkv_launches, flash_dkv_f32_launches
    _check("flash_dkv", qb, kb, vb, do)
    f32 = _f32_out("flash_dkv", out_dtype)
    bh, sq, d = qb.shape
    _check_stats("flash_dkv", bh, sq, lse, delta)
    sk = kb.shape[1]
    dk = torch.empty_like(kb, dtype=torch.float32 if f32 else kb.dtype)
    dv = torch.empty_like(vb, dtype=torch.float32 if f32 else vb.dtype)
    entry = library().hvd_flash_dkv_f32 if f32 else library().hvd_flash_dkv
    err = entry(ptr(qb), ptr(kb), ptr(vb), ptr(do), ptr(lse), ptr(delta),
                ptr(dk), ptr(dv), bh, sq, sk, d, _qscale(scale), int(causal),
                stream(qb))
    raise_on(err, "flash_dkv_f32" if f32 else "flash_dkv")
    if f32:
        flash_dkv_f32_launches += 1
    else:
        flash_dkv_launches += 1
    return dk, dv


def flash_dq_cuda(qb, kb, vb, do, lse, delta, scale: float, causal: bool,
                  out_dtype=None):
    """K3: dq from the query-block backward kernel; fp32 when
    ``out_dtype`` is fp32."""
    global flash_dq_launches, flash_dq_f32_launches
    _check("flash_dq", qb, kb, vb, do)
    f32 = _f32_out("flash_dq", out_dtype)
    bh, sq, d = qb.shape
    _check_stats("flash_dq", bh, sq, lse, delta)
    sk = kb.shape[1]
    dq = torch.empty_like(qb, dtype=torch.float32 if f32 else qb.dtype)
    entry = library().hvd_flash_dq_f32 if f32 else library().hvd_flash_dq
    err = entry(ptr(qb), ptr(kb), ptr(vb), ptr(do), ptr(lse), ptr(delta),
                ptr(dq), bh, sq, sk, d, _qscale(scale), float(scale),
                int(causal), stream(qb))
    raise_on(err, "flash_dq_f32" if f32 else "flash_dq")
    if f32:
        flash_dq_f32_launches += 1
    else:
        flash_dq_launches += 1
    return dq


def _flash_fwd(qb, kb, vb, scale, causal, out_dtype=None):
    if qb.device.type == "cpu":
        return flash_fwd_reference(qb, kb, vb, scale, causal, out_dtype)
    return flash_fwd_cuda(qb, kb, vb, scale, causal, out_dtype)


def _flash_bwd(qb, kb, vb, do, lse, delta, scale, causal, out_dtype=None):
    if qb.device.type == "cpu":
        return flash_bwd_reference(qb, kb, vb, do, lse, delta, scale,
                                   causal, out_dtype)
    dk, dv = flash_dkv_cuda(qb, kb, vb, do, lse, delta, scale, causal,
                            out_dtype)
    dq = flash_dq_cuda(qb, kb, vb, do, lse, delta, scale, causal, out_dtype)
    return dq, dk, dv


# --------------------------------------------------------------------------
# Autograd
# --------------------------------------------------------------------------

def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bh(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        b, _, h, _ = q.shape
        qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
        ob, lse = _flash_fwd(qb, kb, vb, scale, causal)
        ctx.save_for_backward(qb, kb, vb, ob, lse)
        ctx.causal, ctx.scale, ctx.bh = causal, scale, (b, h)
        return _from_bh(ob, b, h)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, ob, lse = ctx.saved_tensors
        b, h = ctx.bh
        gb = _to_bh(g.to(qb.dtype))
        # delta = rowsum(dO * O), the softmax-jacobian diagonal term.
        delta = (gb.float() * ob.float()).sum(-1, keepdim=True)
        dq, dk, dv = _flash_bwd(qb, kb, vb, gb, lse, delta, ctx.scale,
                                ctx.causal)
        return (_from_bh(dq, b, h), _from_bh(dk, b, h), _from_bh(dv, b, h),
                None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(scale))
