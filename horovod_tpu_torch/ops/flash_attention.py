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
launch the kernel or raise. Each kernel wrapper counts its launches per
form (:func:`launch_counts`).

The kernels take bf16, fp16 and fp32 operands, as JAX's kernels take the
operands' dtype: bf16 and fp16 on the wgmma bodies of
``csrc/flash_attention.cuh``, fp32 on the SIMT bodies of
``csrc/flash_attention_fp32.cu`` (fp32 products, as JAX's on fp32). Every
head dim runs, as JAX's kernels take any: a multiple of 16 up to 256
(``HEAD_DIMS``) on the kernels as it is, and above 256 a multiple of
``WIDE_CHUNK`` (128) on the ``_wide`` kernels, which take the head dim as
a runtime count of 128-column chunks; any other head dim is zero-padded
to the next of these by :func:`fwd_padded` / :func:`bwd_padded` and the
outputs cut back, which is exact (zero columns add nothing to Q K^T or
dO V^T, and the scale stays the caller's, of the true head dim).

Each kernel and plain version takes ``out_dtype``, as JAX's ``_flash_fwd``
and ``_flash_bwd`` do: None (the operands' dtype) or fp32, which ring
attention asks for so that its merge of n per-block results does not
stack n 16-bit roundings. The plain version casts where JAX's
``_finalize`` casts; on the card fp32 launches each kernel's fp32-output
form. A form's launches count apart: ``flash_{fwd,dkv,dq}`` plus its
suffix in ``FORMS`` (``_f32``: bf16 operands, fp32 outputs; ``_f16``,
``_f16_f32``: fp16 operands; ``_fp32``: fp32 operands).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import FLASH_FORMS as FORMS
from ._build import library, ptr, raise_on, stream

NEG_INF = -1e30

# The head dims the templated kernels take as they are (BuiltHeadDims in
# csrc/flash_attention.cuh); above the last, the _wide kernels take
# multiples of WIDE_CHUNK. Others are padded.
HEAD_DIMS = tuple(range(16, 257, 16))
WIDE_CHUNK = 128

# Each operand dtype's forms: (its own output dtype, fp32 outputs).
_DTYPE_FORMS = {torch.bfloat16: ("", "_f32"),
                torch.float16: ("_f16", "_f16_f32"),
                torch.float32: ("_fp32", "_fp32")}

# Each form's launches, the _wide kernels (head dims above HEAD_DIMS[-1])
# under their own "_wide" keys.
_launches = {f"flash_{k}{form}{wide}": 0 for form in FORMS
             for k in ("fwd", "dkv", "dq") for wide in ("", "_wide")}


def launch_counts() -> dict:
    """Launches of each kernel form since the last reset; a ``_wide``
    key counts that form's kernels above head dim ``HEAD_DIMS[-1]``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


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

def padded_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the next multiple of 16 up
    to ``HEAD_DIMS[-1]``, above it the next multiple of ``WIDE_CHUNK``.
    Raises ``ValueError`` for ``d <= 0``."""
    if d <= 0:
        raise ValueError(f"flash attention: head_dim must be positive, "
                         f"got {d}")
    step = 16 if d <= HEAD_DIMS[-1] else WIDE_CHUNK
    return -(-d // step) * step


def _pad(t: torch.Tensor, width: int) -> torch.Tensor:
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


def fwd_padded(fwd, qb, kb, vb, *args):
    """``fwd(qb, kb, vb, *args)`` -> (o, lse) with the head dim zero-padded
    to :func:`padded_head_dim` and o cut back to it."""
    d = qb.shape[-1]
    width = padded_head_dim(d)
    if width == d:
        return fwd(qb, kb, vb, *args)
    o, lse = fwd(_pad(qb, width), _pad(kb, width), _pad(vb, width), *args)
    return o[..., :d].contiguous(), lse


def bwd_padded(bwd, qb, kb, vb, do, *args):
    """``bwd(qb, kb, vb, do, *args)`` (a tensor or a tuple of them) with
    the head dim zero-padded as :func:`fwd_padded` does, each output cut
    back."""
    d = qb.shape[-1]
    width = padded_head_dim(d)
    if width == d:
        return bwd(qb, kb, vb, do, *args)
    outs = bwd(_pad(qb, width), _pad(kb, width), _pad(vb, width),
               _pad(do, width), *args)
    if isinstance(outs, torch.Tensor):
        return outs[..., :d].contiguous()
    return tuple(o[..., :d].contiguous() for o in outs)


def _check(name, *tensors):
    d = tensors[0].shape[-1]
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev} "
                             f"(CUDA), got {t.device}")
        if t.dtype not in _DTYPE_FORMS or t.dtype != dtype:
            raise TypeError(f"{name}: the kernels take bfloat16, float16 "
                            f"or float32 operands of one dtype, got "
                            f"{t.dtype} with {dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous "
                             f"[BH, S, D], got shape {tuple(t.shape)}")
        if t.shape[-1] != d:
            raise ValueError(f"{name}: head dims differ")
    padded_head_dim(d)


def _check_stats(name, bh, sq, *stats):
    for t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != (bh, sq, 1)
                or not t.is_contiguous() or t.device.type != "cuda"):
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 "
                             f"[{bh}, {sq}, 1] on CUDA")


def _qscale(scale: float, dtype: torch.dtype = torch.bfloat16) -> float:
    """The scale rounded to the operands' dtype, as JAX's weak-typed
    ``q_ref[0] * scale`` rounds it."""
    return float(torch.tensor(scale, dtype=dtype))


def _form(name, dtype, out_dtype) -> str:
    """The entry-point suffix of the form for ``dtype`` operands and
    ``out_dtype`` outputs: None or the operands' dtype, or float32; no
    other output type is built."""
    own, f32 = _DTYPE_FORMS[dtype]
    if out_dtype in (None, dtype):
        return own
    if out_dtype == torch.float32:
        return f32
    raise TypeError(f"{name}: the kernel writes {dtype} or float32, got "
                    f"out_dtype {out_dtype}")


def _out(like: torch.Tensor, form: str) -> torch.Tensor:
    f32 = form in ("_f32", "_f16_f32", "_fp32")
    return torch.empty_like(like, dtype=torch.float32 if f32 else like.dtype)


def _launch(name: str, d: int, *args) -> None:
    """Calls entry point ``hvd_<name>`` (which picks the _wide kernels
    above ``HEAD_DIMS[-1]``) and counts the launch under the kernel's
    key."""
    err = getattr(library(), f"hvd_{name}")(*args)
    raise_on(err, name)
    _launches[name + ("_wide" if d > HEAD_DIMS[-1] else "")] += 1


def _fwd_kernel(qb, kb, vb, scale, causal, form):
    bh, sq, d = qb.shape
    o = _out(qb, form)
    lse = torch.empty(bh, sq, 1, dtype=torch.float32, device=qb.device)
    _launch("flash_fwd" + form, d, ptr(qb), ptr(kb), ptr(vb), ptr(o),
            ptr(lse), bh, sq, kb.shape[1], d, _qscale(scale, qb.dtype),
            int(causal), stream(qb))
    return o, lse


def _dkv_kernel(qb, kb, vb, do, lse, delta, scale, causal, form):
    bh, sq, d = qb.shape
    dk, dv = _out(kb, form), _out(vb, form)
    _launch("flash_dkv" + form, d, ptr(qb), ptr(kb), ptr(vb), ptr(do),
            ptr(lse), ptr(delta), ptr(dk), ptr(dv), bh, sq, kb.shape[1], d,
            _qscale(scale, qb.dtype), int(causal), stream(qb))
    return dk, dv


def _dq_kernel(qb, kb, vb, do, lse, delta, scale, causal, form):
    bh, sq, d = qb.shape
    dq = _out(qb, form)
    _launch("flash_dq" + form, d, ptr(qb), ptr(kb), ptr(vb), ptr(do),
            ptr(lse), ptr(delta), ptr(dq), bh, sq, kb.shape[1], d,
            _qscale(scale, qb.dtype), float(scale), int(causal), stream(qb))
    return dq


def flash_fwd_cuda(qb, kb, vb, scale: float, causal: bool, out_dtype=None):
    """K1: (o, lse) from the forward kernel of the operands' dtype; o in
    fp32 when ``out_dtype`` is fp32."""
    _check("flash_fwd", qb, kb, vb)
    form = _form("flash_fwd", qb.dtype, out_dtype)
    return fwd_padded(_fwd_kernel, qb, kb, vb, scale, causal, form)


def flash_dkv_cuda(qb, kb, vb, do, lse, delta, scale: float, causal: bool,
                   out_dtype=None):
    """K2: (dk, dv) from the key-block backward kernel; fp32 when
    ``out_dtype`` is fp32."""
    _check("flash_dkv", qb, kb, vb, do)
    form = _form("flash_dkv", qb.dtype, out_dtype)
    _check_stats("flash_dkv", qb.shape[0], qb.shape[1], lse, delta)
    return bwd_padded(_dkv_kernel, qb, kb, vb, do, lse, delta, scale,
                      causal, form)


def flash_dq_cuda(qb, kb, vb, do, lse, delta, scale: float, causal: bool,
                  out_dtype=None):
    """K3: dq from the query-block backward kernel; fp32 when
    ``out_dtype`` is fp32."""
    _check("flash_dq", qb, kb, vb, do)
    form = _form("flash_dq", qb.dtype, out_dtype)
    _check_stats("flash_dq", qb.shape[0], qb.shape[1], lse, delta)
    return bwd_padded(_dq_kernel, qb, kb, vb, do, lse, delta, scale, causal,
                      form)


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


# Model-FLOP counting (``observability.step_metrics.flops_of_step``):
# torch's FlopCounterMode sees aten ops only, not the kernels, so while a
# counter is active the flash op adds its work by torch's own SDPA
# formulas (the full S x S products, as the plain attention's batched
# matmuls count) and hides its inner ops from the counter. torch's
# backward formula also counts the scores' recompute (Q K^T again), work
# a flash backward does but the model does not: it is left out, so a
# step counts what the same step through the plain attention counts.
FLOP_COUNTERS: list = []


def _count_flops(backward: bool, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor):
    """Add one flash call's FLOPs (``q``, ``k``, ``v`` in ``[b, s, h,
    d]``) to every active counter; returns the context that hides the
    call's own ops from them."""
    from torch.utils import flop_counter as _fc
    from torch.utils._python_dispatch import _disable_current_modes
    b, sq, h, d = q.shape
    qs, ks, vs = (b, h, sq, d), (b, h, k.shape[1], d), \
        (b, h, v.shape[1], v.shape[3])
    if backward:
        key = torch.ops.aten._scaled_dot_product_flash_attention_backward
        n = (_fc.sdpa_backward_flop_count(qs, qs, ks, vs)
             - 2 * b * h * sq * k.shape[1] * d)     # the recompute
    else:
        key = torch.ops.aten._scaled_dot_product_flash_attention
        n = _fc.sdpa_flop_count(qs, ks, vs)
    for mode in FLOP_COUNTERS:
        tracker = getattr(mode, "mod_tracker", None)
        for par in set(getattr(tracker, "parents", None) or ("Global",)):
            mode.flop_counts[par][key] += n
    return _disable_current_modes()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        with (_count_flops(False, q, k, v) if FLOP_COUNTERS
              else contextlib.nullcontext()):
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
        with (_count_flops(True, _from_bh(qb, b, h), _from_bh(kb, b, h),
                           _from_bh(vb, b, h)) if FLOP_COUNTERS
              else contextlib.nullcontext()):
            gb = _to_bh(g.to(qb.dtype))
            # delta = rowsum(dO * O), the softmax-jacobian diagonal term.
            delta = (gb.float() * ob.float()).sum(-1, keepdim=True)
            dq, dk, dv = _flash_bwd(qb, kb, vb, gb, lse, delta, ctx.scale,
                                    ctx.causal)
            out = (_from_bh(dq, b, h), _from_bh(dk, b, h),
                   _from_bh(dv, b, h))
        return out + (None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(scale))
