"""Fused batch-norm(+residual)(+ReLU) for the port: four hand-written
CUDA kernels for Hopper (``csrc/fused_bn.cu``) behind a
``torch.autograd.Function``, and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/fused_bn.py``, with the same pass
structure (the arithmetic minimum, bf16 read and cast to fp32 in
registers)::

  forward:  stats     reads x          -> per-channel fp32 sum(x), sum(x^2)
            norm      reads x [, r]    -> y = [relu](x*scale + shift [+ r])
  backward: reduce    reads x, da [, r] -> s1 = sum(dy), s2 = sum(dy * x_hat)
            dx        reads x, da [, r] -> dx [, dr = dy]

where ``dy = da * [z > 0]`` under ReLU, the mask recomputed from x (and
r) rather than read back, ``x_hat = (x - mean) * rstd`` and
``dx = scale * (dy - s1/m - x_hat * s2/m)``. The per-channel math
(``mean = s1/m``, ``var = s2/m - mean^2`` with no clamp, ``rstd``,
``scale = gamma * rstd``, ``shift = beta - mean * scale``) stays in
PyTorch on ``[C]`` fp32 vectors, as the JAX op computes it outside its
kernels. The kernels take ``[M, C]`` row-major operands (``M = N*H*W``,
channels last) of any M and C; the TPU's lane fold has no counterpart.

``impl``: ``"pallas"`` runs the kernels on CUDA tensors (never a plain
fallback) and their plain versions on CPU tensors; ``"jnp"``,
``"interpret"`` and ``"auto"`` run the plain versions on any device
(``"auto"`` is ``"jnp"``, as in the JAX package). Each kernel wrapper
counts its launches in ``bn_stats_launches`` / ``bn_norm_launches`` /
``bn_bwd_reduce_launches`` / ``bn_bwd_dx_launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library, ptr, raise_on, stream

IMPLS = ("auto", "jnp", "pallas", "interpret")

bn_stats_launches = 0
bn_norm_launches = 0
bn_bwd_reduce_launches = 0
bn_bwd_dx_launches = 0

# Block geometry of the kernels: _TX threads across a channel tile, each
# owning `vec` adjacent channels, times _TY rows.
_TX, _TY = 8, 32
# Resident blocks per SM the grid aims to fill with one wave.
_BLOCKS_PER_SM = 8
_sm_count: dict = {}


def launch_counts() -> dict:
    return {"bn_stats": bn_stats_launches, "bn_norm": bn_norm_launches,
            "bn_bwd_reduce": bn_bwd_reduce_launches,
            "bn_bwd_dx": bn_bwd_dx_launches}


def reset_launch_counts() -> None:
    global bn_stats_launches, bn_norm_launches, bn_bwd_reduce_launches, \
        bn_bwd_dx_launches
    bn_stats_launches = bn_norm_launches = 0
    bn_bwd_reduce_launches = bn_bwd_dx_launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions: fp32 math, y/dx in x's dtype, dr in r's dtype
# --------------------------------------------------------------------------

def _pre_relu(xf, r2, scale, shift):
    z = xf * scale + shift
    if r2 is not None:
        z = z + r2.float()
    return z


def stats_reference(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: (sum x, sum x^2) over rows, fp32 [C]."""
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def norm_reference(x2, r2, scale, shift, relu: bool) -> torch.Tensor:
    """K5's plain version: [relu](x*scale + shift [+ r]) in x's dtype."""
    z = _pre_relu(x2.float(), r2, scale, shift)
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x2.dtype)


def _masked_grad(xf, da2, r2, scale, shift, relu):
    daf = da2.float()
    if relu:
        daf = torch.where(_pre_relu(xf, r2, scale, shift) > 0, daf, 0.0)
    return daf


def bwd_reduce_reference(x2, da2, r2, mean, rstd, scale, shift, relu: bool):
    """K6's plain version: (sum dy, sum dy * x_hat), fp32 [C]."""
    xf = x2.float()
    daf = _masked_grad(xf, da2, r2, scale, shift, relu)
    xhat = (xf - mean) * rstd
    return daf.sum(0), (daf * xhat).sum(0)


def bwd_dx_reference(x2, da2, r2, mean, rstd, scale, shift, g1, g2,
                     inv_m: float, relu: bool):
    """K7's plain version: (dx in x's dtype, dr = dy in r's dtype or
    None)."""
    xf = x2.float()
    daf = _masked_grad(xf, da2, r2, scale, shift, relu)
    xhat = (xf - mean) * rstd
    dx = scale * (daf - g1 * inv_m - xhat * (g2 * inv_m))
    dr = daf.to(r2.dtype) if r2 is not None else None
    return dx.to(x2.dtype), dr


# --------------------------------------------------------------------------
# Kernel wrappers (one per kernel)
# --------------------------------------------------------------------------

def _check_rows(name, x2, *others):
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: operands must be on a CUDA device, got "
                         f"{x2.device}")
    if x2.dim() != 2 or x2.shape[0] < 1 or x2.shape[1] < 1:
        raise ValueError(f"{name}: x must be a non-empty [M, C] matrix, got "
                         f"shape {tuple(x2.shape)}")
    for t in (x2,) + others:
        if t is None:
            continue
        if t.device != x2.device:
            raise ValueError(f"{name}: every operand must be on {x2.device}, "
                             f"got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16 [M, C] "
                            f"operands, got {t.dtype}")
        if t.shape != x2.shape or not t.is_contiguous():
            raise ValueError(f"{name}: [M, C] operands must be contiguous "
                             f"{tuple(x2.shape)}, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")


def _check_vecs(name, x2, *vecs):
    c = x2.shape[1]
    for v in vecs:
        if (v.dtype != torch.float32 or tuple(v.shape) != (c,)
                or not v.is_contiguous() or v.device != x2.device):
            raise ValueError(f"{name}: per-channel vectors must be "
                             f"contiguous fp32 [{c}] on {x2.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _vec_width(c: int, *mats) -> int:
    """8 channels per thread (16-byte loads) where C and every [M, C]
    pointer allow it, else 1."""
    ok = c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in mats
                            if t is not None)
    return 8 if ok else 1


def row_chunks(m: int, c: int, vec: int, sms: int) -> int:
    """Row chunks G of the (channel tile x row chunk) grid: enough blocks
    for one full wave on ``sms`` SMs, and no chunk thinner than a block's
    rows. Depends only on the shape and the card, so every call at a
    shape sums in the same order."""
    tiles = -(-c // (_TX * vec))
    want = -(-(_BLOCKS_PER_SM * sms) // tiles)
    return max(1, min(want, -(-m // _TY)))


def _grid(x2, vec):
    dev = x2.device.index if x2.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    m, c = x2.shape
    return row_chunks(m, c, vec, _sm_count[dev])


def stats_cuda(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (sum x, sum x^2) from the stats kernel and its fixed-order
    finalize."""
    global bn_stats_launches
    _check_rows("bn_stats", x2)
    m, c = x2.shape
    vec = _vec_width(c, x2)
    g = _grid(x2, vec)
    part = torch.empty(2, g, c, dtype=torch.float32, device=x2.device)
    s = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    err = library().hvd_bn_stats(ptr(x2), ptr(part), ptr(s), m, c, g, vec,
                                 stream(x2))
    raise_on(err, "bn_stats")
    bn_stats_launches += 1
    return s[0], s[1]


def norm_cuda(x2, r2, scale, shift, relu: bool) -> torch.Tensor:
    """K5: y = [relu](x*scale + shift [+ r]) in bf16."""
    global bn_norm_launches
    _check_rows("bn_norm", x2, r2)
    _check_vecs("bn_norm", x2, scale, shift)
    m, c = x2.shape
    vec = _vec_width(c, x2, r2)
    y = torch.empty_like(x2)
    err = library().hvd_bn_norm(ptr(x2), ptr(r2), ptr(scale), ptr(shift),
                                ptr(y), m, c, _grid(x2, vec), int(relu), vec,
                                stream(x2))
    raise_on(err, "bn_norm")
    bn_norm_launches += 1
    return y


def bwd_reduce_cuda(x2, da2, r2, mean, rstd, scale, shift, relu: bool):
    """K6: (sum dy, sum dy * x_hat) with the ReLU mask recomputed."""
    global bn_bwd_reduce_launches
    _check_rows("bn_bwd_reduce", x2, da2, r2)
    _check_vecs("bn_bwd_reduce", x2, mean, rstd, scale, shift)
    m, c = x2.shape
    vec = _vec_width(c, x2, da2, r2)
    g = _grid(x2, vec)
    part = torch.empty(2, g, c, dtype=torch.float32, device=x2.device)
    s = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    err = library().hvd_bn_bwd_reduce(
        ptr(x2), ptr(da2), ptr(r2), ptr(mean), ptr(rstd), ptr(scale),
        ptr(shift), ptr(part), ptr(s), m, c, g, int(relu), vec,
        stream(x2))
    raise_on(err, "bn_bwd_reduce")
    bn_bwd_reduce_launches += 1
    return s[0], s[1]


def bwd_dx_cuda(x2, da2, r2, mean, rstd, scale, shift, g1, g2,
                inv_m: float, relu: bool):
    """K7: (dx, dr = dy or None) in bf16."""
    global bn_bwd_dx_launches
    _check_rows("bn_bwd_dx", x2, da2, r2)
    _check_vecs("bn_bwd_dx", x2, mean, rstd, scale, shift, g1, g2)
    m, c = x2.shape
    vec = _vec_width(c, x2, da2, r2)
    dx = torch.empty_like(x2)
    dr = torch.empty_like(r2) if r2 is not None else None
    err = library().hvd_bn_bwd_dx(
        ptr(x2), ptr(da2), ptr(r2), ptr(mean), ptr(rstd), ptr(scale),
        ptr(shift), ptr(g1), ptr(g2), float(inv_m), ptr(dx), ptr(dr), m,
        c, _grid(x2, vec), int(relu), vec, stream(x2))
    raise_on(err, "bn_bwd_dx")
    bn_bwd_dx_launches += 1
    return dx, dr


def _stats(x2, kernel):
    if kernel and x2.device.type != "cpu":
        return stats_cuda(x2)
    return stats_reference(x2)


def _norm(x2, r2, scale, shift, relu, kernel):
    if kernel and x2.device.type != "cpu":
        return norm_cuda(x2, r2, scale, shift, relu)
    return norm_reference(x2, r2, scale, shift, relu)


def _bwd_reduce(x2, da2, r2, mean, rstd, scale, shift, relu, kernel):
    if kernel and x2.device.type != "cpu":
        return bwd_reduce_cuda(x2, da2, r2, mean, rstd, scale, shift, relu)
    return bwd_reduce_reference(x2, da2, r2, mean, rstd, scale, shift, relu)


def _bwd_dx(x2, da2, r2, mean, rstd, scale, shift, g1, g2, inv_m, relu,
            kernel):
    if kernel and x2.device.type != "cpu":
        return bwd_dx_cuda(x2, da2, r2, mean, rstd, scale, shift, g1, g2,
                           inv_m, relu)
    return bwd_dx_reference(x2, da2, r2, mean, rstd, scale, shift, g1, g2,
                            inv_m, relu)


# --------------------------------------------------------------------------
# Autograd
# --------------------------------------------------------------------------

def _rows(t: torch.Tensor, c: int, kernel: bool) -> torch.Tensor:
    """The [M, C] view of ``t``. The kernel path takes only operands that
    already are contiguous over [..., C]: it never copies one silently."""
    if kernel and not t.is_contiguous():
        raise ValueError(
            "bn_act: the kernels take x and residual contiguous over "
            f"[..., C] (channels last); got shape {tuple(t.shape)} strides "
            f"{t.stride()}")
    return t.reshape(-1, c)


class _BNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps: float, relu: bool,
                kernel: bool):
        c = x.shape[-1]
        x2 = _rows(x, c, kernel)
        r2 = _rows(r, c, kernel) if r is not None else None
        m = x2.shape[0]
        s1, s2 = _stats(x2, kernel)
        mean = s1 / m
        var = s2 / m - mean * mean
        rstd = torch.rsqrt(var + eps)
        gf, bf = gamma.float(), beta.float()
        scale = gf * rstd
        shift = bf - mean * scale
        y2 = _norm(x2, r2, scale, shift, relu, kernel)
        ctx.save_for_backward(x, r, mean, rstd, gf, bf)
        ctx.relu, ctx.kernel = relu, kernel
        ctx.mark_non_differentiable(mean, var)
        return y2.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        # The stats feed only the running-average update, so their
        # cotangents are structurally zero, as in the JAX op.
        x, r, mean, rstd, gf, bf = ctx.saved_tensors
        relu, kernel = ctx.relu, ctx.kernel
        c = x.shape[-1]
        if kernel:
            # A copy only where the incoming gradient is not already
            # contiguous [..., C]: in the ResNet, the mean-pool's expanded
            # gradient into the last bn3.
            gy = gy.contiguous()
        x2 = _rows(x, c, kernel)
        da2 = _rows(gy, c, kernel)
        r2 = _rows(r, c, kernel) if r is not None else None
        m = x2.shape[0]
        scale = gf * rstd
        shift = bf - mean * scale
        s1, s2 = _bwd_reduce(x2, da2, r2, mean, rstd, scale, shift, relu,
                             kernel)
        dx2, dr2 = _bwd_dx(x2, da2, r2, mean, rstd, scale, shift, s1, s2,
                           1.0 / float(m), relu, kernel)
        dr = dr2.view(r.shape) if r is not None else None
        return dx2.view(x.shape), dr, s2, s1, None, None, None


def bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
           residual: Optional[torch.Tensor] = None, eps: float = 1e-5,
           relu: bool = True, impl: str = "auto"):
    """Train-mode fused batch-norm(+residual)(+ReLU) over the last axis.

    Returns ``(y, batch_mean, batch_var)``: y in x's dtype, the stats fp32
    biased moments for the caller's running-average update (not
    differentiable). ``residual`` is added after normalisation, before
    the ReLU (the ResNet v1.5 bottleneck join). Gradients: x, residual,
    gamma (``sum dy * x_hat``) and beta (``sum dy``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown bn_act impl {impl!r}; expected "
                         "'auto', 'jnp', 'pallas' or 'interpret'")
    return _BNAct.apply(x, residual, gamma, beta, float(eps), bool(relu),
                        impl == "pallas")


def bn_act_inference(x, gamma, beta, running_mean, running_var, *,
                     residual=None, eps: float = 1e-5, relu: bool = True):
    """Eval-mode normalize with running stats, plain PyTorch (one
    elementwise chain; no reduction pass exists)."""
    rstd = torch.rsqrt(running_var.float() + eps)
    scale = gamma.float() * rstd
    shift = beta.float() - running_mean.float() * scale
    z = x.float() * scale + shift
    if residual is not None:
        z = z + residual.float()
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype)
