"""Measurement probes of the port: hand-written CUDA kernels for Hopper
(``csrc/probes.cu``, ``csrc/flash_ablate.cu``) and their plain PyTorch
versions.

Counterparts of the three Pallas probes under ``experiments/``:

- P1, ``pallas_shape_probe.py::make_copy``: ``tile_copy`` copies a
  row-major ``[M, C]`` matrix one ``(bm, C)`` row tile per CTA;
- P2, ``pallas_mem_probe.py::make_pallas_map``: ``tile_copy`` (its
  ``copy_kernel``), ``tile_addone`` (``addone_kernel``, y = x + 1 in
  bf16) and ``stats_like`` (``stats_like_kernel``: one fp32 ``[1, C]``
  vector, sum(x) + sum(x^2) over the rows, accumulated tile by tile);
- P3, ``flash_ablate_probe.py::variant_kernel``: ``flash_ablate``, the
  flash forward's grid and loop with its body cut to ``stream`` (acc +=
  (q + k) + v), ``matmul`` (acc += bf16(q k^T) v) or ``nosoft`` (acc =
  acc * 0.5 + bf16(q k^T - rowmax) v, the max over this key tile alone),
  causal skipping whole key tiles (tile kj is processed when
  ``kj*block_k <= (qi+1)*block_q - 1``) and masking nothing inside one;
  the output is bf16(acc). Its ``full`` variant is the flash forward
  kernel itself (``flash_attention.flash_fwd_cuda``).

Dispatch is by device: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise. Every entry point refuses what the probes
never run: a row count that is not a multiple of ``bm``, a sequence that
is not a multiple of the tile, and ``stream`` with ``block_q !=
block_k``. Each kernel wrapper counts its launches (``launch_counts``).
"""

from __future__ import annotations

import torch

from ._build import library, ptr, raise_on, stream

MODES = ("stream", "matmul", "nosoft")
CUDA_TILES = (64, 128)     # square tiles of the ablation kernel
_HEAD_DIMS = (64, 128)

_launches = {"probe_copy": 0, "probe_addone": 0, "probe_stats_like": 0,
             **{f"flash_ablate_{m}": 0 for m in MODES}}


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def copy_reference(x2: torch.Tensor) -> torch.Tensor:
    """P1 / P2 copy: y = x."""
    return x2.clone()


def addone_reference(x2: torch.Tensor) -> torch.Tensor:
    """P2 addone: y = x + 1, added in fp32 and rounded to x's dtype, as a
    bf16 add is."""
    return (x2.float() + 1.0).to(x2.dtype)


def stats_like_reference(x2: torch.Tensor, bm: int) -> torch.Tensor:
    """P2 stats-like: fp32 ``[1, C]``, sum(x) + sum(x^2) of each bm-row
    tile, summed over the tiles."""
    m, c = x2.shape
    xf = x2.float().view(m // bm, bm, c)
    return (xf.sum(1) + (xf * xf).sum(1)).sum(0, keepdim=True)


def ablate_reference(q, k, v, mode: str, causal: bool, block_q: int,
                     block_k: int) -> torch.Tensor:
    """P3: the ablated flash forward over ``[BH, S, D]``, tile by tile in
    the kernel's order; o in q's dtype."""
    bh, s, d = q.shape
    nq, nk = s // block_q, s // block_k
    qt = q.float().view(bh, nq, block_q, d)
    qi = torch.arange(nq, device=q.device).view(1, nq, 1, 1)
    acc = torch.zeros(bh, nq, block_q, d, dtype=torch.float32,
                      device=q.device)
    for kj in range(nk):
        kt = k[:, kj * block_k:(kj + 1) * block_k].float().unsqueeze(1)
        vt = v[:, kj * block_k:(kj + 1) * block_k].float().unsqueeze(1)
        if mode == "stream":
            upd = acc + ((qt + kt) + vt)
        else:
            sc = qt @ kt.transpose(-1, -2)
            if mode == "matmul":
                upd = acc + sc.to(v.dtype).float() @ vt
            else:
                p = (sc - sc.amax(-1, keepdim=True)).to(v.dtype).float()
                upd = acc * 0.5 + p @ vt
        if causal:
            upd = torch.where(kj * block_k <= (qi + 1) * block_q - 1, upd,
                              acc)
        acc = upd
    return acc.view(bh, s, d).to(q.dtype)


# --------------------------------------------------------------------------
# Argument checks (every device) and kernel wrappers
# --------------------------------------------------------------------------

def _check_rows(name, x2, bm):
    if x2.dim() != 2 or x2.shape[0] < 1 or x2.shape[1] < 1:
        raise ValueError(f"{name}: x must be a non-empty [M, C] matrix, got "
                         f"shape {tuple(x2.shape)}")
    if bm < 1 or x2.shape[0] % bm != 0:
        raise ValueError(f"{name}: the row tile bm={bm} must divide "
                         f"M={x2.shape[0]} (the probes run no ragged tile)")


def _check_ablate(q, k, v, mode, block_q, block_k):
    if mode not in MODES:
        raise ValueError(f"flash_ablate: mode must be one of {MODES}, got "
                         f"{mode!r}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_ablate: q, k, v must be [BH, S, D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s = q.shape[1]
    if block_q < 1 or block_k < 1 or s % block_q or s % block_k:
        raise ValueError(f"flash_ablate: S={s} must be a multiple of the "
                         f"tile ({block_q}, {block_k}); the probe runs no "
                         "ragged tile")
    if mode == "stream" and block_q != block_k:
        raise ValueError("flash_ablate: stream adds q, k and v tiles "
                         f"elementwise and needs block_q == block_k, got "
                         f"({block_q}, {block_k})")


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")


def _map_cuda(name, x2, bm, addone):
    _check_rows(name, x2, bm)
    _check_cuda(name, x2)
    m, c = x2.shape
    if c % 8:
        raise ValueError(f"{name}: C={c} must be a multiple of 8 (16-byte "
                         "accesses)")
    y = torch.empty_like(x2)
    err = library().hvd_probe_map(ptr(x2), ptr(y), m, c, bm, int(addone),
                                  stream(x2))
    raise_on(err, name)
    _launches[name] += 1
    return y


def copy_cuda(x2: torch.Tensor, bm: int) -> torch.Tensor:
    """P1 / P2 copy kernel, one CTA per (bm, C) row tile."""
    return _map_cuda("probe_copy", x2, bm, False)


def addone_cuda(x2: torch.Tensor, bm: int) -> torch.Tensor:
    """P2 addone kernel: y = bf16(x + 1)."""
    return _map_cuda("probe_addone", x2, bm, True)


def stats_like_cuda(x2: torch.Tensor, bm: int) -> torch.Tensor:
    """P2 stats-like kernel and its fixed-order finalize: fp32 [1, C]."""
    _check_rows("probe_stats_like", x2, bm)
    _check_cuda("probe_stats_like", x2)
    m, c = x2.shape
    if c % 8 or m // bm > 65535:
        raise ValueError(f"probe_stats_like: needs C % 8 == 0 and at most "
                         f"65535 row tiles, got C={c}, M/bm={m // bm}")
    part = torch.empty(m // bm, c, dtype=torch.float32, device=x2.device)
    out = torch.empty(1, c, dtype=torch.float32, device=x2.device)
    err = library().hvd_probe_stats_like(ptr(x2), ptr(part), ptr(out), m, c,
                                         bm, stream(x2))
    raise_on(err, "probe_stats_like")
    _launches["probe_stats_like"] += 1
    return out


def ablate_cuda(q, k, v, mode: str, causal: bool, block_q: int,
                block_k: int) -> torch.Tensor:
    """P3 kernel: the ablated flash forward, o bf16 [BH, S, D]."""
    _check_ablate(q, k, v, mode, block_q, block_k)
    _check_cuda("flash_ablate", q, k, v)
    bh, s, d = q.shape
    if block_q != block_k or block_q not in CUDA_TILES or d not in _HEAD_DIMS:
        raise ValueError(f"flash_ablate: the kernel takes square tiles of "
                         f"{CUDA_TILES} and head_dim {_HEAD_DIMS}, got "
                         f"({block_q}, {block_k}), D={d}")
    o = torch.empty_like(q)
    err = library().hvd_flash_ablate(ptr(q), ptr(k), ptr(v), ptr(o), bh, s, d,
                                     block_q, MODES.index(mode), int(causal),
                                     stream(q))
    raise_on(err, "flash_ablate")
    _launches[f"flash_ablate_{mode}"] += 1
    return o


# --------------------------------------------------------------------------
# Entry points: the plain version on CPU tensors, the kernel on CUDA ones
# --------------------------------------------------------------------------

def tile_copy(x2: torch.Tensor, bm: int) -> torch.Tensor:
    if x2.device.type == "cpu":
        _check_rows("probe_copy", x2, bm)
        return copy_reference(x2)
    return copy_cuda(x2, bm)


def tile_addone(x2: torch.Tensor, bm: int) -> torch.Tensor:
    if x2.device.type == "cpu":
        _check_rows("probe_addone", x2, bm)
        return addone_reference(x2)
    return addone_cuda(x2, bm)


def stats_like(x2: torch.Tensor, bm: int) -> torch.Tensor:
    if x2.device.type == "cpu":
        _check_rows("probe_stats_like", x2, bm)
        return stats_like_reference(x2, bm)
    return stats_like_cuda(x2, bm)


def flash_ablate(q, k, v, mode: str, causal: bool, block_q: int = 64,
                 block_k: int = 64) -> torch.Tensor:
    if q.device.type == "cpu":
        _check_ablate(q, k, v, mode, block_q, block_k)
        return ablate_reference(q, k, v, mode, causal, block_q, block_k)
    return ablate_cuda(q, k, v, mode, causal, block_q, block_k)
