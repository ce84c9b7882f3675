"""Measurement scripts of the port, each run on one CUDA card:

    python -m horovod_tpu_torch.experiments.shape_probe          # P1
    python -m horovod_tpu_torch.experiments.mem_probe            # P2
    python -m horovod_tpu_torch.experiments.flash_ablate_probe   # P3

They are the counterparts of the Pallas probes under ``experiments/`` and
run the probe kernels of ``horovod_tpu_torch.ops.probes``. Times are
CUDA events around many back-to-back launches after a warm-up
(``time_ms``; ``single_ms`` times single calls instead); bounds
use the published peaks of an H100 SXM below, and each script prints the
card's ``nvidia-smi`` name and power limit first. Without a card they
exit with an error: a measurement never falls back to the CPU.

The ``check_*`` functions hold a probe kernel to its plain version on
the card and raise past the tolerance: copy and +1 exact; stats-like
within 1e-4 of sum |terms| per channel, two calls bit-identical; the
flash ablation's stream within 1 bf16 ulp (the same fp32 adds in the
same order), matmul and nosoft within 1e-2 of max |plain| (fp32 sums in
another order, then one bf16 rounding).
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from ..ops import probes

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32, outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
REL_TOL = 1e-2                # matmul / nosoft: max |diff| / max |plain|
SUM_TOL = 1e-4                # stats-like: |diff| / sum |terms|
TARGET_MS = 50.0              # time_ms: launches per timing fill this


def require_cuda(name: str) -> None:
    if not torch.cuda.is_available():
        sys.exit(f"{name}: CUDA is not available; this probe measures the "
                 "card and has no CPU fallback")


def device_line() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean ms per call of ``fn`` over back-to-back launches between two
    CUDA events, after two warm-up calls: at least 3 calls, and as many
    as fill about ``TARGET_MS``."""
    fn()
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    n = int(min(1000, max(3, TARGET_MS / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def single_ms(fn, iters=10, warmup=2) -> float:
    """Median over ``iters`` single calls of ``fn``, each between two
    CUDA events (so each carries its launch gap), after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of the fp32 tensor ``x``."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_copy(x2, bm) -> float:
    if not torch.equal(probes.copy_cuda(x2, bm), x2):
        raise AssertionError(f"probe copy {tuple(x2.shape)} bm={bm}: not x")
    return 0.0


def check_addone(x2, bm) -> float:
    if not torch.equal(probes.addone_cuda(x2, bm),
                       probes.addone_reference(x2)):
        raise AssertionError(f"probe addone {tuple(x2.shape)} bm={bm}: not "
                             "x + 1")
    return 0.0


def check_stats_like(x2, bm) -> float:
    """Returns the max abs error against the plain version."""
    got, again = probes.stats_like_cuda(x2, bm), probes.stats_like_cuda(x2,
                                                                        bm)
    want = probes.stats_like_reference(x2, bm)
    xf = x2.float()
    mag = (xf.abs() + xf * xf).sum(0, keepdim=True).clamp_min(1e-30)
    err = float(((got - want).abs() / mag).max())
    if not (err <= SUM_TOL and torch.equal(got, again)):
        raise AssertionError(
            f"probe stats-like {tuple(x2.shape)} bm={bm}: {err} of sum "
            f"|terms| (tolerance {SUM_TOL}), repeat bit-identical "
            f"{torch.equal(got, again)}")
    return float((got - want).abs().max())


def check_ablate(q, k, v, mode, causal, tile):
    """Returns (max abs error, error in the tolerance's unit: ulps for
    stream, max |diff| / max |plain| otherwise)."""
    got = probes.ablate_cuda(q, k, v, mode, causal, tile, tile).float()
    want = probes.ablate_reference(q, k, v, mode, causal, tile,
                                   tile).float()
    diff = (got - want).abs()
    if mode == "stream":
        err, tol = float((diff / bf16_ulp(want)).max()), 1.0
    else:
        err = float(diff.max() / want.abs().max().clamp_min(1e-30))
        tol = REL_TOL
    if not err <= tol:
        raise AssertionError(
            f"flash_ablate {mode} {tuple(q.shape)} causal={causal} "
            f"tile={tile}: {err} > {tol}")
    return float(diff.max()), err
