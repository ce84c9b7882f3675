"""Measurement scripts of the port, each run on one CUDA card:

    python -m horovod_tpu_torch.experiments.shape_probe          # P1
    python -m horovod_tpu_torch.experiments.mem_probe            # P2
    python -m horovod_tpu_torch.experiments.flash_ablate_probe   # P3

``probe_turns --other TREE`` runs P1 and P2 of this checkout and another
in turns; ``probe_split`` times the copy and +1 kernel's variants. The
probes are the counterparts of the Pallas probes under ``experiments/`` and
run the probe kernels of ``horovod_tpu_torch.ops.probes``. Times are
CUDA events around many back-to-back launches after a warm-up
(``time_ms``; ``single_ms`` times single calls instead); bounds
use the published peaks of an H100 SXM below, and each script prints the
card's ``nvidia-smi`` name and power limit first. Without a card they
exit with an error: a measurement never falls back to the CPU.

The ``check_*`` functions hold a probe kernel to its plain version on
the card and raise past the tolerance: copy bit for bit and +1 to the
plain version's bits (a NaN in gives a NaN out), both compared through
``int16`` views (``special_bf16`` makes inputs with every special
value); stats-like within 1e-4 of sum |terms| per channel, two calls
bit-identical; the flash ablation's stream within 1 bf16 ulp (the same
fp32 adds in the same order), matmul and nosoft within 1e-2 of max
|plain| (fp32 sums in another order, then one bf16 rounding).
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from ..ops import probes

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32, outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12    # H100 SXM dense TF32 (a 3xTF32 product: a third)
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


# bf16 bit patterns the map probes must carry: +-0, +-inf, NaNs with
# payloads (quiet and signalling, both signs), subnormals, the smallest
# normal, +-bf16 max, +-1, and values whose +1 is a tie (2^-8) or just
# past one.
SPECIAL_BF16 = (0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7F81,
                0xFFA5, 0x7FFF, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080,
                0x7F7F, 0xFF7F, 0x3F80, 0xBF80, 0x3B80, 0xBB80, 0x3B81,
                0x3C00)


def special_bf16(m: int, c: int, seed: int = 0,
                 device="cpu") -> torch.Tensor:
    """[m, c] bf16 of N(0, 8) values with the SPECIAL_BF16 patterns at a
    seeded random half of the places; the first len(SPECIAL_BF16) places
    hold each pattern once. Drawn on the CPU, so every device gets the
    same bits."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(m * c, generator=gen) * 8).to(torch.bfloat16)
    bits = x.view(torch.int16)
    pats = torch.tensor([p - 65536 if p >= 32768 else p
                         for p in SPECIAL_BF16], dtype=torch.int16)
    pick = torch.randint(len(pats), (m * c,), generator=gen)
    put = torch.rand(m * c, generator=gen) < 0.5
    bits[put] = pats[pick[put]]
    n = min(len(pats), m * c)
    bits[:n] = pats[:n]
    return x.view(m, c).to(device)


def copy_matches(got, x2) -> bool:
    """The copy: x's bits."""
    return torch.equal(got.view(torch.int16), x2.view(torch.int16))


def addone_matches(got, want, x2) -> bool:
    """+1 against the plain version ``want``: the same bits, except that a
    NaN in gives a NaN out, whatever its payload."""
    nan = torch.isnan(x2)
    return (torch.equal(torch.isnan(got), nan) and
            torch.equal(got.view(torch.int16)[~nan],
                        want.view(torch.int16)[~nan]))


def check_copy(x2, bm) -> float:
    if not copy_matches(probes.copy_cuda(x2, bm), x2):
        raise AssertionError(f"probe copy {tuple(x2.shape)} bm={bm}: not "
                             "x's bits")
    return 0.0


def check_addone(x2, bm) -> float:
    if not addone_matches(probes.addone_cuda(x2, bm),
                          probes.addone_reference(x2), x2):
        raise AssertionError(f"probe addone {tuple(x2.shape)} bm={bm}: not "
                             "the bits of x + 1")
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
