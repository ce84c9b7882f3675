"""P2: what a plain copy and a stats-style reduce reach at the batch-norm
kernels' shape, over row tiles.

    python -m horovod_tpu_torch.experiments.mem_probe

Counterpart of ``experiments/pallas_mem_probe.py``: ``[802816, 256]``
bf16 (411 MB, the stage-1 activation of ResNet-50 at batch 256) through
the probe kernels, one ``(bm, 256)`` row tile per CTA: the copy at bm in
{256, 512, 1024, 2048} (2 passes: read + write), the stats-like reduce
(one fp32 [1, 256] vector, sum(x) + sum(x^2); 1 pass) and the +1 map (2
passes) at bm in {512, 1024, 2048}, beside ``torch.add(x, 1)`` and
``torch.batch_norm_stats`` (the yardstick of the BN stats kernel) as
library calls. Prints ms, GB/s and the share of the 3.35 TB/s bound.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import probes
from . import (PEAK_FP32_FLOPS, bound_ms, check_addone, check_copy,
               check_stats_like, device_line, require_cuda, time_ms)

M, C = 802816, 256
COPY_BMS = (256, 512, 1024, 2048)
MAP_BMS = (512, 1024, 2048)


def work(kind: str):
    """(fp32 operations, bytes) of one call at [M, C]: each input read
    once, each output written once."""
    if kind == "stats_like":
        return 3 * M * C, M * C * 2 + C * 4
    return (M * C if kind == "addone" else 0), 2 * M * C * 2


def run(check: bool = True):
    """One row per kernel and row tile and per yardstick: name, kind, bm,
    ms, gbps, bound_ms, bound_by."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(M, C, generator=gen, device="cuda", dtype=torch.bfloat16)

    def row(name, kind, ms, bm=None):
        ops, nbytes = work(kind)
        b_ms, b_by = bound_ms(ops, nbytes, PEAK_FP32_FLOPS)
        return dict(name=name, kind=kind, bm=bm, ms=ms,
                    gbps=nbytes / ms / 1e6, bound_ms=b_ms, bound_by=b_by)

    rows = [row("torch.add(x, 1)", "addone",
                time_ms(lambda: torch.add(x, 1))),
            row("torch.batch_norm_stats", "stats_like",
                time_ms(lambda: torch.batch_norm_stats(x, 1e-5)))]
    for bm in COPY_BMS:
        if check:
            check_copy(x, bm)
        rows.append(row("probe copy", "copy",
                        time_ms(lambda: probes.copy_cuda(x, bm)), bm))
    for bm in MAP_BMS:
        if check:
            check_addone(x, bm)
            check_stats_like(x, bm)
        rows.append(row("probe stats-like", "stats_like",
                        time_ms(lambda: probes.stats_like_cuda(x, bm)), bm))
        rows.append(row("probe addone", "addone",
                        time_ms(lambda: probes.addone_cuda(x, bm)), bm))
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("mem_probe")
    print(device_line(), flush=True)
    print(f"x: [{M}, {C}] bf16 ({M * C * 2 / 1e6:.0f} MB); one pass at "
          f"3.35 TB/s = {bound_ms(0, M * C * 2)[0]:.4f} ms")
    for r in run():
        bm = f" bm={r['bm']}" if r["bm"] else ""
        print(f"{r['name']}{bm}: {r['ms']:.4f} ms = {r['gbps']:.1f} GB/s, "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound "
              f"({r['bound_ms']:.4f} ms, {r['bound_by']})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
