"""P1: does the geometry of the copy's row tile move its bandwidth?

    python -m horovod_tpu_torch.experiments.shape_probe

Counterpart of ``experiments/pallas_shape_probe.py``: the same 411 MB of
bf16 (802816 x 256 elements) viewed as ``[TOTAL / c2, c2]`` and copied
by the probe copy kernel in ``(bm, c2)`` tiles, over the same
``(c2, bm)`` cases, beside ``torch.add(x, 1)`` and ``y.copy_(x)`` as
yardsticks. Prints ms, GB/s (bytes read + written) and the share of the
3.35 TB/s bound for each case.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import probes
from . import bound_ms, check_copy, device_line, require_cuda, time_ms

TOTAL = 802816 * 256            # elements (411 MB bf16)
# The probe's (c2, bm) cases; every tile divides [TOTAL / c2, c2].
CASES = ((256, 512), (256, 1024), (256, 4096),
         (2048, 128), (2048, 512), (2048, 1024),
         (8192, 128), (8192, 256), (512, 2048))


def run(check: bool = True):
    """One row per case and yardstick: name, c2, bm, tile_kb, ms, gbps,
    bound_ms, bound_by."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(TOTAL, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    y = torch.empty_like(x)
    nbytes = 2 * TOTAL * 2
    b_ms, b_by = bound_ms(0, nbytes)

    def row(name, ms, c2=None, bm=None):
        return dict(name=name, c2=c2, bm=bm,
                    tile_kb=bm * c2 * 2 / 1024 if bm else None, ms=ms,
                    gbps=nbytes / ms / 1e6, bound_ms=b_ms, bound_by=b_by)

    rows = [row("torch.add(x, 1)", time_ms(lambda: torch.add(x, 1))),
            row("y.copy_(x)", time_ms(lambda: y.copy_(x)))]
    for c2, bm in CASES:
        x2 = x.view(-1, c2)
        if check:
            check_copy(x2, bm)
        rows.append(row("probe copy", time_ms(
            lambda: probes.copy_cuda(x2, bm)), c2, bm))
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("shape_probe")
    print(device_line(), flush=True)
    print(f"copy of {TOTAL} bf16 ({TOTAL * 2 / 1e6:.0f} MB); bound "
          f"{bound_ms(0, 4 * TOTAL)[0]:.4f} ms (read + write at 3.35 TB/s)")
    for r in run():
        geo = (f" c2={r['c2']} bm={r['bm']} ({r['tile_kb']:.0f} KB tile)"
               if r["bm"] else "")
        print(f"{r['name']}{geo}: {r['ms']:.4f} ms = {r['gbps']:.1f} GB/s, "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
