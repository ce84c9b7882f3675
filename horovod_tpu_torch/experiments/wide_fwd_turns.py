"""The 16-bit ``_wide`` flash forward of this checkout and another, in turns.

    python -m horovod_tpu_torch.experiments.wide_fwd_turns --other TREE [--rounds 1]

K1 above head dim 256 (``flash_fwd_cuda`` on bf16 and on fp16 ``[B*H,
S, D]`` inputs, causal, each dtype's own output) at B=8, H=3, S=2048
and D = 272 (zero-padded to 384 by the wrapper), 384 and 512, each timed
back-to-back (``experiments.time_ms``). Each tree runs in a process of
its own, in the order other, this, this, other (per round), and builds
its own kernels from its own sources first (into its own
``ops/_kernels``). Inputs are seeded N(0, 1). Prints the card's
``nvidia-smi`` line, then one JSON line per run: the tree, its build
seconds and {dtype: {D: ms}}. The code run in each tree calls only the
public wrapper, so the other tree may be any checkout of the port.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from . import device_line, require_cuda

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (8, 3, 2048)        # B, H, S
HEAD_DIMS = (272, 384, 512)
RUN = """
import json, torch
from horovod_tpu_torch.experiments import time_ms
from horovod_tpu_torch.ops import _build, flash_attention as fa
_build.library()
b, h, s = %r
out = {}
for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
    out[name] = {}
    for d in %r:
        gen = torch.Generator(device="cuda").manual_seed(1234 + s + d)
        q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        scale = d ** -0.5
        out[name][d] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale,
                                                         True))
        del q, k, v
        torch.cuda.empty_cache()
print("RESULT", json.dumps({"build_s": _build.build_seconds or 0.0,
                            "times": out}))
""" % (SHAPE, HEAD_DIMS)


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the _wide forward of {tree} failed:\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return {"tree": str(tree), **json.loads(line[len("RESULT "):])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout "
                    "to run in turns with this one")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    require_cuda("wide_fwd_turns")
    print(device_line(), flush=True)
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            print(json.dumps(run_tree(tree)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
