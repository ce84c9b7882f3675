"""The 16-bit ``_wide`` flash backward of this checkout and another, in turns.

    python -m horovod_tpu_torch.experiments.wide_bwd_turns --other TREE [--rounds 1]
        [--dims 272,384,512]

K2 and K3 above head dim 256 (``flash_dkv_cuda`` and ``flash_dq_cuda``
on bf16 and on fp16 ``[B*H, S, D]`` inputs, causal, each dtype's own
outputs) at B=8, H=3, S=2048 and D = 272 (zero-padded to 384 by the
wrapper), 384 and 512 (or ``--dims``), each timed back-to-back
(``experiments.time_ms``).
lse and delta come from the plain forward on the same inputs. Each tree
runs in a process of its own, in the order other, this, this, other (per
round), and builds its own kernels from its own sources first (into its
own ``ops/_kernels``). Inputs are seeded N(0, 1). Prints the card's
``nvidia-smi`` line, then one JSON line per run: the tree, its build
seconds and {dtype: {D: {"dkv": ms, "dq": ms}}}. The code run in each
tree calls only the public wrappers, so the other tree may be any
checkout of the port. Needs one card.
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
import json, sys, torch
from horovod_tpu_torch.experiments import time_ms
from horovod_tpu_torch.ops import _build, flash_attention as fa
_build.library()
b, h, s = %r
out = {}
for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
    out[name] = {}
    for d in %s:
        gen = torch.Generator(device="cuda").manual_seed(1234 + s + d)
        q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_fwd_reference(q, k, v, scale, True)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        del o
        out[name][d] = {
            "dkv": time_ms(lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta,
                                                     scale, True)),
            "dq": time_ms(lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta,
                                                   scale, True))}
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
print("RESULT", json.dumps({"build_s": _build.build_seconds or 0.0,
                            "times": out}))
""" % (SHAPE, "json.loads(sys.argv[1])")


def run_tree(tree: Path, dims=HEAD_DIMS) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(dims)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the _wide backward of {tree} failed:\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return {"tree": str(tree), **json.loads(line[len("RESULT "):])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout "
                    "to run in turns with this one")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--dims", type=lambda s: [int(x) for x in s.split(",")],
                    default=list(HEAD_DIMS), help="head dims, comma-separated")
    args = ap.parse_args(argv)
    require_cuda("wide_bwd_turns")
    print(device_line(), flush=True)
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            print(json.dumps(run_tree(tree, args.dims)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
