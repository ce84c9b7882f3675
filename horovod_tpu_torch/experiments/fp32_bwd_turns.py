"""The fp32 flash kernels of this checkout and another, timed in turns.

    python -m horovod_tpu_torch.experiments.fp32_bwd_turns --other TREE [--rounds 1]

K1, K2 and K3 on fp32 operands (``flash_fwd_cuda``, ``flash_dkv_cuda``
and ``flash_dq_cuda`` with float32 ``[B*H, S, D]`` inputs, causal) at
the flagship's attention (B=8, H=6, S=2048, D=128) and at D=256 and
D=512 (B=8, H=3, S=2048), each timed back-to-back
(``experiments.time_ms``). Each tree runs in a process of its own, in
the order other, this, this, other (per round), and builds its own
kernels from its own sources first (into its own ``ops/_kernels``).
Inputs are seeded N(0, 1); lse and delta come from the plain forward.
Prints the card's ``nvidia-smi`` line, then one JSON line per run: the
tree and {shape: {"fwd_ms", "dkv_ms", "dq_ms"}}. The code run in each
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
SHAPES = ((8, 6, 2048, 128), (8, 3, 2048, 256), (8, 3, 2048, 512))
RUN = """
import json, torch
from horovod_tpu_torch.experiments import time_ms
from horovod_tpu_torch.ops import _build, flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
out = {}
for b, h, s, d in %r:
    gen = torch.Generator(device="cuda").manual_seed(1234 + s + d)
    q, do, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, scale, True)
    delta = (do * o).sum(-1, keepdim=True)
    del o
    out[f"{b}x{h}x{s}x{d}"] = {
        "fwd_ms": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale, True)),
        "dkv_ms": time_ms(lambda: fa.flash_dkv_cuda(
            q, k, v, do, lse, delta, scale, True)),
        "dq_ms": time_ms(lambda: fa.flash_dq_cuda(
            q, k, v, do, lse, delta, scale, True))}
    del q, do, k, v, lse, delta
    torch.cuda.empty_cache()
print("RESULT", json.dumps({"build_s": _build.build_seconds or 0.0,
                            "times": out}))
""" % (SHAPES,)


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the fp32 kernels of {tree} failed:\n"
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
    require_cuda("fp32_bwd_turns")
    print(device_line(), flush=True)
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            print(json.dumps(run_tree(tree)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
