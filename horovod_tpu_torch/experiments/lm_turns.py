"""Phase 5's train step of this checkout and another, in turns.

    python -m horovod_tpu_torch.experiments.lm_turns --other TREE [--rounds 1]

Runs ``chip_smoke.py``'s phase 5 (the 111M flagship's data-parallel
step, 5 steps of 8 x 2048 tokens, bf16, through the engine) of each tree
in a process of its own, in the order other, this, this, other (per
round), each process building its tree's kernels from its own sources
first. Prints the card's ``nvidia-smi`` line, then one JSON line per
run: the tree, its kernel build's seconds (0 when the library was built
by an earlier run of the same tree) and its tok/s (median of steps 2-5).
Needs one card; both trees need a ``chip_smoke.py`` whose
``lm_main_path`` returns the median step seconds second.
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
RUN = """
import json, torch
import chip_smoke as cs
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import _build, flash_attention as fa
from horovod_tpu_torch.ops import fused_bn as fbn
from horovod_tpu_torch.parallel.train import build_train_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.library()
hvd.init()
step_s = cs.lm_main_path(hvd, tfm, fa, fbn, build_train_step, None)[1]
hvd.shutdown()
print("RESULT", json.dumps({"build_s": _build.build_seconds or 0.0,
                            "tok_s": 8 * 2048 / step_s}))
"""


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 5 of {tree} failed:\n"
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
    require_cuda("lm_turns")
    print(device_line(), flush=True)
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            print(json.dumps(run_tree(tree)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
