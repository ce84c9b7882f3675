"""The probes P1 and P2 of this checkout and another, in turns.

    python -m horovod_tpu_torch.experiments.probe_turns --other TREE [--rounds 1]

Runs ``shape_probe.run(check=False)`` (P1: the copy over its nine
``(c2, bm)`` tiles) and ``mem_probe.run(check=False)`` (P2: the copy at
four row tiles, the stats-like reduce and the +1 map at three) of each
tree, with their yardsticks ``y.copy_(x)``, ``torch.add(x, 1)`` and
``torch.batch_norm_stats``. Each tree runs in a process of its own, in
the order other, this, this, other (per round), and builds its own
kernels from its own sources first (into its own ``ops/_kernels``). The
code run in each tree calls only those two functions, so the other tree
may be any checkout of the port. Prints the card's ``nvidia-smi`` line,
then one JSON line per run: the tree, its build seconds and {case: ms}.
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
RUN = """
import json
from horovod_tpu_torch.experiments import mem_probe, shape_probe
from horovod_tpu_torch.ops import _build
_build.library()
times = {}
for r in shape_probe.run(check=False):
    key = (f"P1 copy c2={r['c2']} bm={r['bm']}" if r["bm"]
           else f"P1 {r['name']}")
    times[key] = r["ms"]
for r in mem_probe.run(check=False):
    times[f"P2 {r['kind']} bm={r['bm']}" if r["bm"]
          else f"P2 {r['name']}"] = r["ms"]
print("RESULT", json.dumps({"build_s": _build.build_seconds or 0.0,
                            "times": times}))
"""


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the probes of {tree} failed:\n"
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
    require_cuda("probe_turns")
    print(device_line(), flush=True)
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            print(json.dumps(run_tree(tree)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
