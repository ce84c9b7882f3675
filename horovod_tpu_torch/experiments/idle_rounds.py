"""What an idle world costs each rank of the collective engine, on gloo.

    python -m horovod_tpu_torch.experiments.idle_rounds [--ranks 2] [--seconds 2]

Spawns a job of ``--ranks`` processes on this host's CPU (gloo over
localhost), runs one allreduce, then leaves every rank idle for
``--seconds`` and prints one JSON line: per rank, the control-plane
gathers of the idle window (``dist.gather_object`` calls; a negotiation
round makes one) and the CPU seconds the process spent in it
(``time.process_time``, every thread). It counts calls through
``torch.distributed`` and uses only public entry points, so it runs on
any tree of the package that has the engine. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank, n, port, seconds, outdir):
    import horovod_tpu_torch as hvd
    calls = [0]
    inner = dist.gather_object

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)
    dist.gather_object = counted
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=n)
    hvd.allreduce(torch.ones(4), name="warm")
    time.sleep(0.2)
    c0, t0 = calls[0], time.process_time()
    time.sleep(seconds)
    row = {"rank": rank, "gathers": calls[0] - c0,
           "cpu_s": time.process_time() - t0}
    hvd.shutdown()
    with open(os.path.join(outdir, f"{rank}.json"), "w") as f:
        json.dump(row, f)


def run(ranks: int = 2, seconds: float = 2.0):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(ranks, port, seconds, d), nprocs=ranks)
        rows = []
        for r in range(ranks):
            with open(os.path.join(d, f"{r}.json")) as f:
                rows.append(json.load(f))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    print(json.dumps({"ranks": args.ranks, "idle_s": args.seconds,
                      "HOROVOD_CYCLE_TIME": os.environ.get(
                          "HOROVOD_CYCLE_TIME"),
                      "per_rank": run(args.ranks, args.seconds)}))


if __name__ == "__main__":
    main()
