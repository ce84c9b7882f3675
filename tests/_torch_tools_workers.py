"""A small 2-rank gloo job of the port that leaves the files the offline
tools read: per-rank timelines and history files from a clean run, and
flight-recorder dumps from a run in which rank 1 crashes at an enqueue
tick (``crash_at``) and rank 0 then fails on the closed gloo pair (or,
if it lingers, is SIGTERMed, as a launcher reaps survivors). Kept free
of JAX: the workers are spawned processes."""

import multiprocessing as mp
import os
import signal
import socket
import time

WORLD = 2
STEPS = 30
# Rank 1 dies at the loss allreduce of step 4: a step enqueues its one
# gradient bucket, then the loss (ticks count from 0).
CRASH_TICK = 4 * 2 + 1
TIMEOUT_S = 120


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, outdir, crash):
    if crash:
        os.environ["HOROVOD_TPU_BLACKBOX"] = os.path.join(outdir, "bb")
        os.environ["HOROVOD_TPU_BLACKBOX_INTERVAL"] = "0"
        os.environ["HOROVOD_TPU_FAULT_SPEC"] = f"rank=1:crash_at={CRASH_TICK}"
    else:
        os.environ["HOROVOD_TIMELINE"] = os.path.join(
            outdir, "timeline.{rank}.json")
        os.environ["HOROVOD_TPU_HISTORY"] = os.path.join(outdir, "history")
        os.environ["HOROVOD_TPU_HISTORY_INTERVAL"] = "0.05"
        os.environ["HOROVOD_TPU_PROCESS_ID"] = str(rank)
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=WORLD)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    metrics = hvd.StepMetrics(batch_size=8, device="cpu")
    gen = torch.Generator().manual_seed(rank)
    for _ in range(STEPS):
        x = torch.randn(8, 16, generator=gen)
        time.sleep(0.005)                  # the input phase
        with metrics:
            loss = model(x).square().mean()
            loss.backward()
            opt.step()
            opt.zero_grad()
            hvd.allreduce(loss.detach(), name="loss")
    hvd.shutdown()


def _join(procs, deadline):
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))


def run(outdir):
    """Both jobs into ``outdir``: ``timeline.{rank}.json`` (and their
    clock sidecars) and ``history/`` from the clean one, ``bb/`` from
    the crash. Returns the crash run's exit codes by rank."""
    ctx = mp.get_context("spawn")
    port = _port()
    clean = [ctx.Process(target=_worker, args=(r, port, outdir, False))
             for r in range(WORLD)]
    for p in clean:
        p.start()
    _join(clean, time.monotonic() + TIMEOUT_S)
    port = _port()
    crash = [ctx.Process(target=_worker, args=(r, port, outdir, True))
             for r in range(WORLD)]
    try:
        for p in crash:
            p.start()
        crash[1].join(TIMEOUT_S)
        crash[0].join(2.0)
        if crash[0].is_alive():
            os.kill(crash[0].pid, signal.SIGTERM)
        _join(crash, time.monotonic() + 30)
    finally:
        for p in clean + crash:
            if p.is_alive():
                p.kill()
                p.join(10)
    if any(p.exitcode != 0 for p in clean):
        raise RuntimeError(f"the clean run exited "
                           f"{[p.exitcode for p in clean]}")
    return [p.exitcode for p in crash]


if __name__ == "__main__":
    import sys
    print(run(sys.argv[1]))


def cli_options(main, argv):
    """The options ``main``'s parser declares (subcommands' included):
    (dest, flags, nargs, default, choices) of every action, read by
    stopping the parse before it runs anything."""
    import argparse
    import contextlib
    import io

    def actions(parser, prefix=""):
        out = []
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in sorted(a.choices.items()):
                    out += actions(sub, f"{prefix}{name}:")
            else:
                out.append((prefix + a.dest, tuple(a.option_strings),
                            a.nargs, a.default, a.required))
        return out

    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.extend(sorted(actions(self), key=repr))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                main(argv)
            except SystemExit:
                pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen
