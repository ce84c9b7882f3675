"""Where the host time of the flagship LM's gradient sync goes, on one card.

    python -m horovod_tpu_torch.experiments.sync_split [--steps 4]

Builds the 111M flagship LM of ``chip_smoke.py`` phase 5 (random
weights, AdamW, batch 8 x 2048) at world size 1 and times the host ms of
``optimizer.synchronize()`` two ways each step: "busy", called as the
train step calls it (right after ``backward()`` returns, the card still
running the backward), and "idle", after ``torch.cuda.synchronize()``.
Where the package has the collective engine, it also splits the busy
call: the submission (``fused_allreduce_async``, one request per
gradient, where the optimizer submits in ``synchronize()``; the
bucketed optimizer submits from its gradient hooks, during backward, so
none of it falls in the call), the
engine's ``_execute`` per group and the ``all_reduce`` calls inside it,
each as wall and thread-CPU ms (``time.thread_time``, whose resolution
is the host's), and prints the CPU operators of one busy call by self
time (``torch.profiler``, CPU activity). Prints the card's ``nvidia-smi``
line first and one JSON line per measurement. The script drives only
public entry points and, where present, wraps engine methods, so it
runs on any tree of the package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch
import torch.distributed as dist

from .. import optimizer as _opt
from .. import topology as _topo
from ..models import transformer as tfm
from ..ops import collective as _coll
from . import device_line, require_cuda


@contextlib.contextmanager
def _timed(obj, attr, totals, key):
    """Add the host ms of every call of ``obj.attr`` to ``totals[key]``,
    and the calling thread's CPU ms to ``totals[key + "_cpu"]`` (wall
    time above CPU time is time the thread waited: for the interpreter
    lock, or in a blocking call)."""
    inner = getattr(obj, attr)

    def wrapper(*a, **kw):
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            return inner(*a, **kw)
        finally:
            totals[key] = totals.get(key, 0.0) + \
                (time.perf_counter() - t0) * 1e3
            totals[key + "_cpu"] = totals.get(key + "_cpu", 0.0) + \
                (time.thread_time() - c0) * 1e3
    setattr(obj, attr, wrapper)
    try:
        yield
    finally:
        setattr(obj, attr, inner)


def run(steps: int = 4):
    """{"busy": [ms], "idle": [ms], "split": [{...}], "cpu_ops": [...]}."""
    _topo.init()
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                d_ff=3072, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    model = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    opt = _opt.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4),
        named_parameters=model.named_parameters())
    tok = torch.randint(0, cfg.vocab, (8, 2049),
                        generator=torch.Generator().manual_seed(1)).cuda()
    engine = getattr(_coll, "CollectiveEngine", None)

    def step(idle: bool) -> float:
        opt.zero_grad(set_to_none=True)
        model.loss_fn(tok[:, :-1], tok[:, 1:]).backward()
        if idle:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with opt.skip_synchronize():
            opt.step()
        torch.cuda.synchronize()
        return ms

    for _ in range(2):
        step(False)
    out = {"busy": [], "idle": [], "split": []}
    for _ in range(steps):
        out["idle"].append(step(True))
        if engine is None:
            out["busy"].append(step(False))
            continue
        totals = {}
        with _timed(_coll, "fused_allreduce_async", totals, "submit_ms"), \
                _timed(engine, "_execute", totals, "engine_execute_ms"), \
                _timed(dist, "all_reduce", totals, "all_reduce_ms"):
            out["busy"].append(step(False))
        out["split"].append(totals)
    if engine is not None:
        from torch.profiler import ProfilerActivity, profile
        opt.zero_grad(set_to_none=True)
        model.loss_fn(tok[:, :-1], tok[:, 1:]).backward()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            opt.synchronize()
        torch.cuda.synchronize()
        rows = sorted(prof.key_averages(),
                      key=lambda a: -a.self_cpu_time_total)[:15]
        out["cpu_ops"] = [{"op": a.key, "self_ms": a.self_cpu_time_total
                           / 1e3, "count": a.count} for a in rows]
    _topo.shutdown()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    require_cuda("sync_split")
    print(device_line(), flush=True)
    out = run(args.steps)
    print(json.dumps({"sync_ms_busy": out["busy"],
                      "sync_ms_idle": out["idle"],
                      "median_busy": statistics.median(out["busy"]),
                      "median_idle": statistics.median(out["idle"])}))
    for row in out["split"]:
        print(json.dumps({"split": row}))
    for row in out.get("cpu_ops", []):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
