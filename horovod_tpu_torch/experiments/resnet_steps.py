"""ResNet-50 train steps on one card, for comparing trees in turns.

    python -m horovod_tpu_torch.experiments.resnet_steps [--steps 12]

The main path of ``chip_smoke.py`` phase 8: ``init`` (NCCL, world 1),
``ResNet50(bn_impl="pallas")`` from seed 0, ``broadcast_parameters``,
``DistributedOptimizer(SGD(0.01, momentum=0.9))``, batch 256 of N(0, 1)
224 x 224 x 3 images. Runs ``--steps`` steps (each timed on the host
clock up to ``torch.cuda.synchronize()``) and prints the card's
``nvidia-smi`` line, then one JSON line: the step seconds, the median
img/s of the steps after the first, and the host ms of each step's
``optimizer.synchronize()``. It drives only public entry points, so it
runs on any tree of the package (copy it into another checkout to time
that tree).
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import time

import torch

from . import device_line, require_cuda

BATCH, IMAGE = 256, 224


def run(steps: int = 12) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as tres
    from horovod_tpu_torch.parallel.train import build_image_train_step

    hvd.init()
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen,
                         device="cuda")
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    step = build_image_train_step(
        functools.partial(tres.ResNet50, num_classes=1000, bn_impl="pallas"),
        lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    sync_ms = []
    inner = opt.synchronize

    def timed_sync():
        t0 = time.perf_counter()
        inner()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    opt.synchronize = timed_sync
    torch.cuda.synchronize()
    seconds, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(model, opt, images, labels)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
    hvd.shutdown()
    return {"step_s": seconds,
            "img_s": BATCH / statistics.median(seconds[1:]),
            "sync_ms": sync_ms, "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)
    require_cuda("resnet_steps")
    print(device_line(), flush=True)
    print(json.dumps(run(args.steps)))


if __name__ == "__main__":
    main()
