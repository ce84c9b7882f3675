"""The mesh train step across cards against one card, over NCCL.

    python -m horovod_tpu_torch.experiments.mesh_parity [--layers 2]

Needs four CUDA cards on one host. Starts four ranks (NCCL, one card
each) and runs one AdamW step of the flagship LM's width (vocab 32000,
d_model 768, 6 heads of 128, d_ff 3072, bf16, no remat; ``--layers``
deep) on 4 x 2048 tokens, twice:

- ``tp=2, sp=2``, ring attention: each sequence shard of 1024 tokens on
  the flash kernels' fp32-output forms, K/V and the travelling dK/dV
  sent around the ring by NCCL sends and receives; the row-parallel
  psums over 'tp';
- ``dp=2, sp=2``, Ulysses: the two all-to-alls, the bf16 kernels over
  the gathered 2048 tokens, and the gradients summed over 'dp'.

Every rank also runs the data-parallel model (no mesh) on the whole
batch on its own card, from the same weights. It prints the card's
``nvidia-smi`` name and power limit, then one JSON line per variant:
the step's global loss against that reference, the largest error of
any rank's gradient shard against the reference's block at its
coordinate (relative to the block's max |value|), the fp32 and bf16
kernel launches of rank 0's step, and that first step's ms on rank 0
(host clock, to the loss on the host: it carries each kernel's first
launch). It fails past 1e-2 on the loss or 5e-2 on any gradient (bf16:
the ring and the single card attend in other orders), as
``chip_smoke.py``'s parity does. ``run(..., device="cpu", width=...)``
runs the same ranks on gloo, for a rehearsal at a small width.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import torch
import torch.multiprocessing as mp

from ..ops import flash_attention as fa
from . import device_line

WORLD = 4
FLAGSHIP = dict(vocab=32000, d_model=768, n_heads=6, d_ff=3072,
                max_seq=2048)
VARIANTS = {"ring": ({"tp": 2, "sp": 2}, "ring"),
            "ulysses": ({"dp": 2, "sp": 2}, "ulysses")}
LOSS_TOL, GRAD_TOL = 1e-2, 5e-2


def _config(tfm, width, layers, **kw):
    return tfm.TransformerConfig(n_layers=layers, dtype=torch.bfloat16,
                                 remat=False, **width, **kw)


def _factory(p):
    return torch.optim.AdamW(p, lr=1e-4)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_rank(rank, port, layers, outdir, device, width):
    """One rank: the reference on its own device, then each variant's
    mesh step on 4 sequences of ``width["max_seq"]`` tokens; writes its
    results to ``outdir``."""
    import horovod_tpu_torch as hvd
    from ..models import transformer as tfm
    from ..parallel.mesh import create_mesh, place, shard_tensor
    from ..parallel.train import build_train_step
    hvd.init(device=device, init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=WORLD)
    dev = hvd.device()
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, width["vocab"], (4, width["max_seq"] + 1),
                        generator=gen)
    tokens, targets = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    params = tfm.init_params(_config(tfm, width, layers),
                             torch.Generator().manual_seed(0))
    ref = tfm.Transformer(_config(tfm, width, layers), params=params,
                          device=dev)
    ref_loss = ref.loss_fn(tokens, targets)
    ref_loss.backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    out = {}
    for name, (axes, impl) in VARIANTS.items():
        mesh = create_mesh(**axes)
        cfg = _config(tfm, width, layers,
                      tp_axis="tp" if "tp" in axes else None, sp_axis="sp",
                      sp_impl=impl)
        step = build_train_step(cfg, _factory, mesh=mesh)
        model = step.make_model(params=step.shard_params(params))
        opt = step.make_optimizer(model)
        fa.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        loss = step(model, opt, step.shard_batch(tokens),
                    step.shard_batch(targets))
        loss = float(loss)
        ms = (time.perf_counter() - t0) * 1e3
        sizes, coords = place(mesh)
        specs = dict(step.specs, **{f"layers.{i}.{k}": v
                                    for i, layer in enumerate(
                                        step.specs["layers"])
                                    for k, v in layer.items()})
        err = 0.0
        for n, p in model.named_parameters():
            want = shard_tensor(ref_grads[n], specs[n], sizes, coords)
            err = max(err, float((p.grad.float() - want.float()).abs().max()
                                 / want.float().abs().max().clamp_min(1e-30)))
        out[name] = {"mesh": axes, "loss": loss,
                     "reference_loss": float(ref_loss.detach()),
                     "max_grad_rel_err": err, "ms": ms,
                     "launches": fa.launch_counts()}
        del model, opt
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(layers, device="cuda", width=FLAGSHIP):
    """{variant: rank 0's line, with the worst gradient error of all
    ranks}."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_rank, args=(_free_port(), layers, outdir, device,
                                 width), nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    lines = {}
    for name in VARIANTS:
        line = dict(ranks[0][name])
        line["max_grad_rel_err"] = max(r[name]["max_grad_rel_err"]
                                       for r in ranks)
        line["loss_rel_err"] = (abs(line["loss"] - line["reference_loss"])
                                / abs(line["reference_loss"]))
        lines[name] = line
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < WORLD:
        sys.exit(f"mesh_parity: needs {WORLD} CUDA cards, found "
                 f"{torch.cuda.device_count()}")
    print(device_line(), flush=True)
    ok = True
    for name, line in run(args.layers).items():
        print(json.dumps({"variant": name, **line}), flush=True)
        ok &= (line["loss_rel_err"] <= LOSS_TOL
               and line["max_grad_rel_err"] <= GRAD_TOL)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
