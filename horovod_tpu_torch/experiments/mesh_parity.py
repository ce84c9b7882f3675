"""The mesh train step across cards against one card, over NCCL.

    python -m horovod_tpu_torch.experiments.mesh_parity [--layers 2] [--variants A,B]

Needs four CUDA cards on one host. Starts four ranks (NCCL, one card
each) and runs one AdamW step of the flagship LM's width (vocab 32000,
d_model 768, 6 heads of 128, d_ff 3072, bf16, no remat; ``--layers``
deep) on 4 x 2048 tokens in each variant:

- ``ring``: ``tp=2, sp=2``, ring attention: each sequence shard of 1024
  tokens on the flash kernels' fp32-output forms, K/V and the travelling
  dK/dV sent around the ring by NCCL sends and receives; the
  row-parallel psums over 'tp';
- ``ulysses``: ``dp=2, sp=2``: the two all-to-alls, the bf16 kernels
  over the gathered 2048 tokens, and the gradients summed over 'dp';
- ``zero1``: ``dp=4`` with the ZeRO-1 optimizer: the gradients summed
  and cut by one ``reduce_scatter_tensor``, the updated shards back by
  one ``all_gather_into_tensor``; ``replicated`` is the same mesh step
  without it, for the memory beside it;
- ``dcn_exact`` and ``dcn_int8``: ``dcn=2, dp=2`` with
  ``HOROVOD_TPU_DCN_AXES=dcn`` and ``dcn_axis="auto"``: the
  hierarchical reduction, its cross-node leg exact or ``int8x256``;
- ``moe``: the flagship with a top-1 MoE of 8 experts in every odd
  layer (capacity factor 8.0, so that no token drops on one card or on
  the mesh) on ``dp=2, ep=2``: the experts' two all-to-alls.

and the data-parallel step through the collective engine:

- ``hier_engine``: ``LOCAL_WORLD_SIZE=2`` (two "nodes" of two cards on
  the one host: dcn = 2, ici = 2), ``HOROVOD_TPU_HIERARCHICAL_ALLREDUCE``
  and ``_ALLGATHER`` on: the ``DistributedOptimizer``'s buckets reduced
  within each pair (``reduce_scatter_tensor``), across the pairs
  (``all_reduce``) and gathered back (``all_gather_into_tensor``); one
  rank's sequence per rank. The same ranks run the flat engine (the
  switches off) in a second job. Its line holds both runs' step-1
  losses, the hierarchical gradients' largest error against the flat
  run's and against the one-card reference, their ms per step (median
  of 3 steps after the first, host clock to ``synchronize``) and
  whether a ragged ``allgather`` through the two-stage gather is the
  flat concatenation. Both pairs share one host's NVLink, so this times
  the two-stage algorithm, not a cross-node link.

and distributed batch norm:

- ``sync_bn``: a small fp32 ResNet (``stage_sizes=[1, 1]``, 16 filters,
  10 classes, TF32 off) with ``bn_axis_name="dp"`` on ``dp=4``, each
  rank holding a quarter of a 32 x 32 x 32 x 3 batch, against the same
  weights with local BN on one card on the whole batch (the loss
  ``sum(logits * g)``, ``g`` seeded): the logits gathered within
  ``SYNC_BN_FWD_TOL`` (1e-5) of the reference's max, the parameter
  gradients summed over the ranks within ``SYNC_BN_GRAD_TOL`` (1e-4 of
  each tensor's max: the weight gradients' batch sums run in another
  order, a quarter batch on each card then a 4-way all-reduce, and BN's
  backward cancels most of each sum), and one ``[2C]`` all-reduce per
  BN layer in the forward (counted).

and checkpoints of the sharded optimizer state:

- ``ckpt_zero1``: the flagship (``--layers`` deep) on ``dp=4`` with the
  ZeRO-1 optimizer, 2 AdamW steps, then an ``ElasticState`` commit on
  the sharded engine (every rank writes its flat blocks of the
  shadows and moments, rank 0 the replicated model too) and a third
  step; a fresh model and optimizer from another seed restore it in
  place on every rank and take the third step again. Its line holds
  the resumed step's loss beside the uninterrupted one's, whether the
  parameters and moments after it are bit for bit, the restored step
  on every rank, whether every sharded leaf reassembled through
  ``restore_addressable`` at a dp = 2 layout equals the four ranks'
  blocks bit for bit, the commit's bytes, the ms ``commit`` blocked
  rank 0's loop, and the seconds to the durable commit and to the
  restore (rank 0).

and the serving tier's decode path:

- ``decode_tp``: ``dp=2, tp=2``: each dp pair runs a prefill and 16
  decode steps of a 4-slot pool (16-token blocks, random prompts of its
  own seed) through ``Transformer.apply_decode`` at tp = 2, each rank
  holding its 3 heads of the pool, and every rank the same calls at
  tp = 1 on its own card from the same weights; for the bf16 pool and
  the int8 one. Its line holds the worst logits error of any call
  (``DECODE_TOL``, 1e-2 of max |logit|) and whether each layer's pool
  holds at tp = 2 the bits the same heads hold at tp = 1: layer 0's K
  and V come from the embeddings through a column slice of the
  projection (no psum before them), so where the bf16 pool's layer 0
  agrees, the int8 pool's payload and scales must too (the head-shard
  promise of the quantized pool).

and the pipelined flagship at its full depth (12 layers, whatever
``--layers`` says) on ``pp=4``, 8 x 2048 tokens as m = 8 microbatches of
1, with NCCL sends and receives between the stages:

- ``pp_gpipe``, ``pp_1f1b``, ``pp_zb-h1``: ``build_pipeline_train_step``
  on each schedule;
- ``pp_interleaved``: interleaved with V = 3 (12 layers in pp·V = 12
  chunks).

Every rank also runs the reference on the whole batch on its own card,
from the same weights: the data-parallel model (no mesh), or for
``moe`` the same MoE model on a mesh of this rank alone. It prints the
card's ``nvidia-smi`` name and power limit, then one JSON line per
variant: the step's global loss against the reference's, the largest
error of any rank's reduced gradient against the reference's block at
its coordinate (relative to the block's max |value|; under ZeRO-1 the
rank's flat shard of the gradient), the fp32 and bf16 kernel launches
of rank 0's step, that first step's ms on rank 0 (host clock, to the
loss on the host: it carries each kernel's first launch), the largest
peak memory of any rank over a second step, with the optimizer's state
in place (``torch.cuda.max_memory_allocated`` less what was allocated
before the variant's model),
and for the dcn variants the bytes one rank sends across nodes per step
(``cross_slice_bytes``, hierarchical and flat). A pipeline variant's
reference is the same step on 4 virtual stages in one process (the
local transport, ``chip_smoke.py`` phase 15b) from the same weights and
tokens: its line holds the step-1 loss, the largest error of this rank's
step-1 gradients (its stage and the replicated embedding, position and
final-norm weights) against the virtual stage of the same rank, whether
all of them are bit for bit, then 3 more steps: their ms (host clock to
``synchronize``), the median's tok/s per card, ``schedule_info``'s bubble
share at n = 4, m = 8 and the peak memory over them. It fails past 1e-2 on
the loss or 5e-2 on any gradient (bf16: the mesh and the single card
sum in other orders; int8 adds a level of a 256-block), as
``chip_smoke.py``'s parity does. ``run(..., device="cpu",
width=...)`` runs the same ranks on gloo, for a rehearsal at a small
width; ``--variants`` (and ``run(..., variants=...)``) picks some.
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
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention as fa
from . import device_line

WORLD = 4
FLAGSHIP = dict(vocab=32000, d_model=768, n_heads=6, d_ff=3072,
                max_seq=2048)
WIRE = "int8x256"
# name: (mesh axes, config options, build_train_step options, ZeRO-1)
VARIANTS = {
    "ring": ({"tp": 2, "sp": 2}, dict(tp_axis="tp", sp_axis="sp"), {},
             False),
    "ulysses": ({"dp": 2, "sp": 2}, dict(sp_axis="sp", sp_impl="ulysses"),
                {}, False),
    "zero1": ({"dp": 4}, {}, {}, True),
    "replicated": ({"dp": 4}, {}, {}, False),
    "dcn_exact": ({"dcn": 2, "dp": 2}, {}, dict(dcn_axis="auto"), False),
    "dcn_int8": ({"dcn": 2, "dp": 2}, {},
                 dict(dcn_axis="auto", dcn_wire=WIRE), False),
    "moe": ({"dp": 2, "ep": 2},
            dict(ep_axis="ep", num_experts=8, capacity_factor=8.0), {},
            False),
}
# name: (schedule, num_virtual)
PIPE_VARIANTS = {"pp_gpipe": ("gpipe", 1), "pp_1f1b": ("1f1b", 1),
                 "pp_zb-h1": ("zb-h1", 1), "pp_interleaved": ("interleaved", 3)}
PIPE_LAYERS, PIPE_M, PIPE_TIMED = 12, 8, 3
LOSS_TOL, GRAD_TOL = 1e-2, 5e-2
HIER_TOL = 1e-2     # hier_engine's gradients against the flat run's
ENGINE_TIMED = 3


def _config(tfm, width, layers, **kw):
    return tfm.TransformerConfig(n_layers=layers, dtype=torch.bfloat16,
                                 remat=False, **width, **kw)


def _factory(p):
    return torch.optim.AdamW(p, lr=1e-4)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reference(tfm, cfg, params, dev, tokens, targets):
    """(loss, gradients) of one card on the whole batch. A MoE config
    runs on a mesh of this rank alone (its 'ep' of size 1)."""
    mesh = None
    if cfg.ep_axis:
        group, _ = dist.new_subgroups(group_size=1)
        mesh = DeviceMesh.from_group(group, dev.type,
                                     mesh_dim_names=(cfg.ep_axis,))
    ref = tfm.Transformer(cfg, params=params, device=dev, mesh=mesh)
    loss = ref.loss_fn(tokens, targets)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  ref.named_parameters()}


def _grad_err(model, opt, step, ref_grads, zero1):
    """The largest error of this rank's reduced gradients against the
    reference's blocks, relative to each block's max |value|."""
    from ..parallel.mesh import shard_tensor, spec_of
    from ..parallel.zero import _flat_pad
    err = 0.0
    for k, (n, p) in enumerate(model.named_parameters()):
        want = shard_tensor(ref_grads[n], spec_of(step.specs, n),
                            step.sizes, step.coords)
        got = p.grad
        if zero1:
            # This rank's flat shard of the dp-summed gradient.
            got = opt.shadows[k].grad
            width = got.numel()
            want = _flat_pad(want, opt.n_shards)[opt.index * width:
                                                 (opt.index + 1) * width]
        err = max(err, float((got.float() - want.float()).abs().max()
                             / want.float().abs().max().clamp_min(1e-30)))
    return err


def _crossing_bytes(model, step):
    """Bytes one rank sends across nodes per step, hierarchical (with
    the step's wire) and flat."""
    from ..parallel.collectives import cross_slice_bytes
    ici = step.sizes["dp"]
    sizes = [p.numel() for p in model.parameters()]
    return {"hierarchical": sum(cross_slice_bytes(n, ici, wire=step.dcn_wire)
                                for n in sizes),
            "flat": sum(cross_slice_bytes(n, ici, hierarchical=False)
                        for n in sizes)}


def _pipe_grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _pipe_line(tfm, width, name, mesh, dev):
    """One pipeline variant on this rank: the virtual reference, then the
    'pp' step."""
    from ..parallel import train as ttrain
    from ..parallel.pipeline import schedule_info
    schedule, v = PIPE_VARIANTS[name]
    n = WORLD
    r = mesh.get_local_rank("pp")
    cfg = _config(tfm, width, PIPE_LAYERS)
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, width["vocab"], (PIPE_M, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(1))
    tok_mb = tok[:, :-1].reshape(PIPE_M, 1, -1).to(dev)
    tgt_mb = tok[:, 1:].reshape(PIPE_M, 1, -1).to(dev)
    tree = ttrain.to_pipeline_params(cfg, full, n, v)

    vstep = ttrain._virtual_pipeline_train_step(
        cfg, n, _factory, schedule=schedule, num_virtual=v, device=dev)
    models = [vstep.make_model(params=vstep.shard_params(tree, k))
              for k in range(n)]
    ref_loss = float(vstep(models, [vstep.make_optimizer(m) for m in models],
                           tok_mb, tgt_mb))
    ref_grads = _pipe_grads(models[r])
    del models

    step = ttrain.build_pipeline_train_step(cfg, mesh, _factory,
                                            schedule=schedule,
                                            num_virtual=v, device=dev)
    model = step.make_model(params=step.shard_params(tree))
    opt = step.make_optimizer(model)
    fa.reset_launch_counts()
    loss = float(step(model, opt, tok_mb, tgt_mb))
    launches = fa.launch_counts()
    grads = _pipe_grads(model)
    err, exact = 0.0, loss == ref_loss
    for key, g in grads.items():
        want = ref_grads[key]
        exact &= torch.equal(g, want)
        err = max(err, float((g.float() - want.float()).abs().max()
                             / want.float().abs().max().clamp_min(1e-30)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(PIPE_TIMED):
        _sync(dev)
        t0 = time.perf_counter()
        step(model, opt, tok_mb, tgt_mb)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times)[len(times) // 2]
    return {"mesh": {"pp": n}, "schedule": schedule, "num_virtual": v,
            "loss": loss, "reference_loss": ref_loss,
            "max_grad_rel_err": err, "bitwise": exact,
            "launches": launches, "ms_steps": times, "ms": ms,
            "tok_s_per_card": tok_mb.numel() / (ms / 1e3) / n,
            "bubble_share": schedule_info(schedule, n, PIPE_M,
                                          num_virtual=v).bubble_share,
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if dev.type == "cuda" else None)}


def run_rank(rank, port, layers, outdir, device, width, variants):
    """One rank: the references on its own device, then each variant's
    mesh step on 4 sequences of ``width["max_seq"]`` tokens; writes its
    results to ``outdir``."""
    import horovod_tpu_torch as hvd
    from ..models import transformer as tfm
    from ..parallel.mesh import create_mesh
    from ..parallel.train import build_train_step
    hvd.init(device=device, init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=WORLD)
    dev = hvd.device()
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, width["vocab"], (4, width["max_seq"] + 1),
                        generator=gen)
    tokens, targets = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    refs = {}
    out = {}
    for name in variants:
        if name in PIPE_VARIANTS:
            out[name] = _pipe_line(tfm, width, name,
                                   create_mesh(pp=WORLD), dev)
            continue
        axes, cfg_kw, step_kw, zero1 = VARIANTS[name]
        moe = bool(cfg_kw.get("num_experts"))
        cfg = _config(tfm, width, layers, **cfg_kw)
        ref_cfg = _config(tfm, width, layers,
                          **({k: cfg_kw[k] for k in ("ep_axis", "num_experts",
                                                     "capacity_factor")}
                             if moe else {}))
        params = tfm.init_params(ref_cfg, torch.Generator().manual_seed(0))
        if moe not in refs:
            refs[moe] = _reference(tfm, ref_cfg, params, dev, tokens,
                                   targets)
        ref_loss, ref_grads = refs[moe]
        if "dcn" in axes:
            os.environ["HOROVOD_TPU_DCN_AXES"] = "dcn"
        mesh = create_mesh(**axes)
        step = build_train_step(cfg, _factory, mesh=mesh, **step_kw)
        os.environ.pop("HOROVOD_TPU_DCN_AXES", None)
        _sync(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        model = step.make_model(params=step.shard_params(params))
        opt = step.make_optimizer(model, zero1=zero1)
        batch = step.shard_batch(tokens), step.shard_batch(targets)
        fa.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        loss = float(step(model, opt, *batch))
        ms = (time.perf_counter() - t0) * 1e3
        line = {"mesh": axes, "loss": loss, "reference_loss": ref_loss,
                "max_grad_rel_err": _grad_err(model, opt, step, ref_grads,
                                              zero1),
                "ms": ms, "launches": fa.launch_counts(), "peak_mib": None}
        if dev.type == "cuda":
            # A second step, with the optimizer's state in place.
            torch.cuda.reset_peak_memory_stats(dev)
            step(model, opt, *batch)
            _sync(dev)
            line["peak_mib"] = (torch.cuda.max_memory_allocated(dev)
                                - base) / 2**20
        if "dcn" in axes:
            line["dcn_axis"] = step.dcn_axis
            line["cross_slice_bytes"] = _crossing_bytes(model, step)
        out[name] = line
        del model, opt
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def run_engine_rank(rank, port, layers, outdir, device, width, hier):
    """One rank of ``hier_engine``: the engine's dp step on this rank's
    sequence, two ranks to a node, hierarchical or flat."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    for knob in ("HIERARCHICAL_ALLREDUCE", "HIERARCHICAL_ALLGATHER"):
        os.environ["HOROVOD_TPU_" + knob] = "1" if hier else "0"
    import horovod_tpu_torch as hvd
    from ..models import transformer as tfm
    from ..parallel.train import build_train_step
    # The "nodes" share one host: each rank keeps its own card, where the
    # local rank (rank % 2) would put two ranks on each of two cards.
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    dev = hvd.device()
    tok = torch.randint(0, width["vocab"], (WORLD, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    tokens, targets = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    cfg = _config(tfm, width, layers)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    ref_loss, ref_grads = _reference(tfm, cfg, params, dev, tokens, targets)
    step = build_train_step(cfg, _factory, device=dev)
    model = step.make_model(params=params)
    opt = step.make_optimizer(model)
    mine = slice(rank, rank + 1)
    fa.reset_launch_counts()
    loss = float(step(model, opt, tokens[mine], targets[mine]))
    launches = fa.launch_counts()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    err = max(float((grads[n].float() - g.float()).abs().max()
                    / g.float().abs().max().clamp_min(1e-30))
              for n, g in ref_grads.items())
    times = []
    for _ in range(ENGINE_TIMED):
        _sync(dev)
        t0 = time.perf_counter()
        step(model, opt, tokens[mine], targets[mine])
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    rows = torch.full((rank + 1, 3), float(rank), device=dev)
    gathered = hvd.allgather(rows, name="hier_engine.ragged")
    want = torch.cat([torch.full((r + 1, 3), float(r), device=dev)
                      for r in range(WORLD)])
    line = {"mesh": {"dcn": WORLD // 2, "ici": 2}, "hierarchical": hier,
            "loss": loss, "reference_loss": ref_loss,
            "max_grad_rel_err": err, "ms_steps": times,
            "ms": sorted(times)[len(times) // 2], "launches": launches,
            "allgather_exact": bool(torch.equal(gathered, want)),
            "peak_mib": None}
    hvd.shutdown()
    torch.save({"line": line, "grads": {n: g.cpu() for n, g in grads.items()}},
               os.path.join(outdir, f"rank{rank}.pt"))


def _hier_engine(layers, device, width):
    """``hier_engine``'s line: the hierarchical job's rank 0, with the
    flat job's loss and ms and the largest error of any rank's
    hierarchical gradients against the flat ones."""
    runs = {}
    for hier in (False, True):
        with tempfile.TemporaryDirectory() as outdir:
            mp.spawn(run_engine_rank, args=(_free_port(), layers, outdir,
                                            device, width, hier),
                     nprocs=WORLD)
            runs[hier] = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                          for r in range(WORLD)]
    line = dict(runs[True][0]["line"])
    line["max_grad_rel_err"] = max(r["line"]["max_grad_rel_err"]
                                   for r in runs[True])
    line["allgather_exact"] = all(r["line"]["allgather_exact"]
                                  for r in runs[True])
    flat = runs[False][0]["line"]
    line.update(flat_loss=flat["loss"], flat_ms=flat["ms"],
                flat_ms_steps=flat["ms_steps"],
                flat_max_grad_rel_err=max(r["line"]["max_grad_rel_err"]
                                          for r in runs[False]))
    line["grad_rel_err_vs_flat"] = max(
        float((g.float() - f["grads"][n].float()).abs().max()
              / f["grads"][n].float().abs().max().clamp_min(1e-30))
        for h, f in zip(runs[True], runs[False])
        for n, g in h["grads"].items())
    return line


SYNC_BN = dict(stage_sizes=[1, 1], num_filters=16, num_classes=10)
SYNC_BN_BATCH, SYNC_BN_IMAGE = 32, 32
SYNC_BN_FWD_TOL = 1e-5
SYNC_BN_GRAD_TOL = 1e-4


def run_sync_bn_rank(rank, port, outdir, device):
    """One rank of ``sync_bn``: its quarter of the batch through the
    sync-BN ResNet on ``dp=4``, beside the local-BN reference on the
    whole batch."""
    import horovod_tpu_torch as hvd
    from ..data import sync_bn
    from ..models.resnet import ResNet
    from ..parallel.mesh import create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    dev = hvd.device()
    mesh = create_mesh(dp=WORLD)
    gen = torch.Generator().manual_seed(3)
    images = torch.rand(SYNC_BN_BATCH, SYNC_BN_IMAGE, SYNC_BN_IMAGE, 3,
                        generator=gen).to(dev)
    g = torch.randn(SYNC_BN_BATCH, SYNC_BN["num_classes"],
                    generator=gen).to(dev)
    kw = dict(SYNC_BN, dtype=torch.float32, device=dev)
    ref = ResNet(generator=torch.Generator().manual_seed(0), **kw)
    logits_ref = ref(images)
    (logits_ref * g).sum().backward()
    logits_ref = logits_ref.detach()
    model = ResNet(bn_axis_name="dp", mesh=mesh,
                   generator=torch.Generator().manual_seed(0), **kw)
    n = SYNC_BN_BATCH // WORLD
    mine = slice(rank * n, (rank + 1) * n)
    calls = []
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        _sync(dev)
        t0 = time.perf_counter()
        logits = model(images[mine])
        _sync(dev)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_calls = list(calls)
    finally:
        dist.all_reduce = real
    loss = (logits * g[mine]).sum()
    loss.backward()
    gathered = [torch.empty_like(logits) for _ in range(WORLD)]
    dist.all_gather(gathered, logits.detach().contiguous())
    logits_err = float((torch.cat(gathered) - logits_ref).abs().max()
                       / logits_ref.abs().max())
    total = loss.detach().clone()
    dist.all_reduce(total)
    ref_grads = dict(ref.named_parameters())
    err = 0.0
    for name, p in model.named_parameters():
        grad = p.grad.clone()
        dist.all_reduce(grad)
        want = ref_grads[name].grad
        err = max(err, float((grad - want).abs().max()
                             / want.abs().max().clamp_min(1e-30)))
    bns = [m for m in model.modules()
           if isinstance(m, sync_bn.SyncBatchNorm)]
    line = {"mesh": {"dp": WORLD}, "loss": float(total),
            "reference_loss": float((logits_ref * g).sum()),
            "logits_rel_err": logits_err, "max_grad_rel_err": err,
            "bn_layers": len(bns),
            "allreduces_per_forward": len(fwd_calls),
            "allreduce_numels": sorted(set(fwd_calls)),
            "one_2c_allreduce_per_bn": fwd_calls == [
                2 * m.scale.numel() for m in bns],
            "forward_ms": fwd_ms, "peak_mib": None}
    hvd.shutdown()
    torch.save(line, os.path.join(outdir, f"rank{rank}.pt"))


def _sync_bn(device):
    """``sync_bn``'s line: rank 0's, with every rank's worst errors."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_sync_bn_rank, args=(_free_port(), outdir, device),
                 nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    line = dict(ranks[0])
    for key in ("logits_rel_err", "max_grad_rel_err"):
        line[key] = max(r[key] for r in ranks)
    line["one_2c_allreduce_per_bn"] = all(r["one_2c_allreduce_per_bn"]
                                          for r in ranks)
    return line


def run_ckpt_rank(rank, port, layers, outdir, device, width, ckdir):
    """One rank of ``ckpt_zero1``."""
    import horovod_tpu_torch as hvd
    from ..checkpoint import CheckpointEngine, sharded_layout, tree_keys
    from ..elastic import ElasticState
    from ..models import transformer as tfm
    from ..parallel.mesh import create_mesh
    from ..parallel.train import build_train_step
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    dev = hvd.device()
    cfg = _config(tfm, width, layers)
    step = build_train_step(cfg, _factory, mesh=create_mesh(dp=WORLD),
                            device=dev)
    tok = torch.randint(0, width["vocab"], (4, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    batch = (step.shard_batch(tok[:, :-1].to(dev)),
             step.shard_batch(tok[:, 1:].to(dev)))

    def fresh(seed):
        model = step.make_model(generator=torch.Generator().manual_seed(seed))
        return model, step.make_optimizer(model, zero1=True)

    def tensors(sd):
        return {k: v.detach().clone() for k, v in tree_keys(sd)
                if torch.is_tensor(v)}

    model, opt = fresh(0)
    for _ in range(2):
        step(model, opt, *batch)
    state = ElasticState(directory=ckdir, backend="sharded", model=model,
                         optimizer=opt)
    _sync(dev)
    t0 = time.perf_counter()
    state.commit(2)
    blocked_ms = (time.perf_counter() - t0) * 1e3
    state.wait()
    line = {"blocks": {k: v.cpu() for k, v in
                       tensors(opt.state_dict()).items()},
            "held": {k: ll.held for k, ll in
                     opt.checkpoint_layouts().items()},
            "blocked_ms": blocked_ms, "save_s": state.engine.save_s}
    line["reference_loss"] = float(step(model, opt, *batch))
    want = {**tensors(model.state_dict()), **tensors(opt.state_dict())}
    del model, opt, state
    model, opt = fresh(1)
    _sync(dev)
    t0 = time.perf_counter()
    state = ElasticState(directory=ckdir, backend="sharded", model=model,
                         optimizer=opt)
    state.restore()
    _sync(dev)
    line["restore_s"] = time.perf_counter() - t0
    line["restored_step"] = state.step
    line["loss"] = float(step(model, opt, *batch))
    got = {**tensors(model.state_dict()), **tensors(opt.state_dict())}
    line["resumed_bitwise"] = got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)
    line["max_grad_rel_err"] = max(
        float((got[k].float() - want[k].float()).abs().max()
              / want[k].float().abs().max().clamp_min(1e-30))
        for k in want if got[k].numel())
    if rank == 0:
        eng = CheckpointEngine(ckdir)
        man = eng.restore_manifest()
        line["commit_bytes"] = sum(s["nbytes"] for e in man["leaves"]
                                   for s in e["shards"])
        split = {e["key"]: e for e in man["leaves"] if len(e["shards"]) > 1}
        layouts = {}
        for key, e in split.items():
            n = e["shape"][0] // 2
            layouts[key] = sharded_layout(
                e["shape"], e["dtype"],
                [(((k * n, (k + 1) * n),), k) for k in range(2)])
        dp2 = {k: torch.full(e["shape"], float("nan")) for k, e in
               split.items()}
        for p in range(2):
            for key, blocks in eng.restore_addressable(
                    layouts, process_index=p).items():
                for shard, arr in blocks:
                    dp2[key][shard.slices] = torch.from_numpy(arr)
        line["dp2"] = dp2
    hvd.shutdown()
    torch.save(line, os.path.join(outdir, f"rank{rank}.pt"))


def _ckpt_zero1(layers, device, width):
    """``ckpt_zero1``'s line: rank 0's, with every rank's restore and
    the dp = 2 reassembly held to the four ranks' blocks."""
    with tempfile.TemporaryDirectory() as outdir, \
            tempfile.TemporaryDirectory() as ckdir:
        mp.spawn(run_ckpt_rank, args=(_free_port(), layers, outdir, device,
                                      width, ckdir), nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    dp2 = ranks[0].pop("dp2")
    exact = bool(dp2)
    for key, got in dp2.items():
        local = key[len("['optimizer']"):]
        want = torch.full_like(got, float("nan"))
        for r in ranks:
            (a, b), = r["held"][local]
            want[a:b] = r["blocks"][local]
        exact &= torch.equal(got, want)
    line = {k: v for k, v in ranks[0].items() if k not in ("blocks",
                                                             "held")}
    line.update(mesh={"dp": WORLD}, layers=layers, sharded_leaves=len(dp2),
                restored_steps=[r["restored_step"] for r in ranks],
                resumed_bitwise=all(r["resumed_bitwise"] for r in ranks),
                max_grad_rel_err=max(r["max_grad_rel_err"] for r in ranks),
                dp2_reassembly_bitwise=exact, peak_mib=None)
    return line


DECODE_SLOTS, DECODE_STEPS, DECODE_BLOCK = 4, 16, 16
DECODE_TOL = 1e-2   # tp = 2 logits against tp = 1, of max |logit|


def _decode_run(model, kv, tables, prompts, steps, dev):
    """Prefill of ``prompts`` ([slots, L], row r real up to its length)
    then ``steps`` [slots, 1] decode calls on a fresh pool: the logits of
    every call (fp32, host) and the pool."""
    lens, tok = prompts
    cache = model.init_cache(int(tables.max()) + 1, DECODE_BLOCK, kv)
    out = []
    with torch.inference_mode():
        lg, _ = model.apply_decode(tok.to(dev), torch.zeros_like(lens).to(dev),
                                   tables.to(dev), cache, kv_quant=kv,
                                   exact_chunk=True)
        out.append(lg.float().cpu())
        for i, nxt in enumerate(steps):
            lg, _ = model.apply_decode(nxt.to(dev), (lens + i).to(dev),
                                       tables.to(dev), cache, kv_quant=kv)
            out.append(lg.float().cpu())
    return out, [{k: v.cpu() for k, v in layer.items()} for layer in cache]


def run_decode_rank(rank, port, layers, outdir, device, width):
    """One rank of ``decode_tp``: its dp pair's prefill and decode steps
    at tp = 2 (this rank's heads) and at tp = 1 on its own card, on the
    same weights and tokens, for the bf16 and the int8 pool."""
    import dataclasses
    import horovod_tpu_torch as hvd
    from ..models import transformer as tfm
    from ..parallel.collectives import axis_index
    from ..parallel.mesh import create_mesh, place, shard_tree
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    dev = hvd.device()
    mesh = create_mesh(dp=2, tp=2)
    dp, tp = axis_index(mesh, "dp"), axis_index(mesh, "tp")
    cfg1 = _config(tfm, width, layers)
    cfg2 = dataclasses.replace(cfg1, tp_axis="tp")
    params = tfm.init_params(cfg1, torch.Generator().manual_seed(0))
    one = tfm.Transformer(cfg1, params=params, device=dev)
    two = tfm.Transformer(cfg2, device=dev, mesh=mesh, params=shard_tree(
        params, tfm.param_specs(cfg2), *place(mesh)))
    gen = torch.Generator().manual_seed(100 + dp)
    seq = width["max_seq"] // 4
    lens = torch.randint(seq // 4, seq - DECODE_STEPS, (DECODE_SLOTS,),
                         generator=gen)
    tok = torch.randint(0, width["vocab"], (DECODE_SLOTS, seq),
                        generator=gen)
    steps = [torch.randint(0, width["vocab"], (DECODE_SLOTS, 1),
                           generator=gen) for _ in range(DECODE_STEPS)]
    per = -(-seq // DECODE_BLOCK)
    tables = 1 + torch.arange(DECODE_SLOTS * per).reshape(DECODE_SLOTS, per)
    h = cfg1.n_heads // 2
    line = {"mesh": {"dp": 2, "tp": 2}, "layers": layers, "dp": dp,
            "tp": tp, "slots": DECODE_SLOTS, "steps": DECODE_STEPS}
    for kv in (None, "int8"):
        ref, ref_pool = _decode_run(one, kv, tables, (lens, tok), steps, dev)
        got, pool = _decode_run(two, kv, tables, (lens, tok), steps, dev)
        name = kv or "bf16"
        line[f"{name}_logits_rel_err"] = max(
            float((g - r).abs().max() / r.abs().max())
            for g, r in zip(got, ref))
        mine = [{k: v[:, :, tp * h:(tp + 1) * h] for k, v in layer.items()}
                for layer in ref_pool]
        same = [{k: torch.equal(layer[k][1:], full[k][1:]) for k in layer}
                for layer, full in zip(pool, mine)]
        line[f"{name}_layer0_bitwise"] = all(same[0].values())
        line[f"{name}_layers_bitwise"] = [all(s.values()) for s in same]
    hvd.shutdown()
    torch.save(line, os.path.join(outdir, f"rank{rank}.pt"))


def _decode_tp(layers, device, width):
    """``decode_tp``'s line: every rank's worst logits error, and whether
    layer 0's pools (the K and V of the embeddings, no psum before them)
    hold the same bits at tp = 2 as the same heads at tp = 1."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_decode_rank, args=(_free_port(), layers, outdir,
                                        device, width), nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
    line = {k: v for k, v in ranks[0].items() if k not in ("dp", "tp")}
    for name in ("bf16", "int8"):
        line[f"{name}_logits_rel_err"] = max(
            r[f"{name}_logits_rel_err"] for r in ranks)
        line[f"{name}_layer0_bitwise"] = all(
            r[f"{name}_layer0_bitwise"] for r in ranks)
        line[f"{name}_layers_bitwise"] = [
            all(r[f"{name}_layers_bitwise"][i] for r in ranks)
            for i in range(layers)]
    return line


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(layers, device="cuda", width=FLAGSHIP, variants=None):
    """{variant: rank 0's line, with the worst gradient error and peak
    memory of all ranks (and, for a pipeline variant, whether every rank
    was bit for bit)}; ``variants`` defaults to all."""
    variants = list(variants or (*VARIANTS, *PIPE_VARIANTS, "hier_engine",
                                 "sync_bn", "ckpt_zero1", "decode_tp"))
    mesh_variants = [v for v in variants
                     if v not in ("hier_engine", "sync_bn", "ckpt_zero1",
                                  "decode_tp")]
    ranks = []
    if mesh_variants:
        with tempfile.TemporaryDirectory() as outdir:
            mp.spawn(run_rank, args=(_free_port(), layers, outdir, device,
                                     width, mesh_variants), nprocs=WORLD)
            ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                     for r in range(WORLD)]
    lines = {}
    if "hier_engine" in variants:
        lines["hier_engine"] = _hier_engine(layers, device, width)
    if "sync_bn" in variants:
        lines["sync_bn"] = _sync_bn(device)
    if "ckpt_zero1" in variants:
        lines["ckpt_zero1"] = _ckpt_zero1(layers, device, width)
    if "decode_tp" in variants:
        lines["decode_tp"] = _decode_tp(layers, device, width)
    for name in mesh_variants:
        line = dict(ranks[0][name])
        line["max_grad_rel_err"] = max(r[name]["max_grad_rel_err"]
                                       for r in ranks)
        if line["peak_mib"] is not None:
            line["peak_mib"] = max(r[name]["peak_mib"] for r in ranks)
        if "bitwise" in line:
            line["bitwise"] = all(r[name]["bitwise"] for r in ranks)
        lines[name] = line
    for name, line in lines.items():
        if name != "decode_tp":   # no loss: a forward-only check
            line["loss_rel_err"] = (abs(line["loss"]
                                        - line["reference_loss"])
                                    / abs(line["reference_loss"]))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    names = (*VARIANTS, *PIPE_VARIANTS, "hier_engine", "sync_bn",
             "ckpt_zero1", "decode_tp")
    ap.add_argument("--variants", help="comma-separated names (default: "
                    f"all of {', '.join(names)})")
    args = ap.parse_args(argv)
    variants = args.variants.split(",") if args.variants else None
    unknown = set(variants or ()) - set(names)
    if unknown:
        sys.exit(f"mesh_parity: unknown variants {sorted(unknown)}")
    if torch.cuda.device_count() < WORLD:
        sys.exit(f"mesh_parity: needs {WORLD} CUDA cards, found "
                 f"{torch.cuda.device_count()}")
    print(device_line(), flush=True)
    ok = True
    for name, line in run(args.layers, variants=variants).items():
        print(json.dumps({"variant": name, **line}), flush=True)
        if name != "decode_tp":
            ok &= (line["loss_rel_err"] <= LOSS_TOL
                   and line["max_grad_rel_err"] <= GRAD_TOL
                   and line.get("grad_rel_err_vs_flat", 0.0) <= HIER_TOL
                   and line.get("allgather_exact", True))
        if name == "sync_bn":
            ok &= (line["logits_rel_err"] <= SYNC_BN_FWD_TOL
                   and line["max_grad_rel_err"] <= SYNC_BN_GRAD_TOL
                   and line["one_2c_allreduce_per_bn"])
        if name == "decode_tp":
            ok &= (line["bf16_logits_rel_err"] <= DECODE_TOL
                   and line["int8_logits_rel_err"] <= DECODE_TOL
                   and (line["int8_layer0_bitwise"]
                        or not line["bf16_layer0_bitwise"]))
        if name == "ckpt_zero1":
            ok &= (line["resumed_bitwise"]
                   and line["loss"] == line["reference_loss"]
                   and line["restored_steps"] == [2] * WORLD
                   and line["dp2_reassembly_bitwise"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
