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

and rank 0's adaptation policy over the engine:

- ``adapt``: the dp step of the flagship (``--layers`` deep) on every
  rank through the engine's buckets, each rank its own sequence, with
  ``HOROVOD_TPU_ADAPTATION=1`` (threshold ``ADAPT_KNOBS``, short sustain
  and cooldown, no failure timeout, so ``evict`` stays gated off) and
  the last rank delayed ``ADAPT_DELAY_MS`` per enqueued collective for
  a window of its enqueues (``HOROVOD_TPU_FAULT_SPEC``). The ladder must
  climb ``shrink``, ``bf16``, ``int8x256``, ``fp8x256`` in that order,
  the first escalation no earlier than the first step that delayed the
  last rank, and unwind in reverse, every de-escalation after the last
  such step; a run of ``ADAPT_QUIET_STEPS`` steps without the fault,
  first, must not escalate at all. Every rank must move each
  group on the same wire (``Handle.wire``) and hold the same wire
  epochs; and every group's reduced gradients must equal, bit for bit,
  the same tensors reduced again in one group with that wire named
  explicitly (``Compression.bf16``, ``int8_blockwise``,
  ``fp8_blockwise``, or none) once the ladder is back at raw. Each rank
  runs one forward and backward before its optimizer exists and waits
  for the others at a barrier on the default group, so the kernels'
  build and first launches put no skew into the lateness. Its line holds
  the first and last step the fault delayed, the quiet run's steps,
  median step ms and escalations, each transition's seconds since the first step (and the
  step), the steps and median step ms on each tier on the way up
  (``upN``) and down (``downN``), the decayed lateness by rank at the
  end, and the worst difference.

and the numerics plane and the autotuners:

- ``numerics``: ``HOROVOD_TPU_NUMERICS=1``, the fingerprint probe every
  step of the dp step. A clean run (the mesh step at dp = 4 plain and under
  ZeRO-1, then the dp step through the engine, ``NUMERICS_STEPS`` steps
  each) must fire no alert on any rank, every rank must hold the same
  aux values, bit for bit, and ZeRO-1's grad norm must be the plain
  step's within ``ZERO1_NORM_TOL`` (first step, same weights). Then the
  dp step again under ``rank=1:bitflip_param=1:leaf=wq;rank=2:nan_at=T``
  (T: the first bucket of the last step): rank 0's compare must name
  rank 1 and ``['layers'][0]['wq']`` at step 1 and nothing else, and
  only rank 2 must alert ``nonfinite_rate`` on a payload, naming rank 2.
- ``autotune``: ``AutoTuner.tune_rebuild`` over pipeline schedule x
  microbatches (4, 8, 16, 32) on the pipelined step at pp = 4 of
  ``AUTOTUNE_LAYERS`` layers, ``AUTOTUNE_BATCH`` sequences of
  ``AUTOTUNE_SEQ`` tokens: JAX's cold-start search
  (``bench_engine.py:1443-1540``), each trial's median step time the
  largest of the ranks' (so every rank halves alike); its line holds the
  trials and the winner. Then the dp step through the engine,
  ``LIVE_STEPS`` steps twice from the same weights: without moves, and
  with rank 0's tuner moving ``fusion_threshold_mb`` to 16 before step
  ``FUSION_AT`` and ``dcn_wire_spec`` to ``bf16`` before step
  ``WIRE_AT``. Rank 0's planner, which cuts every rank's groups, must
  hold the fusion epoch at the verdict's ``from_seq``, every rank the
  same wire epochs and the same groups; the groups before the wire
  epoch must move raw and those from it on bf16 on every rank; the
  losses must equal the run without the moves bit for bit up to the
  wire epoch (the fusion flip changes the grouping, not the sums; the
  bf16 wire changes the numbers by design, within 1e-2 after it).

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

and the serving engine over tp ranks:

- ``serve_tp``: the seed-0 bf16 flagship at its full depth (12 layers,
  whatever ``--layers`` says), committed through ``checkpoint_hook`` and
  served by ``python -m horovod_tpu_torch.serving --tp 2`` on cards 0-1
  (``CUDA_VISIBLE_DEVICES=0,1``: rank 0 schedules and broadcasts each
  forward's step message, rank 1 follows) to ``chip_smoke.py`` phase
  21's 8 requests at once (prompts of 32-1984 tokens, 64 new each,
  greedy; 8 slots, 16-token blocks, 1025 blocks), after a warm-up of
  the same prompts at 2 new tokens; the same at ``--kv-quant int8``.
  The reference is an in-process tp = 1 engine of the same
  configuration on card 2, from the same weights. Its line holds
  whether the tokens are equal, each divergence's logit gap (the full
  forward's logits of the two tokens at the first divergent position,
  of max |logit|: past ``SERVE_TOL``, 3e-2, it fails, as phase 21
  judges), the mean decode step ms of the 8-request run at tp = 2 (the
  replica's ``hvdtpu_serving_decode_step_seconds`` over
  ``/metrics.json``) and at tp = 1 (the same family in process), and
  rank 0's step messages: how many, and its host ms a message. Then two
  ranks on cards 0-1 split that decode step's cost: the median ms of
  the flagship's ``[8, 1]`` tp = 2 decode forward (every slot at
  position 1000 over its whole 128-block table; host clock to rank 0's
  host copy of the logits, 20 steps) with both ranks given the inputs,
  the same with rank 0's step message before each (rank 1 following,
  as the engine does), and the step message alone (20 back to back, to
  a synchronize on rank 0); then 5 forwards under ``torch.profiler`` on
  rank 0: the device's busy share, and the host ops that take the most
  self CPU ms a step.

and the offline tools and the framework shims over four ranks:

- ``tools``: the dp step through the engine (``--layers`` deep, one
  sequence a rank) for ``TOOLS_STEPS`` steps under ``StepMetrics`` with
  the timeline armed (``timeline.{rank}.json``); ``python -m
  horovod_tpu_torch.tools.trace merge`` of the four files must align
  them on rank 0's clock (four rank rows, every clock synced, groups
  scored, execute seconds > 0 on every rank: the ``NCCL_*`` spans).
  Then a second run with the blackbox armed and rank 2 set to
  ``crash_at`` the first enqueue of the step after step
  ``TOOLS_ARM_STEP`` (its previous step ended on the host); the others
  fail on the closed pairs (or are SIGTERMed 30 s after it). The port's
  ``postmortem`` of the dumps must name rank 2 (``fault_crash``) and
  the first divergent group, one past the last all ranks completed;
- ``shims``: the mxnet shim's collectives over NDArrays on each rank's
  card, from distinct per-rank inputs, in every dtype of its sweep
  (uint8 ... float64): the sum, ``broadcast`` from root 3 and
  ``allgather``'s rank order equal numpy's exactly, as do
  ``allreduce_multi_``'s averages and ``broadcast_parameters``.

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

import numpy as np
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
# adapt: the ladder's knobs, the straggler's delay and fault window (its
# enqueue ticks), and the step budget.
ADAPT_KNOBS = {"ADAPTATION": "1", "ADAPT_THRESHOLD": "0.05",
               "ADAPT_SUSTAIN": "0.25", "ADAPT_COOLDOWN": "0.25",
               "ADAPT_INTERVAL": "0", "FAILURE_TIMEOUT": "0"}
ADAPT_DELAY_MS = 100
ADAPT_WINDOW = (40, 100)
ADAPT_MAX_STEPS = 150
ADAPT_QUIET_STEPS = 20      # the run without the fault
ADAPT_LADDER = ["shrink", "bf16", "int8x256", "fp8x256"]
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


def _explicit_compression(wire):
    from ..compression import Compression
    return {None: Compression.none, "bf16": Compression.bf16,
            "int8x256": Compression.int8_blockwise,
            "fp8x256": Compression.fp8_blockwise}[wire]


def run_adapt_rank(rank, port, layers, outdir, device, width, world,
                   fault=True):
    """One rank of ``adapt``: the dp step under the policy, its groups
    recorded (inputs, outputs, the wire each moved on), then replayed
    with the wire named explicitly. Without ``fault`` no rank is delayed
    and the run takes ``ADAPT_QUIET_STEPS`` steps, recording no group."""
    for knob, value in ADAPT_KNOBS.items():
        os.environ["HOROVOD_TPU_" + knob] = value
    if fault:
        os.environ["HOROVOD_TPU_FAULT_SPEC"] = (
            f"rank={world - 1}:delay={ADAPT_DELAY_MS}ms:"
            f"from_step={ADAPT_WINDOW[0]}:until_step={ADAPT_WINDOW[1]}")
    else:
        os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
    if device == "cpu":
        # The ranks share the host's cores: one thread each keeps a
        # rank's lateness the fault's, not the scheduler's.
        torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from ..adaptation import faults as tfaults
    from ..models import transformer as tfm
    from ..observability import flight_recorder as tfr
    from ..observability import registry as treg
    from ..ops import collective as coll
    from ..parallel.train import build_train_step
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=world)
    dev = hvd.device()
    tok = torch.randint(0, width["vocab"], (world, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    mine = slice(rank, rank + 1)
    tokens, targets = tok[mine, :-1].to(dev), tok[mine, 1:].to(dev)
    cfg = _config(tfm, width, layers)
    step = build_train_step(cfg, _factory, device=dev)
    model = step.make_model(
        params=tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    # Warm up (the kernels' build, the first launches) before the
    # optimizer's hooks exist, so no collective carries the ranks'
    # start-up skew into the policy's lateness.
    model.loss_fn(tokens, targets).backward()
    for p in model.parameters():
        p.grad = None
    _sync(dev)
    # The ranks leave the warm-up together, on the default group: a
    # barrier through the engine would feed the skew tracker.
    dist.barrier(**({"device_ids": [dev.index]} if dev.type == "cuda"
                    else {}))
    opt = step.make_optimizer(model)
    fires = []          # this step's (name, input copy, handle)
    inner = opt._fire_buckets

    def fire(buckets, trigger):
        ins = [b.buffer.detach().clone() for b in buckets]
        inner(buckets, trigger)
        fires.extend((b.name, x, opt._handles[b.index])
                      for b, x in zip(buckets, ins))
    if fault:
        opt._fire_buckets = fire
    groups, ms, tiers, events = [], [], [], []
    ticks = []          # the faulted rank's enqueue ticks at each step
    inj = tfaults.injector() if fault else None
    t0 = time.monotonic()
    seen_t = t0
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    for k in range(ADAPT_MAX_STEPS if fault else ADAPT_QUIET_STEPS):
        fires.clear()
        tick0 = inj.tick if inj is not None else None
        _sync(dev)
        t = time.perf_counter()
        step(model, opt, tokens, targets)
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        # Each group's inputs and outputs, kept on the host: at the
        # flagship's width a step's buckets are ~0.4 GB.
        by_name = {b.name: b for b in opt._buckets}
        for g in dict.fromkeys(h.group for _, _, h in fires):
            members = [(n, x, h) for n, x, h in fires if n in g]
            groups.append((k, members[0][2].wire,
                           [x.to("cpu", copy=True) for _, x, _ in members],
                           [by_name[n].buffer.detach().to("cpu", copy=True)
                            for n, _, _ in members]))
        if rank == 0:
            for ts, kind, payload in list(tfr.recorder()._ring):
                if kind == "adapt" and ts > seen_t:
                    events.append((round(ts - t0, 3), payload[0],
                                   payload[2], k))
                    seen_t = ts
            snap = treg.snapshot("hvdtpu_adaptation_tier")
            tier = int(snap["hvdtpu_adaptation_tier"]["values"][""])
            tiers.append((tier, any(e[1] == "deescalate" for e in events)))
            climbed = [e for e in events if e[1] == "escalate"]
            done[0] = int(tier == 0 and len(climbed) >= len(ADAPT_LADDER))
            if done[0]:
                # Disarm the policy: the replay below must run raw. (A
                # wire epoch takes two more escalations, two sustain
                # windows, so none can slip in after this read.)
                coll.engine()._coord._policy = None
        hvd.broadcast_(done, 0, name=f"adapt.done.{k}")
        if inj is not None:
            ticks.append((tick0, inj.tick))
        if int(done[0]):
            break
    epochs = list(coll.engine()._wire_epochs)
    skew = coll.engine()._coord._skew
    lateness = ({r: round(v * 1e3, 3) for r, v in
                 skew.recent_lateness_by_rank().items()} if rank == 0 else {})
    # The replay needs raw epochs, or the policy's wire would move it too.
    worst = 0.0 if epochs and epochs[-1][1] == "" else None
    for i, (k, wire, ins, outs) in enumerate(groups if worst == 0.0
                                             else ()):
        # A cast compressor transforms the tensors before the request
        # and after it (what ``hvd.allreduce(compression=)`` does); a
        # blockwise one names the request's wire.
        comp = _explicit_compression(wire)
        packed = [comp.compress(x.to(dev)) for x in ins]
        ref = coll.fused_allreduce_async(
            [t for t, _ in packed], True,
            names=[f"adapt.ref.{i}.{j}" for j in range(len(ins))],
            compression=comp).wait()
        ref = [comp.decompress(r, ctx) for r, (_, ctx) in zip(ref, packed)]
        for r, o in zip(ref, outs):
            worst = max(worst, float((r.float().cpu() - o.float())
                                     .abs().max()))
    hvd.shutdown()
    torch.save({"wires": [(k, w) for k, w, _, _ in groups],
                "epochs": epochs, "ms": ms, "tiers": tiers,
                "events": events, "worst": worst, "lateness_ms": lateness,
                "ticks": ticks},
               os.path.join(outdir, f"rank{rank}.pt"))


def _adapt_ranks(layers, device, width, world, fault):
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_adapt_rank, args=(_free_port(), layers, outdir, device,
                                       width, world, fault), nprocs=world)
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                for r in range(world)]


def _adapt(layers, device, width, world=WORLD):
    """``adapt``'s line from every rank's record: first the run without
    the fault, then the one with it. The ladder is held to the fault's
    window: the first escalation in a step that delayed the last rank or
    later, every de-escalation after the last such step, and no
    escalation in the run without the fault."""
    quiet = _adapt_ranks(layers, device, width, world, False)[0]
    ranks = _adapt_ranks(layers, device, width, world, True)
    r0 = ranks[0]
    lo, hi = ADAPT_WINDOW
    faulted = [k for k, (a, b) in enumerate(ranks[-1]["ticks"])
               if a < hi and b > lo]
    climbed = [name for _, act, name, _ in r0["events"] if act == "escalate"]
    unwound = [name for _, act, name, _ in r0["events"]
               if act == "deescalate"]
    up_steps = [k for _, act, _, k in r0["events"] if act == "escalate"]
    down_steps = [k for _, act, _, k in r0["events"] if act == "deescalate"]
    quiet_climbs = [e for e in quiet["events"] if e[1] == "escalate"]
    by_tier = {}
    for (tier, down), ms in zip(r0["tiers"], r0["ms"]):
        by_tier.setdefault(f"{'down' if down else 'up'}{tier}", []).append(ms)
    wires = sorted({w for _, w in r0["wires"] if w})
    return {"transitions": r0["events"], "climbed": climbed,
            "unwound": unwound, "steps": len(r0["ms"]),
            "ms_by_tier": {t: {"steps": len(v),
                               "median_ms": sorted(v)[len(v) // 2]}
                           for t, v in by_tier.items()},
            "wires_seen": wires, "epochs": r0["epochs"],
            "final_lateness_ms": r0["lateness_ms"],
            "same_wires_every_rank": all(r["wires"] == r0["wires"]
                                         for r in ranks),
            "same_epochs_every_rank": all(r["epochs"] == r0["epochs"]
                                          for r in ranks),
            "max_abs_diff_vs_explicit": (
                None if any(r["worst"] is None for r in ranks)
                else max(r["worst"] for r in ranks)),
            "fault_steps": [faulted[0], faulted[-1]] if faulted else None,
            "quiet_steps": len(quiet["ms"]),
            "quiet_median_ms": sorted(quiet["ms"])[len(quiet["ms"]) // 2],
            "quiet_escalations": quiet_climbs,
            "ladder_ok": (climbed == ADAPT_LADDER
                          and unwound == ADAPT_LADDER[::-1]),
            "ladder_in_window": bool(
                faulted and up_steps and up_steps[0] >= faulted[0]
                and all(k > faulted[-1] for k in down_steps)),
            "quiet_ok": not quiet_climbs}


NUMERICS_STEPS = 3
ZERO1_NORM_TOL = 1e-4
FLIP_LEAF = "['layers'][0]['wq']"
AUTOTUNE_LAYERS, AUTOTUNE_BATCH, AUTOTUNE_SEQ = 8, 32, 512
LIVE_STEPS, FUSION_AT, WIRE_AT = 8, 2, 5


def _init_rank(rank, port, device):
    import horovod_tpu_torch as hvd
    if device == "cpu":
        torch.set_num_threads(1)
    hvd.init(device=f"cuda:{rank}" if device == "cuda" else device,
             init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    return hvd, hvd.device()


def _dp_run(hvd, tfm, width, layers, dev, steps, before_step=None,
            barrier=False):
    """The dp step through the engine on this rank's sequence from seed-0
    weights: (losses, the numerics aux of each step, the step object,
    the optimizer)."""
    from ..parallel.train import build_train_step
    rank = hvd.rank()
    tok = torch.randint(0, width["vocab"], (WORLD, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    tokens, targets = tok[rank:rank + 1, :-1].to(dev), \
        tok[rank:rank + 1, 1:].to(dev)
    cfg = _config(tfm, width, layers)
    step = build_train_step(cfg, _factory, device=dev)
    model = step.make_model(
        params=tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = step.make_optimizer(model)
    losses, auxes = [], []
    for k in range(steps):
        if before_step is not None:
            before_step(k, opt)
        losses.append(float(step(model, opt, tokens, targets)))
        if step.last_aux is not None:
            auxes.append({n: v.cpu() for n, v in step.last_aux.items()})
        if barrier:
            hvd.allreduce(torch.zeros(1, device=dev), name=f"bar.{k}")
    return losses, auxes, step, opt


def run_numerics_rank(rank, port, layers, outdir, device, width):
    """One rank of ``numerics``."""
    os.environ["HOROVOD_TPU_NUMERICS"] = "1"
    # The mesh steps take no probe: two step objects count their steps
    # from 0 alike, and rank 0 would mix their digests.
    os.environ["HOROVOD_TPU_NUMERICS_FP_INTERVAL"] = "0"
    os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
    hvd, dev = _init_rank(rank, port, device)
    from ..adaptation import faults as tfaults
    from ..models import transformer as tfm
    from ..observability import numerics as tnum
    from ..ops import collective as coll
    from ..parallel.mesh import create_mesh
    from ..parallel.train import build_train_step
    tok = torch.randint(0, width["vocab"], (WORLD, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    tokens, targets = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    cfg = _config(tfm, width, layers)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    out = {"aux": {}}
    for zero1 in (False, True):
        step = build_train_step(cfg, _factory, mesh=create_mesh(dp=WORLD))
        model = step.make_model(params=step.shard_params(params))
        opt = step.make_optimizer(model, zero1=zero1)
        auxes = []
        for _ in range(NUMERICS_STEPS):
            step(model, opt, step.shard_batch(tokens),
                 step.shard_batch(targets))
            auxes.append({n: v.cpu() for n, v in step.last_aux.items()})
        out["aux"]["zero1" if zero1 else "dp4"] = auxes
        del model, opt
    os.environ["HOROVOD_TPU_NUMERICS_FP_INTERVAL"] = "1"
    _, out["aux"]["engine"], _, _ = _dp_run(hvd, tfm, width, layers, dev,
                                            NUMERICS_STEPS, barrier=True)
    tnum.step_stats().flush()
    hvd.allreduce(torch.zeros(1, device=dev), name="clean.end")
    out["clean_alerts"] = [(a.kind, a.evidence)
                           for a in tnum._alert_monitor().alerts]
    # The faults: the engine resolves the spec at its next enqueue.
    n_buckets = len(_dp_run(hvd, tfm, width, layers, dev, 0)[3]._buckets)
    nan_tick = (NUMERICS_STEPS - 1) * (n_buckets + 3)
    os.environ["HOROVOD_TPU_FAULT_SPEC"] = (
        f"rank=1:bitflip_param=1:leaf=wq;rank=2:nan_at={nan_tick}")
    tfaults.reset()
    coll.engine()._faults_tried = False
    tnum._monitor = None
    tnum.reset_fingerprints()
    _dp_run(hvd, tfm, width, layers, dev, NUMERICS_STEPS, barrier=True)
    tnum.step_stats().flush()
    time.sleep(0.2)
    hvd.allreduce(torch.zeros(1, device=dev), name="fault.end")
    out["fault_alerts"] = [(a.kind, a.evidence)
                           for a in tnum._alert_monitor().alerts]
    out["nan_tick"] = nan_tick
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _numerics(layers, device, width):
    """``numerics``'s line from every rank's record."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_numerics_rank, args=(_free_port(), layers, outdir,
                                          device, width), nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    same = all(all(torch.equal(a[k], b[k]) for a, b in
                   zip(r["aux"][name], ranks[0]["aux"][name]) for k in a)
               for r in ranks for name in ranks[0]["aux"])
    gn = float(ranks[0]["aux"]["dp4"][0]["grad_norm"])
    gz = float(ranks[0]["aux"]["zero1"][0]["grad_norm"])
    flips = sorted({(ev["rank"], ev["leaf"], ev["step"])
                    for kind, ev in ranks[0]["fault_alerts"]
                    if kind == "rank_divergence" and ev["step"] == 1})
    nans = {r: [(ev["rank"], ev["source"], ev["step"])
                for kind, ev in out["fault_alerts"]
                if kind == "nonfinite_rate" and ev["source"] == "collective"]
            for r, out in enumerate(ranks)}
    line = {"mesh": {"dp": WORLD}, "steps": NUMERICS_STEPS,
            "clean_alerts": sum(len(r["clean_alerts"]) for r in ranks),
            "aux_same_every_rank": same,
            "grad_norm": gn, "grad_norm_zero1": gz,
            "zero1_grad_norm_rel_err": abs(gz - gn) / gn,
            "aux_engine_last": {k: v.tolist() for k, v in
                                ranks[0]["aux"]["engine"][-1].items()},
            "bitflip_named": flips, "nan_tick": ranks[2]["nan_tick"],
            "nan_alerts_by_rank": nans}
    line["ok"] = (line["clean_alerts"] == 0 and same
                  and line["zero1_grad_norm_rel_err"] <= ZERO1_NORM_TOL
                  and flips == [(1, FLIP_LEAF, 1)]
                  and len(nans[2]) == 1 and nans[2][0][0] == 2
                  and not any(nans[r] for r in (0, 1, 3)))
    return line


def run_autotune_rank(rank, port, layers, outdir, device, width):
    """One rank of ``autotune``."""
    import torch.distributed as dist
    hvd, dev = _init_rank(rank, port, device)
    from ..autotune import AutoTuner, default_registry, enumerate_configs
    from ..models import transformer as tfm
    from ..ops import collective as coll
    from ..parallel import train as ttrain
    from ..parallel.mesh import create_mesh
    mesh = create_mesh(pp=WORLD)
    cfg = _config(tfm, dict(width, max_seq=AUTOTUNE_SEQ), AUTOTUNE_LAYERS)
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, width["vocab"], (AUTOTUNE_BATCH, AUTOTUNE_SEQ + 1),
                        generator=torch.Generator().manual_seed(3))

    def measure_s(config, budget):
        schedule, m = config["pipeline_schedule"], config["num_microbatches"]
        v = 2 if schedule == "interleaved" else 1
        step = ttrain.build_pipeline_train_step(
            cfg, mesh, lambda p: torch.optim.SGD(p, lr=1e-2),
            schedule=schedule, num_virtual=v, device=dev)
        model = step.make_model(params=step.shard_params(
            ttrain.to_pipeline_params(cfg, full, WORLD, v)))
        opt = step.make_optimizer(model)
        mb = AUTOTUNE_BATCH // m
        tok_mb = tok[:, :-1].reshape(m, mb, -1).to(dev)
        tgt_mb = tok[:, 1:].reshape(m, mb, -1).to(dev)
        step(model, opt, tok_mb, tgt_mb)        # warm-up
        times = []
        for _ in range(max(2, int(budget))):
            _sync(dev)
            t0 = time.perf_counter()
            step(model, opt, tok_mb, tgt_mb)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        # Every rank scores the slowest rank's median, so every rank's
        # search halves alike.
        t = torch.tensor([sorted(times)[len(times) // 2]], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def constraint(c):
        return (c["pipeline_schedule"] != "zb-h1"
                or c["num_microbatches"] >= WORLD)
    reg = default_registry(include=("pipeline_schedule", "num_microbatches"))
    tuner = AutoTuner(reg, trial_budget=1)
    t0 = time.perf_counter()
    best, trials = tuner.tune_rebuild(lambda c, b: -measure_s(c, b),
                                      constraint=constraint)
    out = {"search_s": time.perf_counter() - t0, "best": best,
           "trials": [(t.config["pipeline_schedule"],
                       t.config["num_microbatches"], t.rung, t.budget,
                       round(-t.score * 1e3, 3)) for t in trials],
           "candidates": len(enumerate_configs(
               [reg.get("pipeline_schedule"), reg.get("num_microbatches")],
               constraint=constraint))}
    eng = coll.engine()
    base, _, _, _ = _dp_run(hvd, tfm, width, layers, dev, LIVE_STEPS)
    verdicts, wires, at = {}, [], [0]

    def moves(k, opt):
        if rank == 0 and k == FUSION_AT:
            verdicts["fusion"] = eng.tuner_move("fusion_threshold_mb", 16)
        if rank == 0 and k == WIRE_AT:
            verdicts["wire"] = eng.tuner_move("dcn_wire_spec", "bf16")
        # Every rank enters the step after rank 0's moves.
        hvd.broadcast(torch.zeros(1, device=dev), 0, name=f"live.{k}")
        at[0] = k
        if k == 0:
            inner = opt._fire_buckets

            def fire(buckets, trigger):
                inner(buckets, trigger)
                wires.extend((at[0], opt._handles[b.index])
                             for b in buckets)
            opt._fire_buckets = fire
    moved, _, _, _ = _dp_run(hvd, tfm, width, layers, dev, LIVE_STEPS,
                             before_step=moves)
    out.update(base=base, moved=moved, verdicts=verdicts,
               wires=[(k, h.wire) for k, h in wires],
               groups=[(k, h.group) for k, h in wires],
               fusion_epochs=[list(e)
                              for e in eng._coord._arbiter.fusion_epochs],
               wire_epochs=[list(e) for e in eng._wire_epochs])
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _autotune(layers, device, width):
    """``autotune``'s line from every rank's record."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_autotune_rank, args=(_free_port(), layers, outdir,
                                          device, width), nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    r0 = ranks[0]
    v = r0["verdicts"]
    wire_from = v.get("wire", {}).get("from_seq", -1)
    moved, base = r0["moved"], r0["base"]
    prefix = all(a == b for a, b in zip(moved[:WIRE_AT], base[:WIRE_AT]))
    after = max(abs(a - b) / abs(b) for a, b in zip(moved[WIRE_AT:],
                                                    base[WIRE_AT:]))
    wires_ok = all(r["wires"] == r0["wires"] for r in ranks) and all(
        (w == "bf16") == (k >= WIRE_AT) for k, w in r0["wires"])
    line = {"mesh": {"pp": WORLD}, "layers": AUTOTUNE_LAYERS,
            "batch": AUTOTUNE_BATCH, "seq": AUTOTUNE_SEQ,
            "candidates": r0["candidates"], "trials": r0["trials"],
            "best": r0["best"], "search_s": r0["search_s"],
            "same_best_every_rank": all(r["best"] == r0["best"]
                                        for r in ranks),
            "verdicts": v, "fusion_epochs": r0["fusion_epochs"],
            "wire_epochs": r0["wire_epochs"],
            "groups_per_step": [len({g for k, g in r0["groups"] if k == s})
                                for s in range(LIVE_STEPS)],
            "same_groups_every_rank": all(r["groups"] == r0["groups"]
                                          for r in ranks),
            "same_epochs_every_rank": all(r["wire_epochs"]
                                          == r0["wire_epochs"]
                                          for r in ranks),
            "losses_base": base, "losses_moved": moved,
            "bitwise_before_wire": prefix,
            "rel_err_after_wire": after, "wires_ok": wires_ok}
    line["ok"] = (line["same_best_every_rank"]
                  and line["same_epochs_every_rank"]
                  and line["same_groups_every_rank"]
                  and v.get("fusion", {}).get("accepted", False)
                  and v.get("wire", {}).get("accepted", False)
                  and r0["fusion_epochs"][-1] == [
                      v["fusion"]["from_seq"], 16 << 20]
                  and r0["wire_epochs"] == [[wire_from, "bf16"]]
                  and prefix and after <= 1e-2 and wires_ok)
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


# serve_tp: chip_smoke.py phase 21's requests and engine.
SERVE_LENS = (32, 128, 256, 512, 768, 1024, 1536, 1984)
SERVE_NEW, SERVE_SLOTS, SERVE_BLOCK, SERVE_KV_BLOCKS = 64, 8, 16, 1025
SERVE_TOL = 3e-2        # a divergence's logit gap, of max |logit|
SERVE_LAYERS = 12
SERVE_TIMEOUT_S = 600


def _decode_stat(snap):
    """(sum, count) of the decode step histogram in a registry snapshot."""
    fam = snap.get("hvdtpu_serving_decode_step_seconds",
                   {"values": {"": {"sum": 0.0, "count": 0}}})
    h = fam["values"][""]
    return float(h["sum"]), int(h["count"])


def _decode_ms(before, after):
    return ((after[0] - before[0]) / max(after[1] - before[1], 1)) * 1e3


def _engine_tokens(model, prompts, kv):
    """The tp = 1 reference: a warm-up engine over every prompt at 2 new
    tokens, then the 8 requests at once; their tokens and mean decode
    step ms."""
    from ..observability import metrics_snapshot
    from ..serving import InferenceEngine, ServingConfig

    def engine():
        return InferenceEngine(model, ServingConfig(
            block_size=SERVE_BLOCK, kv_blocks=SERVE_KV_BLOCKS,
            max_batch_slots=SERVE_SLOTS, max_new_tokens=SERVE_NEW,
            max_queue=32, kv_quant=kv), device=model.device)

    eng = engine()
    for p in prompts:
        eng.submit(p, max_new_tokens=2)
    eng.run_until_idle()
    del eng
    eng = engine()
    before = _decode_stat(metrics_snapshot("hvdtpu_serving_decode_step"))
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_idle()
    after = _decode_stat(metrics_snapshot("hvdtpu_serving_decode_step"))
    return ([r.result(timeout=SERVE_TIMEOUT_S) for r in reqs],
            _decode_ms(before, after))


def _http(port, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_TIMEOUT_S)
    try:
        conn.request(method, path, None if body is None else
                     json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise AssertionError(f"{path} answered {resp.status}: {data!r}")
        return json.loads(data)
    finally:
        conn.close()


def _post_all(port, prompts, new):
    import threading
    out = [None] * len(prompts)

    def client(i):
        out[i] = _http(port, "POST", "/generate",
                       {"tokens": prompts[i], "max_new_tokens": new})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_TIMEOUT_S)
    if any(r is None for r in out):
        raise AssertionError("an HTTP client failed")
    return [r["tokens"] for r in out]


def _cli_tokens(ckpt, prompts, kv, device):
    """The CLI at ``--tp 2`` (cards 0-1 on CUDA): a warm-up of every
    prompt at 2 new tokens, then the 8 requests at once; their tokens,
    the replica's mean decode step ms over them, and rank 0's line on
    its step messages. SIGTERM must drain it to exit 0."""
    import re
    import signal
    import subprocess
    import threading
    env = dict(os.environ, HOROVOD_TPU_METRICS_PORT="0")
    if device == "cuda":
        env["CUDA_VISIBLE_DEVICES"] = "0,1"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.serving",
           "--checkpoint-dir", ckpt, "--framework", "torch", "--device",
           device, "--tp", "2", "--port", "0", "--host", "127.0.0.1",
           "--slots", str(SERVE_SLOTS), "--block-size", str(SERVE_BLOCK),
           "--kv-blocks", str(SERVE_KV_BLOCKS), "--max-new-tokens",
           str(SERVE_NEW)] + (["--kv-quant", kv] if kv else [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    err = []
    threading.Thread(target=lambda: err.extend(proc.stderr),
                     daemon=True).start()
    try:
        ready = proc.stdout.readline()
        m = re.search(r"ready on :(\d+).*metrics=:(\d+)", ready)
        if not m:
            raise AssertionError(f"no ready line: {ready!r} "
                                 f"{''.join(err)[-3000:]}")
        port, mport = int(m.group(1)), int(m.group(2))
        _post_all(port, prompts, 2)

        def stat():
            return _decode_stat(_http(
                mport, "GET",
                "/metrics.json?prefix=hvdtpu_serving_decode_step"))

        before = stat()
        toks = _post_all(port, prompts, SERVE_NEW)
        ms = _decode_ms(before, stat())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_TIMEOUT_S)
        time.sleep(0.5)   # the stderr reader's last lines
        if rc != 0:
            raise AssertionError(f"the tp = 2 server exited {rc}: "
                                 f"{''.join(err)[-3000:]}")
        msg = next((ln.split("<stderr>:", 1)[-1].strip() for ln in err
                    if "tp step messages" in ln), None)
        return toks, ms, msg
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)


def _judge(model, prompts, got, want):
    """Each request's first divergence between ``got`` and ``want``: the
    full forward's logits of the two tokens there, their gap of max
    |logit| (chip_smoke.py phase 21's judgment)."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        p = next(k for k in range(min(len(g), len(w))) if g[k] != w[k])
        with torch.inference_mode():
            row = model.apply(torch.tensor([prompts[i] + w[:p]],
                                           device=model.device))[0, -1]
        row = row.float()
        out.append({"request": i, "token": p, "gap": float(
            (row[g[p]] - row[w[p]]).abs() / row.abs().max())})
    return out


def run_serve_rank(rank, port, outdir, device, width):
    """One rank of ``serve_tp``'s split: the tp = 2 decode forward
    without and with the step message, and the message alone."""
    import dataclasses
    import statistics
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    from ..models import transformer as tfm
    from ..parallel.mesh import place, shard_tree
    from ..serving import StepChannel, tp_mesh
    from ..serving.engine import _FWD
    mesh = tp_mesh(2, device)
    dev = torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")
    cfg1 = _config(tfm, width, SERVE_LAYERS)
    cfg = dataclasses.replace(cfg1, tp_axis="tp")
    model = tfm.Transformer(cfg, device=dev, mesh=mesh, params=shard_tree(
        tfm.init_params(cfg1, torch.Generator().manual_seed(0)),
        tfm.param_specs(cfg), *place(mesh)))
    pool = model.init_cache(SERVE_KV_BLOCKS, SERVE_BLOCK)
    per = -(-cfg.max_seq // SERVE_BLOCK)
    tables = (1 + np.arange(SERVE_SLOTS * per, dtype=np.int32)).reshape(
        SERVE_SLOTS, per) % SERVE_KV_BLOCKS
    starts = np.full(SERVE_SLOTS, min(1000, cfg.max_seq - 1), np.int32)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_SLOTS, 1)).astype(np.int32)
    ch = StepChannel(mesh, "tp", dev, cfg.max_seq + SERVE_SLOTS
                     + SERVE_SLOTS * per)

    def fwd(t, s, b):
        with torch.inference_mode():
            logits, _ = model.apply_decode(
                torch.as_tensor(t).to(dev), torch.as_tensor(s).to(dev),
                torch.as_tensor(b).to(dev), pool)
        return logits

    def timed(step, n=20):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def plain():
        lg = fwd(tokens, starts, tables)
        if rank == 0:
            lg.float().cpu()

    def messaged():
        if rank == 0:
            ch.send(_FWD, tokens, starts, tables)
            fwd(tokens, starts, tables).float().cpu()
        else:
            fwd(*ch.recv()[1:])

    for _ in range(3):
        plain()
        messaged()
    _sync(dev)
    dist.barrier()
    line = {"forward_ms": timed(plain)}
    _sync(dev)
    dist.barrier()
    line["messaged_ms"] = timed(messaged)
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        if rank == 0:
            ch.send(_FWD, tokens, starts, tables)
        else:
            ch.recv()
    _sync(dev)
    line["message_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    dist.barrier()
    line["profile"] = _profiled(plain, rank == 0, dev)
    dist.destroy_process_group()
    torch.save(line, os.path.join(outdir, f"rank{rank}.pt"))


def _profiled(step, on, dev, n=5):
    """``n`` calls of ``step``, under ``torch.profiler`` where ``on``:
    the device's busy share of the window, and the 8 ops with the most
    self CPU ms a step (name, calls a step, ms a step)."""
    from torch.profiler import ProfilerActivity, profile
    if not on:
        for _ in range(n):
            step()
        return None
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        _sync(dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"busy": round(busy / 1e6 / wall, 4) if spans else None,
            "ms_a_step": round(wall / n * 1e3, 3),
            "top_self_cpu": [(e.key[:60], e.count // n,
                              round(e.self_cpu_time_total / 1e3 / n, 3))
                             for e in top[:8]]}


def _serve_tp(device, width):
    """``serve_tp``'s line (see the module docstring)."""
    import types
    from ..checkpoint import checkpoint_hook
    from ..models import transformer as tfm
    from ..serving import transformer_extra
    cfg = _config(tfm, width, SERVE_LAYERS)
    dev = torch.device("cuda", 2) if device == "cuda" else \
        torch.device("cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in SERVE_LENS]
    model = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    line = {"layers": SERVE_LAYERS, "requests": len(prompts),
            "new_tokens": SERVE_NEW, "slots": SERVE_SLOTS}
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint_hook(ckpt, model=types.SimpleNamespace(
            state_dict=model.params_tree), every=1,
            extra=transformer_extra(cfg))(0, block=True)
        for kv in (None, "int8"):
            name = kv or "bf16"
            ref, ref_ms = _engine_tokens(model, prompts, kv)
            got, ms, msg = _cli_tokens(ckpt, prompts, kv, device)
            ties = _judge(model, prompts, got, ref)
            line[f"{name}_tokens_equal"] = got == ref
            line[f"{name}_divergences"] = ties
            line[f"{name}_judged_ok"] = all(t["gap"] <= SERVE_TOL
                                            for t in ties)
            line[f"{name}_decode_ms_tp2"] = round(ms, 3)
            line[f"{name}_decode_ms_tp1"] = round(ref_ms, 3)
            line[f"{name}_step_messages"] = msg
    del model
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_serve_rank, args=(_free_port(), outdir, device, width),
                 nprocs=2)
        split = torch.load(os.path.join(outdir, "rank0.pt"))
    line.update({f"tp2_{k}": v if k == "profile" else round(v, 3)
                 for k, v in split.items()})
    return line


TOOLS_STEPS = 6         # tools: the clean run's steps
TOOLS_ARM_STEP = 2      # the crash run arms crash_at before this step
TOOLS_CRASH_RANK = 2
TOOLS_TIMEOUT_S = 600
SHIMS_ROOT = 3


def _ops_total():
    """Requests this rank's engine has taken (every op kind): the fault
    injector's ticks."""
    from ..observability import registry as reg
    fam = reg.snapshot("hvdtpu_ops_total").get("hvdtpu_ops_total")
    return sum(fam["values"].values()) if fam else 0.0


def run_tools_rank(rank, port, layers, outdir, device, width, crash):
    """One rank of ``tools``: the dp step through the engine under
    ``StepMetrics``, with the timeline armed (the clean run) or the
    blackbox (the crash run, in which rank ``TOOLS_CRASH_RANK`` is set
    to crash at the first enqueue of step ``TOOLS_ARM_STEP + 1``: its
    previous step ended on the host, so no collective of it is left on
    the card)."""
    os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
    if crash:
        os.environ["HOROVOD_TPU_BLACKBOX"] = os.path.join(outdir, "bb")
        os.environ["HOROVOD_TPU_BLACKBOX_INTERVAL"] = "1"
    else:
        os.environ["HOROVOD_TIMELINE"] = os.path.join(
            outdir, "timeline.{rank}.json")
    hvd, dev = _init_rank(rank, port, device)
    from ..adaptation import faults as tfaults
    from ..models import transformer as tfm
    from ..ops import collective as coll
    from ..parallel.train import build_train_step
    tok = torch.randint(0, width["vocab"], (WORLD, width["max_seq"] + 1),
                        generator=torch.Generator().manual_seed(5))
    tokens, targets = tok[rank:rank + 1, :-1].to(dev), \
        tok[rank:rank + 1, 1:].to(dev)
    cfg = _config(tfm, width, layers)
    step = build_train_step(cfg, _factory, device=dev)
    model = step.make_model(
        params=tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = step.make_optimizer(model)
    metrics = hvd.StepMetrics(batch_size=1, device=dev)
    per_step, losses = 0.0, []
    for k in range(TOOLS_STEPS):
        if crash and k == TOOLS_ARM_STEP:
            # Ticks count from the injector's creation: tick per_step is
            # the first enqueue of the step after this one.
            os.environ["HOROVOD_TPU_FAULT_SPEC"] = (
                f"rank={TOOLS_CRASH_RANK}:crash_at={int(per_step)}")
            tfaults.reset()
            coll.engine()._faults_tried = False
        before = _ops_total()
        with metrics:
            losses.append(float(step(model, opt, tokens, targets)))
        per_step = _ops_total() - before
    hvd.shutdown()
    torch.save({"losses": losses, "ops_per_step": per_step},
               os.path.join(outdir, f"rank{rank}.pt"))


def _spawn_crash(target, args, timeout_s, crash_rank):
    """``WORLD`` spawned ranks of ``target(rank, *args)`` of which
    ``crash_rank`` dies; their exit codes. Once that rank has exited the
    others get 30 s, then SIGTERM, as a launcher reaps survivors."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        procs[crash_rank].join(timeout_s)
        deadline = time.monotonic() + 30
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [p.exitcode for p in procs]


def _tool(name, *argv):
    """``tools.run``, its stderr's end written out on a failure: (exit
    code, stdout, host seconds)."""
    from ..tools import run as run_tool
    rc, out, err, secs = run_tool(name, *argv)
    if rc != 0:
        sys.stderr.write(err[-4000:])
    return rc, out, secs


def _tools(layers, device, width):
    """``tools``' line: ``trace merge`` of the clean run's four timelines
    onto rank 0's clock, and the port's ``postmortem`` of the crash
    run's dumps."""
    line = {"steps": TOOLS_STEPS}
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_tools_rank, args=(_free_port(), layers, outdir, device,
                                       width, False), nprocs=WORLD)
        line["losses"] = torch.load(os.path.join(outdir, "rank0.pt"))[
            "losses"]
        tpl = os.path.join(outdir, "timeline.{rank}.json")
        merged = os.path.join(outdir, "merged.json")
        rep = os.path.join(outdir, "trace.json")
        rc, _, secs = _tool("trace", "merge", tpl, "-o", merged,
                            "--report", rep)
        line["trace_merge_rc"], line["trace_merge_s"] = rc, secs
        if rc == 0:
            with open(rep) as f:
                report = json.load(f)
            with open(merged) as f:
                rows = {e["pid"] for e in json.load(f)
                        if e.get("name") == "process_name"}
            line.update(
                merged_ranks=sorted(rows),
                groups_scored=report["groups_scored"],
                clock_synced={r: c["synced"]
                              for r, c in report["clock"].items()},
                execute_mean_s={r: v["phase_mean_s"]["execute"]
                                for r, v in report["per_rank"].items()},
                top_straggler=(report["top_straggler"] or {}).get("rank"),
                bound=report["bound"])
        crash_dir = os.path.join(outdir, "crash")
        os.makedirs(crash_dir)
        line["crash_exit_codes"] = _spawn_crash(
            run_tools_rank, (_free_port(), layers, crash_dir, device, width,
                             True), TOOLS_TIMEOUT_S, TOOLS_CRASH_RANK)
        pm = os.path.join(outdir, "pm.json")
        rc, text, secs = _tool("postmortem", os.path.join(crash_dir, "bb"),
                               "--json", pm)
        line["postmortem_rc"], line["postmortem_s"] = rc, secs
        if rc == 0:
            with open(pm) as f:
                report = json.load(f)
            line.update(
                died_first=report["died_first"],
                ranks_dumped=report["ranks_dumped"],
                reasons={r: v["reason"]
                         for r, v in report["per_rank"].items()},
                common_last_group_seq=report["common_last_group_seq"],
                first_divergent_group_seq=report[
                    "first_divergent_group_seq"])
            print(text, file=sys.stderr, flush=True)
    line["ok"] = (
        line.get("merged_ranks") == list(range(WORLD))
        and line.get("groups_scored", 0) > 0
        and all(line.get("clock_synced", {}).values())
        and all(v > 0 for v in line.get("execute_mean_s", {0: 0}).values())
        and line.get("died_first", {}).get("rank") == TOOLS_CRASH_RANK
        and line["died_first"].get("how") == "fault_crash"
        and line.get("first_divergent_group_seq") is not None
        and line["first_divergent_group_seq"]
        == line["common_last_group_seq"] + 1)
    return line


def shims_inputs(rank, dtype, shape=(5, 3)):
    """Rank ``rank``'s input to ``shims``: small integers, so every sum
    is exact in every dtype."""
    rs = np.random.RandomState(200 + rank)
    return rs.randint(0, 10, size=shape).astype(dtype)


SHIMS_DTYPES = ("uint8", "int8", "int32", "int64", "float16", "float32",
                "float64")


def run_shims_rank(rank, port, outdir, device):
    """One rank of ``shims``: the mxnet shim's collectives over NDArrays
    on this rank's card, each from this rank's own input."""
    hvd, dev = _init_rank(rank, port, device)
    from .. import mxnet as mx
    from ..mxnet import nd
    out = {}
    for dt in SHIMS_DTYPES:
        x = nd.array(shims_inputs(rank, dt), dtype=dt)
        assert x.context == dev
        out[f"sum.{dt}"] = mx.allreduce(x, average=False).data.cpu()
        out[f"bcast.{dt}"] = mx.broadcast(x, SHIMS_ROOT).data.cpu()
        out[f"gather.{dt}"] = mx.allgather(x).data.cpu()
    ts = [nd.array(shims_inputs(rank, "float32") + i) for i in range(3)]
    mx.allreduce_multi_(ts, average=True, name_prefix="shims")
    out["multi_avg"] = [t.data.cpu() for t in ts]
    params = {"a": nd.array(shims_inputs(rank, "float32"))}
    mx.broadcast_parameters(params, root_rank=SHIMS_ROOT)
    out["params"] = params["a"].data.cpu()
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _shims(device):
    """``shims``' line: every rank's results against numpy."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(run_shims_rank, args=(_free_port(), outdir, device),
                 nprocs=WORLD)
        ranks = [torch.load(os.path.join(outdir, f"rank{r}.pt"))
                 for r in range(WORLD)]
    bad = []
    for dt in SHIMS_DTYPES:
        per = [shims_inputs(r, dt) for r in range(WORLD)]
        want = {"sum": sum(per), "bcast": per[SHIMS_ROOT],
                "gather": np.concatenate(per)}
        for r, res in enumerate(ranks):
            for k, v in want.items():
                got = res[f"{k}.{dt}"].numpy()
                if got.dtype != np.dtype(dt) or not np.array_equal(got, v):
                    bad.append(f"rank {r} {k}.{dt}")
    per = [shims_inputs(r, "float32") for r in range(WORLD)]
    for r, res in enumerate(ranks):
        for i, got in enumerate(res["multi_avg"]):
            if not np.array_equal(got.numpy(), sum(per) / np.float32(WORLD) + i):
                bad.append(f"rank {r} multi_avg.{i}")
        if not np.array_equal(res["params"].numpy(), per[SHIMS_ROOT]):
            bad.append(f"rank {r} broadcast_parameters")
    return {"dtypes": list(SHIMS_DTYPES), "root": SHIMS_ROOT,
            "mismatches": bad, "ok": not bad}


# The variants that run their own spawned jobs.
OWN_JOBS = ("hier_engine", "sync_bn", "ckpt_zero1", "decode_tp", "serve_tp",
            "adapt", "numerics", "autotune", "tools", "shims")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(layers, device="cuda", width=FLAGSHIP, variants=None):
    """{variant: rank 0's line, with the worst gradient error and peak
    memory of all ranks (and, for a pipeline variant, whether every rank
    was bit for bit)}; ``variants`` defaults to all."""
    variants = list(variants or (*VARIANTS, *PIPE_VARIANTS, *OWN_JOBS))
    mesh_variants = [v for v in variants if v not in OWN_JOBS]
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
    if "serve_tp" in variants:
        lines["serve_tp"] = _serve_tp(device, width)
    if "adapt" in variants:
        lines["adapt"] = _adapt(layers, device, width)
    if "numerics" in variants:
        lines["numerics"] = _numerics(layers, device, width)
    if "autotune" in variants:
        lines["autotune"] = _autotune(layers, device, width)
    if "tools" in variants:
        lines["tools"] = _tools(layers, device, width)
    if "shims" in variants:
        lines["shims"] = _shims(device)
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
        if name not in ("decode_tp", "serve_tp", "adapt", "numerics",
                        "autotune", "tools", "shims"):
            line["loss_rel_err"] = (abs(line["loss"]
                                        - line["reference_loss"])
                                    / abs(line["reference_loss"]))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    names = (*VARIANTS, *PIPE_VARIANTS, *OWN_JOBS)
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
        if name == "serve_tp":
            ok &= line["bf16_judged_ok"] and line["int8_judged_ok"]
        elif name == "adapt":
            ok &= (line["ladder_ok"] and line["ladder_in_window"]
                   and line["quiet_ok"] and line["same_wires_every_rank"]
                   and line["same_epochs_every_rank"]
                   and line["max_abs_diff_vs_explicit"] == 0.0)
        elif name in ("numerics", "autotune", "tools", "shims"):
            ok &= line["ok"]
        elif name != "decode_tp":
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
