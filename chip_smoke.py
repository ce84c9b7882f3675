#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: nvcc builds every kernel in ``horovod_tpu_torch/ops/csrc``
   (first use; one nvcc per source, all started together);
3. flash kernels K1-K3 against their plain PyTorch versions on the card
   at the flagship shape (B=8, H=6, S=2048, D=128, causal), a ragged
   causal shape (S=1000), the 128-row q tiles' edges (S=384: the
   diagonal across two key tiles; S=129; S=100: the second warpgroup's
   rows partly past S; S=192: the second warpgroup of the last q tile
   wholly past S), a non-causal D=64 shape and the head dims stored
   zero-padded to the next 64 columns (D=96 at the head_dim-96 LM's
   shape B=4, H=8, S=1024, and ragged; D=80; D=32); K1-K3 must repeat
   bit for bit. At the flagship, and at B=4, H=8, S=1024 with D=96 and
   D=128, the kernels, their plain versions and, as a yardstick only,
   PyTorch's ``scaled_dot_product_attention`` are timed back-to-back,
   and the kernels and SDPA as single calls too (the S=1024 shapes are
   logged only);
4. parity: a 2-layer LM with the flash kernels against the same model on
   plain attention, loss and gradients;
5. LM main path: ``init`` (NCCL, world 1), the 111M flagship LM,
   ``broadcast_parameters``, ``DistributedOptimizer(AdamW)`` and 5 train
   steps of 8 x 2048 tokens; the loss must be finite and fall, and each
   flash kernel must launch exactly 12 times per step. The gradients go
   through the collective engine in 7 buckets of the default 64 MiB cap,
   each of which must fire from its last gradient hook during backward
   in every step (none from the flush); each step logs the host ms of
   ``optimizer.synchronize()`` and the buckets fired from hooks and from
   the flush;
6. batch-norm kernels K4-K7 against their plain versions at (M, C) =
   (802816, 256), (3211264, 64) and (12544, 2048), each in the three
   variants ResNet-50 uses (ReLU, ReLU + residual, neither); repeated
   reductions must agree bit for bit. Each kernel is timed at (802816,
   256) beside its plain version and, as a yardstick only, PyTorch's
   unfused BN primitive, and in single calls at every BN layer of a
   ResNet-50 step (logged only);
7. parity: a small bf16 ResNet on the BN kernels against the same
   weights on the plain fused op: loss and running stats; gradients
   against the fp32 model, no farther from it than the plain bf16
   model's;
8. ResNet main path: ``ResNet50(bn_impl="pallas")``,
   ``broadcast_parameters``, ``DistributedOptimizer(SGD(0.01,
   momentum=0.9))`` and 5 train steps of 256 x 224 x 224 x 3 images; the
   loss must be finite and fall, each BN kernel must launch exactly 53
   times per step, and the gradients' 2 buckets must fire from their
   hooks in every step (logged as in phase 5). Then 5 steps of the same
   model on ``bn_impl="flax"`` (the JAX default, plain PyTorch) for
   comparison;
9. probes P1-P3: every probe kernel (copy, +1 map, stats-like reduce,
   the flash ablation's stream / matmul / nosoft) against its plain
   version at small shapes; then the three probe scripts'
   measurements at full size (P1's copy sweep over 411 MB, P2's sweep
   at [802816, 256], P3's four variants at the flagship shape, causal,
   64-row tiles), with every probe kernel launched at least once in
   them; then the timed configurations against their plain versions;
10. the collective engine on the card (``init`` again, NCCL, world 1):
   the dtype x dims sweep of ``tests/test_ops.py`` (uint8 ... bfloat16,
   1-3 dims of 17) through allreduce (sum, average, pre/postscale
   0.5/2.0), allgather and broadcast, each result bit for bit against
   the executor's arithmetic on CPU copies with the identity in place of
   the collective, and against what n = 1 gives in closed form (the
   input itself); scaled allreduces that truncate, saturate and overflow
   (int8, uint8, int64, fp16, bf16) bit for bit against the same
   arithmetic done element by element in Python floats; a burst of 160
   named allreduces of mixed dtypes whose fused groups must be the
   planner's; a producer on a side stream whose output is enqueued
   without a sync (the event fence); and the head_dim-96 LM (d_model
   768, 8 heads): the flash kernels against full attention, then three
   steps through the auto policy, which launches K1-K3 once per layer;
11. the blockwise wire on the card (``init`` again, NCCL, world 1):
   ``quantize_blocks`` (both scale forms), ``dequantize_blocks``,
   ``local_roundtrip`` and the e4m3 casts, int8 and fp8, at the LM's
   bucket sizes and a ragged length, bit for bit against the same
   functions on CPU copies; a blockwise ``allreduce`` through the engine
   at n = 1 bit for bit against ``dequant(quant(dequant(quant(x))))``
   computed on the CPU; 3 flagship LM steps on ``int8_blockwise`` with
   per-bucket error feedback (losses finite and falling; the device ms
   the quantize passes add per step, timed per bucket); and one
   ResNet-50 step each on the copy path, with ``gradient_as_bucket_view``
   and with one request per gradient, their gradients bit for bit
   (cuDNN deterministic for this check);
12. tensor and sequence parallelism: (a) the fp32-output forms of K1-K3
   (what ring attention launches) against their plain fp32 versions at
   the shapes a ring's shards take (D=128: S=2048, 1024 and 512, causal
   and not, and ragged S=1000; D=96: S=1024 causal and not, and ragged
   S=200), repeat-exact, and at the flagship shape timed back-to-back
   beside the bf16 forms; (b) a virtual ring at the flagship's attention
   (B=8, H=6, S=2048, D=128, causal) split into n = 2 and 4 shards: the
   ring's per-step bodies for every virtual rank in one process, K/V and
   the travelling dK/dV shifted by hand, forward and backward, against
   the single-device bf16 kernels and the plain version, with the branch
   rule's launch counts (n(n+1)/2 of each fp32 form: at n = 4, 4
   diagonal and 6 past blocks, 6 skipped); (c) the tp/sp main path:
   ``init`` (NCCL, world 1), ``create_mesh(dp=1, tp=1, sp=1)``, the 111M
   flagship with ``tp_axis="tp", sp_axis="sp"`` through the mesh
   ``build_train_step`` with AdamW, 5 steps of 8 x 2048 tokens: the loss
   finite and falling, each fp32 form launched 12 times a step and the
   bf16 forms never, and step 1's loss and gradients bit for bit those
   of phase 5's first step on the same weights and tokens (at n = 1 the
   ring's merge is exact and the fp32 outputs round as the bf16
   epilogue does); then 2 steps with ``sp_impl="ulysses"`` (the bf16
   kernels, 12 launches a step). It logs tok/s beside phase 5's and the
   fp32 forms' ms per step;
13. ZeRO-1 and the hierarchical reduction at one card (``init`` again,
   NCCL, world 1): the flagship of phase 5 on ``create_mesh(dp=1)``
   through the mesh ``build_train_step`` with AdamW, 5 steps without
   and 5 with ZeRO-1 (``make_optimizer(model, zero1=True)``) from the
   same weights: step 1's loss and every parameter after steps 1-3 bit
   for bit, both runs' tok/s and the optimizer state's bytes on the
   rank; then on ``create_mesh(dcn=1, dp=1)`` one step with
   ``dcn_axis="dcn"``, exact (its loss and parameters bit for bit the
   flat step's) and with ``dcn_wire="int8x256"`` (its loss bit for bit;
   its reduced gradients, quantized at n = 1, bit for bit
   ``quantized_psum`` of the flat step's gradients on their CPU
   copies); and ``quantized_psum`` of a 64 MiB bucket (the LM's bucket
   cap), int8 and fp8, bit for bit the same call on the CPU copy;
14. the MoE flagship at full width: phase 5's LM with ``num_experts=8``
   (a top-1 MoE in every odd layer, capacity factor 2.0, about 309M
   parameters) on ``create_mesh(dp=1, ep=1)``, 5 AdamW steps of
   8 x 2048 tokens: the loss finite and falling, each bf16 form of
   K1-K3 launched 12 times a step; it logs tok/s, the share of tokens
   each MoE layer dropped at step 1 and the peak memory;
15. the pipelined flagship (``init`` again, NCCL, world 1): phase 5's LM
   and batch as m = 8 microbatches of 1 through
   ``build_pipeline_train_step`` with AdamW on gpipe, 1f1b, zb-h1 and
   interleaved (V = 3). (a) On ``create_mesh(pp=1)``, 5 steps each: the
   loss finite and falling, step 1's within 1e-4 of phase 5's step 1 on
   the same weights and tokens, tok/s beside phase 5's and the peak
   memory; (c) K1-K3 launched per step 1-2-1 x 96 (gpipe: the backward
   sweep's recompute), 96 each (1f1b, interleaved) and 1-2-2 x 96
   (zb-h1: W walks the chain again), the fp32 forms never; these
   launches join the ``kernels`` line's. (b) The same step on 4 virtual
   stages in this process (3 layers a stage, 1 a chunk interleaved), 3
   steps: step 1's loss and every parameter after it bit for bit (a)'s
   (or, logged as a finding, within 1e-3), the same launches; (e) each
   schedule's ``schedule_info`` at n = 4, m = 8 beside (b)'s step
   times. The schedules' step-1 losses and gradients are held to
   gpipe's the same way. (d) K1-K3 checked and timed back-to-back at
   the microbatch's shape (B=1, H=6, S=2048), logged beside phase 3's;
16. the flagship LM in fp16 and in fp32 (``init`` again, NCCL, world
   1): phase 5's model, weights, tokens and AdamW with ``dtype`` fp16 and
   then fp32 through the automatic flash choice, 3 steps each: the loss
   finite and falling, step 1's within 1e-4 (fp16) and 1e-5 (fp32) of
   the same model on ``use_flash=False``, the dtype's K1, K2 and K3
   launched 12 times a step and no other form; tok/s and peak memory
   beside phase 5's. Then 2 steps of the fp16 tp/sp mesh step (ring
   attention on the fp16 operands' fp32-output forms, 12 launches a
   step each);
17. the engine's remainder at one card: phase 5's dp step again with
   ``HOROVOD_TPU_HIERARCHICAL_ALLREDUCE=1`` and ``HOROVOD_TPU_TIMELINE``
   set: the plan carries the flag, the losses of the 5 steps are phase
   5's bit for bit (at ici = 1 the two stages are the identity), the
   timeline is catapult JSON with a ``NEGOTIATE_ALLREDUCE`` and an
   ``NCCL_ALLREDUCE`` span once a step for each of the 7 buckets (and
   the step's loss), and tok/s is logged beside phase 5's; the stall
   probe: a request placed in the engine's table of announced ops and
   never planned, with a 1 s warning time, must draw the engine's stall
   warning within 4 s;
18. the conv zoo's main path (``init`` again, NCCL, world 1): VGG16 at
   32 x 224² and InceptionV3 at 32 x 299², bf16, 1000 classes, full
   width and depth, each 5 steps through ``synthetic("image",
   seed=1234)`` (its one batch materialised once into an
   ``ArraySource``, so the step does not wait on numpy's RNG; the
   source's own rate is logged) -> ``build_loader(batch_size=32,
   seed=0)`` ->
   ``prefetch_to_device(depth=2)`` -> ``broadcast_parameters`` ->
   ``DistributedOptimizer(SGD(0.01, momentum=0.9))``: the loss finite
   and falling, every bucket fired from its hook each step, no port
   kernel launched; it logs img/s, the model-FLOPs share, the peak
   memory and the host ms each step waited for its batch;
19. the MNIST net 20 steps at batch 64 through the loader and
   prefetcher (loss falling); word2vec 20 NCE steps at
   ``examples/jax_word2vec.py``'s sizes on its Zipf stream (loss
   falling, ``nearest`` ids valid); ResNet-50 with
   ``bn_axis_name="dp"`` on a world-1 mesh, 3 steps at phase 8's batch,
   weights and images: one ``[2C]`` statistics all-reduce per BN layer
   per step (53), step 1's loss logged beside phase 8's flax step.
20. checkpoint and elastic resume (``init`` again, NCCL, world 1; about
   30 s): phase 5's flagship fed by ``build_loader(synthetic("tokens",
   vocab=32000, seq_len=2049))`` -> ``prefetch_to_device(depth=2)``
   (2049 tokens a row: 2048 inputs and the shifted targets); after step
   2 ``ElasticState(backend="sharded")`` commits the model, the AdamW
   state and the prefetcher's consumed cursor (``commit`` returns after
   the host copy), steps 3-4 run while the writer serializes; a fresh
   model and optimizer from another seed and a fresh loader restore in
   place and replay steps 3-4: the losses, every parameter and every
   moment bit for bit the uninterrupted run's, the loader at offset 2,
   K1-K3 launched 12 times a step. A second commit with one shard
   corrupted: ``restore()`` logs the fallback and adopts the first,
   ``strict=True`` raises ``CorruptShardError``. It logs the commit's
   bytes (reckoned beside), the ms ``commit`` blocked the loop, the
   seconds to the durable commit and the restore's, and GB/s;
21. serving (about 60 s): the seed-0 bf16 flagship committed through
   ``checkpoint_hook`` with ``transformer_extra`` and served by ``python
   -m horovod_tpu_torch.serving`` (8 slots, 16-token blocks, a pool of
   1025 blocks: 604.6 MB) to 8 concurrent HTTP clients (prompts of 32 to
   1984 tokens, 64 new tokens each, greedy) and one streamed request,
   then SIGTERM: the server drains and exits 0. In-process engines on
   the same loaded weights check (a) the HTTP and streamed tokens, (b)
   batched against one at a time, (c) each request's prefill row and
   64th-token logits against ``Transformer.apply`` (3e-2 of max |logit|;
   K1 launches there from S = 1024), (d) the int8 pool (first tokens
   equal, 304,128 bytes a block), (e) speculative decoding with the
   flagship as its drafter, (f) the prefix cache on a shared 512-token
   system prompt. A divergence in (b), (e) or (f) fails if the full
   forward's logits of the two tokens differ by more than 3e-2 of max
   |logit| and is logged otherwise. The serve path launches no
   hand-written kernel (every count 0). It logs TTFT by prompt length,
   the decode step's median ms, tok/s batched and sequential, kernels a
   decode step and the device's busy share (torch.profiler over 20
   steps), peak memory and the KV bytes resident.
22. the fleet (about 60-90 s): ``python -m horovod_tpu_torch.serving
   --fleet 2 --device cuda`` on phase 21's commit (each replica phase
   21's engine), the supervisor's ``HOROVOD_TPU_METRICS_PORT`` and
   ``HOROVOD_TPU_BLACKBOX`` set, replica 1's first incarnation crashing
   at its decode tick 150 (``HOROVOD_TPU_FAULT_SPEC``), driven by the
   port's loadgen: Poisson at 3 requests a second for 20 s, seed 0,
   prompts of 32-1024 tokens, 64 new each, greedy. It fails on any
   failed or dropped request; on a token that differs from an in-process
   engine on the same weights, unless the two tokens' logits in the full
   forward lie within 3e-2 of max |logit| (a near-tie, logged); without
   a failover on the supervisor's ``/metrics.json``; unless replica 1 is
   back in rotation after one restart (generation 1, as its gen-1
   blackbox says); without ``gen0/blackbox-rank1.jsonl`` ending in the
   fault; and unless SIGTERM drains the supervisor to exit 0. It logs
   the loadgen's summary (TTFT and latency p50/p99, goodput), failovers
   by phase, the seconds from the crash to ready (the supervisor's
   flight recorder), the fleet's tok/s beside phase 21's one replica,
   each process's card memory (``nvidia-smi --query-compute-apps``) and
   the phase's seconds.
23. launch and elastic (about 90 s): ``run_elastic`` drives
   ``experiments/elastic_lm.py``'s worker (``min_np = max_np = 1``):
   phase 5's flagship and AdamW trained 6 steps of 8 x 2048 tokens (each
   step's batch from its own seed), ``ElasticState(backend="sharded")``
   committing every 2 steps. Generation 0 SIGKILLs itself after step 3
   (its commit of step 2 durable first); generation 1 restores step 2's
   commit and finishes. Its parameters and AdamW moments must equal a
   clean ``run(fn, np=1)`` of 6 steps bit for bit (sha256 of every
   tensor's bytes), and each step of both must launch K1-K3 12 times.
   It logs the generations, the seconds from the kill to generation 1's
   first step, the restore's seconds and the launches.
   23b: ``python -m horovod_tpu_torch.runner --serve -- --checkpoint-dir
   <phase 21's commit> --device cuda --tp 1`` serves phase 21's 8
   prompts at once; its tokens must be phase 21's HTTP tokens, and
   SIGTERM to the runner must drain it to exit 0.
24. step telemetry (about 30 s): ``init`` again (NCCL, world 1), phase
   5's flagship from its weights and tokens, 5 steps each inside
   ``StepMetrics(batch_size=8, flops_per_step=...)``. The FLOPs are
   ``flops_of_step`` of one step of another copy (torch's FLOP counter,
   the flash op counted by torch's SDPA formulas), which must be within
   ``FLOPS_TOL`` (1%) of the same step's count through the plain
   attention (``use_flash=False``, a third copy). Every step must
   launch K1-K3 12 times each and submit one allreduce request per
   bucket fired (hook plus flush) and one for the loss
   (``hvdtpu_ops_total{op="allreduce"}``); the phase shares must sum
   to 1 within 1e-6; ``hvdtpu_hbm_peak_bytes{device="cuda:N"}`` must
   equal ``torch.cuda.max_memory_allocated()`` over the same window;
   and the losses must be phase 5's bit for bit (the telemetry changes
   no value). It logs each step's phase split, MFU, HBM in use and
   peak, tok/s beside phase 5's, and the phase's seconds.
25. the numerics plane and the autotuners (about 60 s): ``init`` again
   (NCCL, world 1); phase 5's flagship, weights and tokens on a
   world-1 mesh through ``build_train_step``, 5 steps with the plane
   off, then 5 with ``HOROVOD_TPU_NUMERICS=1`` (K1-K3 12 launches a
   step in each): the armed step's parameters after step 5 must equal
   the plane-off step's bit for bit; step 5's grad norm and update
   ratio (read one step late, through ``hvdtpu_numerics_*``) within
   1e-3 relative of an fp64 computation from that step's gradients and
   parameters; tok/s of both beside phase 5's; the fingerprint probe's
   host ms over the 111M parameters. Then phase 5's dp step under a
   ``nan_at`` clause: exactly one ``nonfinite_rate`` alert, naming rank
   0 and a scan tick of the poisoned step. ``init`` again under
   ``HOROVOD_AUTOTUNE=1``: phase 5's dp step until the legacy tuner has
   logged 4 points (at least 3 distinct (fusion, cycle) points in its
   CSV), its first 5 losses phase 5's bit for bit. ``init`` again: an
   ``AutoTuner`` over ``fusion_threshold_mb``, ``torch_bucket_mb`` and
   ``cycle_time_ms`` makes its online moves on the dp step (each a
   guarded move through the coordinator or the optimizer), each move's
   verdict and step ms logged; the losses stay finite.
26. the offline tools (about 50 s): first a cold window, logged and not
   gated: ``init`` with ``HOROVOD_TIMELINE`` set, 3 flagship steps
   under ``StepMetrics`` whose first collective sets the communicator
   up inside the timeline, and ``trace report``'s shares beside
   StepMetrics' (the report sums overlapping spans, so it over-counts
   comm there). Then the gated steady window: a process group of its
   own (NCCL, world 1) whose communicator one all-reduce sets up, then
   ``init``, which adopts it, so the first collective's set-up falls
   outside the timeline; phase 5's flagship, AdamW and tokens, 20 steps inside
   ``StepMetrics(batch_size=8)`` with ``HOROVOD_TIMELINE``,
   ``HOROVOD_TPU_HISTORY`` (every 0.25 s) and ``HOROVOD_TPU_BLACKBOX``
   set (K1-K3 12 launches a step; the loss finite and falling); then
   each tool as ``python -m horovod_tpu_torch.tools.<name>``, each of
   which must exit 0 with a JSON report: ``trace report`` over the
   timeline (execute seconds > 0: the ``NCCL_*`` spans, deviation 47;
   its input / compute / comm shares within ``TOOLS_SHARE_TOL``, 0.10,
   of StepMetrics' input + h2d / compute / collective sums), ``health``
   over the history and ``--baseline`` against itself (no regression),
   ``postmortem`` over phase 22's ``gen0`` dumps (replica 1 first, in
   its serving replica crash, with its requests in flight) and over
   this phase's own dump (no divergence), and ``slo`` over phase 22's
   loadgen run (every offered request, none dropped). It logs the trace
   report's shares beside StepMetrics' and each tool's host seconds;
27. the mxnet shim on the card (about 20 s): ``init`` again (NCCL, world
   1); ``tests/test_mxnet.py``'s sweeps (uint8 ... float32, 1-3 dims of
   17) of allreduce (sum and average), allgather and broadcast over
   NDArrays on the card, the in-place forms, ``allreduce_multi_`` and
   the 64-bit payloads, each equal to its input bit for bit; then
   NDArrays of the flagship's 111,102,720 parameters (fp32) and seeded
   gradients: ``broadcast_parameters`` leaves them unchanged, and
   ``DistributedOptimizer(SGD).update`` over all of them (the fused
   allreduce, then ``w -= lr * g`` on the card) equals numpy's
   ``w - lr * g`` bit for bit. It logs the update's ms and the SGD's
   beside the bytes bound of 3 passes over the 0.44 GB.

No phase imports keras or tensorflow: the card's machine has neither.

Phase 3b, after phase 3: every form of K1-K3 (bf16 and fp16 operands,
each with its own and fp32 outputs, and fp32 operands on the SIMT
kernels) against its plain version at head dims 8, 16, 48, 80, 112,
160, 192 and 256 (8 padded to 16 by the wrapper; above 128 stored 256
wide in two column chunks), causal and not, with ragged sq != sk:
bf16 2e-2 of max |plain| (lse 1e-3), fp16 5e-3 (lse 1e-3), fp32 2e-5
on O and lse and 1e-4 on dQ, dK and dV, every call repeated bit for
bit; then the fp16 and fp32 forms timed at the flagship beside their
plain versions, SDPA at the same dtype as a yardstick, with bounds at
989 (fp16) and 67 (fp32) TFLOP/s; and each operand dtype's own form at
D=256 (B=8, H=3, S=2048), logged.

Phase 3c, after 3b: every form of K1-K3 at head dims 272, 320, 384 and
512 (the ``_wide`` kernels: D zero-padded to a multiple of 128), causal
and not, ragged, at 3b's tolerances and repeat-exact; then each operand
dtype's own form timed at B=8, H=3, S=2048, D=512 beside its plain
version and SDPA (the ``kernels`` rows ``<kernel>_wide``: the flash
wrappers count the kernels above head dim 256 under those keys, and no
main path launches one).

The card's ``nvidia-smi`` name and power limit are printed on a line of
their own after phase 1, and the run's seconds before the last lines. The line before the last is ``{"kernels":
[...]}``: every ``ms``, ``plain_ms`` and ``library_ms`` in it is a mean
over back-to-back launches between two CUDA events
(``experiments.time_ms``). The last line is ``{"ok": true, "device":
{...}}``. ``--profile
PATH`` also writes the device time of each kernel over 2 more steps of
each main path to PATH.
"""

from __future__ import annotations

import argparse
import atexit
import functools
import gc
import json
import logging
import math
import statistics
import sys
import time

import numpy as np
import torch

from horovod_tpu_torch import experiments as px
from horovod_tpu_torch.experiments import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,
                                           bound_ms, device_line,
                                           flash_times, single_ms)

FLASH_SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
# Each flash form's source, by its suffix (the bodies of the 16-bit
# forms are in flash_attention.cuh); the longest suffix first.
FLASH_FORM_SOURCES = {
    "_f16_f32": "horovod_tpu_torch/ops/csrc/flash_attention_f16_f32.cu",
    "_fp32": "horovod_tpu_torch/ops/csrc/flash_attention_fp32.cu",
    "_f16": "horovod_tpu_torch/ops/csrc/flash_attention_f16.cu",
    "_f32": "horovod_tpu_torch/ops/csrc/flash_attention_bf16_f32.cu",
    "": FLASH_SOURCE}
BN_SOURCE = "horovod_tpu_torch/ops/csrc/fused_bn.cu"
PROBE_SOURCE = "horovod_tpu_torch/ops/csrc/probes.cu"
ABLATE_SOURCE = "horovod_tpu_torch/ops/csrc/flash_ablate.cu"
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:123",
    "flash_dkv": "horovod_tpu/ops/flash_attention.py:178",
    "flash_dq": "horovod_tpu/ops/flash_attention.py:246",
    "flash_fwd_f32": "horovod_tpu/ops/flash_attention.py:123",
    "flash_dkv_f32": "horovod_tpu/ops/flash_attention.py:178",
    "flash_dq_f32": "horovod_tpu/ops/flash_attention.py:246",
    **{f"flash_{k}{sfx}": f"horovod_tpu/ops/flash_attention.py:{line}"
       for sfx in ("_f16", "_f16_f32", "_fp32")
       for k, line in (("fwd", 123), ("dkv", 178), ("dq", 246))},
    "bn_stats": "horovod_tpu/ops/fused_bn.py:99",
    "bn_norm": "horovod_tpu/ops/fused_bn.py:110",
    "bn_bwd_reduce": "horovod_tpu/ops/fused_bn.py:119",
    "bn_bwd_dx": "horovod_tpu/ops/fused_bn.py:138",
    "probe_copy": "experiments/pallas_shape_probe.py:42",
    "probe_addone": "experiments/pallas_mem_probe.py:48",
    "probe_stats_like": "experiments/pallas_mem_probe.py:52",
    "flash_ablate_stream": "experiments/flash_ablate_probe.py:24",
    "flash_ablate_matmul": "experiments/flash_ablate_probe.py:24",
    "flash_ablate_nosoft": "experiments/flash_ablate_probe.py:24",
}
BN_KERNELS = ("bn_stats", "bn_norm", "bn_bwd_reduce", "bn_bwd_dx")
BF16_FLASH = ("flash_fwd", "flash_dkv", "flash_dq")
F32_FLASH = ("flash_fwd_f32", "flash_dkv_f32", "flash_dq_f32")
STEPS = 5
REL_TOL = 2e-2    # max |kernel - plain| / max |plain| on O, dQ, dK, dV
LSE_TOL = 1e-3    # max |kernel - plain| on lse
BN_REL_TOL = 1e-2  # max |kernel - plain| / max |plain| on y, dx, dr
BN_SUM_TOL = 1e-4  # |kernel - plain| / sum |terms| on s1, s2, mean, var
BN_TIMED = (802816, 256, True, True)    # (M, C, relu, residual)
BN_CHECKED = [(802816, 256), (3211264, 64), (12544, 2048)]
BN_VARIANTS = [(True, True), (True, False), (False, False)]
RESNET_BATCH, RESNET_IMAGE = 256, 224
# Buckets at the default 64 MiB cap (the JAX shim's rule): the LM's 99
# fp32 gradients and ResNet-50's 161.
LM_BUCKETS, RESNET_BUCKETS = 7, 2
FLOPS_TOL = 1e-2   # phase 24: the flash count against the plain one
PROBE_STATS_BM = 1024   # the timed row tile of P2's stats-like and +1 map


def log(*a):
    print(*a, flush=True)


def pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(q + 1, sk) for q in range(sq))


def relerr(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def abserr(got, want):
    return float((got.float() - want.float()).abs().max())


def sumerr(got, want, mag):
    """max over channels of |got - want| / sum |terms|."""
    return float(((got.float() - want.float()).abs()
                  / mag.clamp_min(1e-30)).max())


def check_kernels(fa, b, h, s, d, causal, timed, out_dtype=None):
    """Hold K1-K3 (their fp32-output forms when ``out_dtype`` is fp32)
    against their plain versions at one shape, and to bit-identical
    repeats; with ``timed`` also time the kernels, the plain versions
    and SDPA back-to-back, and the kernels and SDPA as single calls (the
    fp32 forms: back-to-back, each beside its bf16 form)."""
    gen = torch.Generator(device="cuda").manual_seed(1234 + s + d)
    bh = b * h
    shape = (bh, s, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    sfx = "_f32" if out_dtype == torch.float32 else ""

    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal,
                                            out_dtype)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(
        q, k, v, do, lse_ref, delta, scale, causal, out_dtype)

    def kernels():
        return (*fa.flash_fwd_cuda(q, k, v, scale, causal, out_dtype),
                *fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale,
                                   causal, out_dtype),
                fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal,
                                 out_dtype))
    (o, lse, dk, dv, dq), again = kernels(), kernels()
    torch.cuda.synchronize()
    if not all(t.dtype == (out_dtype or torch.bfloat16)
               for t in (o, dk, dv, dq)):
        raise AssertionError(f"K1-K3{sfx} wrote another dtype than "
                             f"{out_dtype}")
    if not all(torch.equal(x, y)
               for x, y in zip((o, lse, dk, dv, dq), again)):
        raise AssertionError(f"K1-K3{sfx}: two calls on the same input "
                             f"gave different bits at S={s} D={d} "
                             f"causal={causal}")

    errs = {
        "flash_fwd" + sfx: {"o": relerr(o, o_ref),
                            "lse": abserr(lse, lse_ref)},
        "flash_dkv" + sfx: {"dk": relerr(dk, dk_ref),
                            "dv": relerr(dv, dv_ref)},
        "flash_dq" + sfx: {"dq": relerr(dq, dq_ref)},
    }
    absmax = {
        "flash_fwd" + sfx: max(abserr(o, o_ref), abserr(lse, lse_ref)),
        "flash_dkv" + sfx: max(abserr(dk, dk_ref), abserr(dv, dv_ref)),
        "flash_dq" + sfx: abserr(dq, dq_ref),
    }
    log(f"  shape B={b} H={h} S={s} D={d} causal={causal}"
        f"{', fp32 outputs' if sfx else ''}: {json.dumps(errs)}; "
        f"K1-K3{sfx} repeats bit-identical")
    for name, e in errs.items():
        for out, val in e.items():
            tol = LSE_TOL if out == "lse" else REL_TOL
            if not (val <= tol):
                raise AssertionError(
                    f"{name}.{out} disagrees with its plain version at "
                    f"S={s} D={d} causal={causal}: {val} > {tol}")
    if timed and sfx:
        return time_f32_forms(fa, (q, k, v, do, lse_ref, delta), scale,
                              causal, absmax)
    if not timed:
        return None

    n_pairs = pairs(s, s, causal) * bh
    elem = bh * s * d
    work = {   # (operations, bytes): each input read once, output written once
        "flash_fwd": (4 * d * n_pairs, 4 * elem * 2 + bh * s * 4),
        "flash_dkv": (8 * d * n_pairs, 6 * elem * 2 + 2 * bh * s * 4),
        "flash_dq": (6 * d * n_pairs, 5 * elem * 2 + 2 * bh * s * 4),
    }
    # The kernels and, as yardsticks only, PyTorch's fused attention on
    # the same inputs; its backward is one call computing dQ, dK and dV
    # together, so it stands beside both backward kernels.
    thunks = flash_times.calls(q, k, v, do, b, h, causal)
    b2b = {name: px.time_ms(fn) for name, fn in thunks.items()}
    single = {name: single_ms(fn) for name, fn in thunks.items()}
    log(f"  back-to-back ms {json.dumps(b2b)}")
    log(f"  single-call ms {json.dumps(single)}")
    plain_fwd = px.time_ms(lambda: fa.flash_fwd_reference(q, k, v, scale,
                                                          causal))
    plain_bwd = px.time_ms(lambda: fa.flash_bwd_reference(
        q, k, v, do, lse_ref, delta, scale, causal))
    plain = {"flash_fwd": plain_fwd, "flash_dkv": plain_bwd,
             "flash_dq": plain_bwd}
    library = {"flash_fwd": b2b["sdpa_fwd"], "flash_dkv": b2b["sdpa_bwd"],
               "flash_dq": b2b["sdpa_bwd"]}

    rows = {}
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        ops, nbytes = work[name]
        b_ms, b_by = bound_ms(ops, nbytes)
        rows[name] = {"ms": b2b[name], "plain_ms": plain[name],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library[name],
                      "max_abs_err": absmax[name],
                      "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        log(f"  {name}: {json.dumps(rows[name])}")
    return rows


def parity(hvd_tfm, fa, d_model=256, n_heads=None):
    """Small model, flash kernels vs plain attention on the card."""
    cfg_kw = dict(vocab=512, d_model=d_model, n_heads=n_heads, n_layers=2,
                  d_ff=512, max_seq=1024, dtype=torch.bfloat16,
                  remat=False)
    gen = torch.Generator().manual_seed(7)
    params = hvd_tfm.init_params(hvd_tfm.TransformerConfig(**cfg_kw), gen)
    tok = torch.randint(0, 512, (2, 1025),
                        generator=torch.Generator().manual_seed(8))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()
    out = {}
    for flash in (True, False):
        cfg = hvd_tfm.TransformerConfig(use_flash=flash, **cfg_kw)
        model = hvd_tfm.Transformer(cfg, params=params, device="cuda")
        loss = model.loss_fn(tokens, targets)
        loss.backward()
        out[flash] = (float(loss.detach()), {n: p.grad.float()
                                    for n, p in model.named_parameters()})
    (lf, gf), (lp, gp) = out[True], out[False]
    loss_err = abs(lf - lp) / abs(lp)
    grad_err = max(relerr(gf[n], gp[n]) for n in gp)
    log(f"  parity (d_model {d_model}, head_dim "
        f"{d_model // hvd_tfm.TransformerConfig(**cfg_kw).n_heads}): loss "
        f"flash {lf:.6f} plain {lp:.6f} rel {loss_err:.3e}; "
        f"max grad rel err {grad_err:.3e}")
    if not (math.isfinite(lf) and loss_err <= 1e-2 and grad_err <= 5e-2):
        raise AssertionError("flash model disagrees with plain attention "
                             f"(loss {loss_err}, grads {grad_err})")


# ------------------------------------------------------------ batch norm

def bn_inputs(m, c, seed):
    """x, da, r [M, C] bf16 ~ N(0, 1); mean/rstd of x; scale/shift from a
    gamma in [0.5, 1.5] and a beta in [-0.1, 0.1]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, da, r = (torch.randn(m, c, generator=gen, device="cuda").bfloat16()
                for _ in range(3))
    gamma = 0.5 + torch.rand(c, generator=gen, device="cuda")
    beta = 0.2 * torch.rand(c, generator=gen, device="cuda") - 0.1
    mean = x.float().mean(0)
    var = x.float().var(0, unbiased=False)
    rstd = torch.rsqrt(var + 1e-5)
    scale = gamma * rstd
    shift = beta - mean * scale
    return dict(x=x, da=da, r=r, gamma=gamma, beta=beta, mean=mean, var=var,
                rstd=rstd, scale=scale, shift=shift)


def bn_work(name, m, c, relu, residual):
    """(fp32 operations, bytes) of one call: each input read once, each
    output written once."""
    mat, vec = m * c * 2, c * 4
    res = int(residual)
    masked = int(relu and residual)     # r enters the backward mask only
    if name == "bn_stats":
        return 3 * m * c, mat + 2 * vec
    if name == "bn_norm":
        return (2 + res + relu) * m * c, (2 + res) * mat + 2 * vec
    mask_ops = (3 + masked) * relu
    if name == "bn_bwd_reduce":
        return (5 + mask_ops) * m * c, (2 + masked) * mat + 6 * vec
    return (6 + mask_ops) * m * c, (3 + masked + res) * mat + 8 * vec


def bn_calls(fbn, t, relu, residual):
    """The four kernel calls and their plain versions on ``t``."""
    r = t["r"] if residual else None
    x, da = t["x"], t["da"]
    vecs = (t["mean"], t["rstd"], t["scale"], t["shift"])
    m = x.shape[0]
    s1, s2 = fbn.bwd_reduce_reference(x, da, r, *vecs, relu)
    return {
        "bn_stats": (lambda: fbn.stats_cuda(x),
                     lambda: fbn.stats_reference(x)),
        "bn_norm": (lambda: fbn.norm_cuda(x, r, t["scale"], t["shift"], relu),
                    lambda: fbn.norm_reference(x, r, t["scale"], t["shift"],
                                               relu)),
        "bn_bwd_reduce": (
            lambda: fbn.bwd_reduce_cuda(x, da, r, *vecs, relu),
            lambda: fbn.bwd_reduce_reference(x, da, r, *vecs, relu)),
        "bn_bwd_dx": (
            lambda: fbn.bwd_dx_cuda(x, da, r, *vecs, s1, s2, 1.0 / m, relu),
            lambda: fbn.bwd_dx_reference(x, da, r, *vecs, s1, s2, 1.0 / m,
                                         relu)),
    }


def check_bn(fbn, m, c, relu, residual):
    """Hold K4-K7 against their plain versions at one shape and variant;
    returns the max abs error of each."""
    t = bn_inputs(m, c, seed=m + c + 2 * relu + residual)
    calls = bn_calls(fbn, t, relu, residual)
    got = {name: kern() for name, (kern, _) in calls.items()}
    again = {name: calls[name][0]() for name in ("bn_stats",
                                                 "bn_bwd_reduce")}
    want = {name: plain() for name, (_, plain) in calls.items()}
    torch.cuda.synchronize()

    xf = t["x"].float()
    dy = fbn._masked_grad(xf, t["da"], t["r"] if residual else None,
                          t["scale"], t["shift"], relu)
    xhat = (xf - t["mean"]) * t["rstd"]
    mag_x, mag_x2 = xf.abs().sum(0), (xf * xf).sum(0)
    (s1, s2), (p1, p2) = got["bn_stats"], want["bn_stats"]
    mean, pmean = s1 / m, p1 / m
    var, pvar = s2 / m - mean * mean, p2 / m - pmean * pmean
    errs = {
        "bn_stats": {"s1": sumerr(s1, p1, mag_x), "s2": sumerr(s2, p2, mag_x2),
                     "mean": sumerr(mean, pmean, mag_x / m),
                     "var": sumerr(var, pvar, mag_x2 / m + pmean * pmean)},
        "bn_norm": {"y": relerr(got["bn_norm"], want["bn_norm"])},
        "bn_bwd_reduce": {
            "s1": sumerr(got["bn_bwd_reduce"][0], want["bn_bwd_reduce"][0],
                         dy.abs().sum(0)),
            "s2": sumerr(got["bn_bwd_reduce"][1], want["bn_bwd_reduce"][1],
                         (dy * xhat).abs().sum(0))},
        "bn_bwd_dx": {"dx": relerr(got["bn_bwd_dx"][0],
                                   want["bn_bwd_dx"][0])},
    }
    if residual:
        errs["bn_bwd_dx"]["dr"] = relerr(got["bn_bwd_dx"][1],
                                         want["bn_bwd_dx"][1])
    log(f"  M={m} C={c} relu={relu} residual={residual}: {json.dumps(errs)}")
    for name, e in errs.items():
        for out, val in e.items():
            tol = BN_SUM_TOL if name in ("bn_stats", "bn_bwd_reduce") \
                else BN_REL_TOL
            if not (val <= tol):
                raise AssertionError(
                    f"{name}.{out} disagrees with its plain version at "
                    f"M={m} C={c} relu={relu} residual={residual}: "
                    f"{val} > {tol}")
    for name, repeat in again.items():
        if not all(torch.equal(a, b) for a, b in zip(got[name], repeat)):
            raise AssertionError(f"{name}: two calls on the same input "
                                 "gave different bits")

    def outs(v):
        return [u for u in (v if isinstance(v, tuple) else (v,))
                if u is not None]
    return {name: max(abserr(a, b) for a, b in zip(outs(got[name]),
                                                     outs(want[name])))
            for name in got}


def bn_library_calls(t):
    """Yardsticks only, never called by the port: PyTorch's unfused BN
    primitives on the same tensors (no residual, no ReLU)."""
    x, da = t["x"], t["da"]
    m = x.shape[0]
    mean, invstd, gamma, beta = t["mean"], t["rstd"], t["gamma"], t["beta"]
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
        da, x, mean, invstd, gamma, True, True, True)
    count = torch.full((1,), m, dtype=torch.int32, device="cuda")
    return {
        "bn_stats": lambda: torch.batch_norm_stats(x, 1e-5),
        "bn_norm": lambda: torch.batch_norm_elemt(x, gamma, beta, mean,
                                                  invstd, 1e-5),
        "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            da, x, mean, invstd, gamma, True, True, True),
        "bn_bwd_dx": lambda: torch.batch_norm_backward_elemt(
            da, x, mean, invstd, gamma, sum_dy, sum_dy_xmu, count),
    }


def bn_layers_and_macs(model, batch, image):
    """The (M, C, relu, residual) of every BN layer of ``model`` and its
    conv + dense multiply-adds per step, from one eval-mode forward of a
    single image (no kernel runs in eval mode)."""
    from horovod_tpu_torch.models import resnet as tres
    layers, macs = [], [0]

    def on_bn(mod, args, kwargs, out):
        _, _, h, w = args[0].shape
        layers.append((batch * h * w, args[0].shape[1], mod.relu,
                       kwargs.get("residual") is not None))

    def on_conv(mod, args, out):
        _, cin, k, _ = mod.weight.shape
        macs[0] += batch * out.numel() * cin * k * k

    def on_dense(mod, args, out):
        macs[0] += batch * mod.in_features * mod.out_features

    hooks = []
    for mod in model.modules():
        if isinstance(mod, tres.FusedBNAct):
            hooks.append(mod.register_forward_hook(on_bn, with_kwargs=True))
        elif isinstance(mod, tres.Conv):
            hooks.append(mod.register_forward_hook(on_conv))
    hooks.append(model.head.register_forward_hook(on_dense))
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=model.device))
    model.train()
    for h in hooks:
        h.remove()
    return layers, macs[0]


def bn_phase(fbn, layers):
    """Phase 6: check, time at the headline shape and per ResNet-50 step."""
    log(f"BN kernels vs plain (tolerance: rel {BN_REL_TOL} on y/dx/dr, "
        f"{BN_SUM_TOL} of sum |terms| on s1/s2/mean/var):")
    absmax = {}
    for m, c in BN_CHECKED:
        for relu, residual in BN_VARIANTS:
            errs = check_bn(fbn, m, c, relu, residual)
            if (m, c, relu, residual) == BN_TIMED:
                absmax = errs

    m, c, relu, residual = BN_TIMED
    t = bn_inputs(m, c, seed=99)
    calls = bn_calls(fbn, t, relu, residual)
    lib = bn_library_calls(t)
    rows = {}
    for name in BN_KERNELS:
        kern, plain = calls[name]
        ops, nbytes = bn_work(name, m, c, relu, residual)
        b_ms, b_by = bound_ms(ops, nbytes, PEAK_FP32_FLOPS)
        rows[name] = {"ms": px.time_ms(kern), "plain_ms": px.time_ms(plain),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": px.time_ms(lib[name]),
                      "max_abs_err": absmax[name],
                      "mbytes": nbytes / 1e6}
        log(f"  {name} at M={m} C={c} relu+residual: "
            f"{json.dumps(rows[name])}")
    del t, calls, lib

    # Every BN layer of one ResNet-50 step, timed at its own shape.
    per_step = {name: 0.0 for name in BN_KERNELS}
    bound_step = {name: 0.0 for name in BN_KERNELS}
    shapes = {}
    for layer in layers:
        shapes[layer] = shapes.get(layer, 0) + 1
    for (m, c, relu, residual), count in sorted(shapes.items()):
        t = bn_inputs(m, c, seed=m + c)
        calls = bn_calls(fbn, t, relu, residual)
        for name in BN_KERNELS:
            per_step[name] += count * single_ms(calls[name][0], iters=5,
                                                warmup=1)
            ops, nbytes = bn_work(name, m, c, relu, residual)
            bound_step[name] += count * bound_ms(ops, nbytes,
                                              PEAK_FP32_FLOPS)[0]
        del t, calls
    torch.cuda.empty_cache()
    log(f"  per ResNet-50 step ({len(layers)} layers, batch "
        f"{RESNET_BATCH}): kernel ms {json.dumps(per_step)}, total "
        f"{sum(per_step.values()):.3f} ms; bound ms "
        f"{json.dumps(bound_step)}, total {sum(bound_step.values()):.3f} ms")
    return rows


def grad_errors(got, want):
    """(whole-model relative L2 error, worst per-tensor relative L2 error)
    of the gradients ``got`` against ``want``."""
    num = sum(float((got[n].float() - want[n].float()).norm()) ** 2
              for n in want)
    den = sum(float(want[n].float().norm()) ** 2 for n in want)
    worst = max(float((got[n].float() - want[n].float()).norm()
                      / want[n].float().norm().clamp_min(1e-30))
                for n in want)
    return math.sqrt(num / den), worst


def resnet_parity(tres):
    """Phase 7: a small bf16 ResNet on the BN kernels vs the same weights
    on the plain fused op.

    Loss and running stats are held to the plain bf16 model directly. In
    bf16 the gradients are not: one bf16 rounding that a 1e-7 change of
    a BN sum flips changes ReLU masks downstream and moves single
    gradient elements by tens of percent (the plain model fed the same
    batch in reverse order moves them by up to 25%). So both bf16 models
    are held to the fp32 plain model, and the kernels' gradients must be
    no farther from it than the plain bf16 model's."""
    kw = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, num_filters=16)
    gen = torch.Generator().manual_seed(11)
    ref = tres.ResNet(bn_impl="jnp", generator=gen, device="cuda", **kw)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, tres._Norm):
                mod.scale.copy_(0.5 + torch.rand(mod.scale.shape,
                                                 generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                 generator=gen))
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    dgen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn(8, 64, 64, 3, generator=dgen, device="cuda")
    labels = torch.randint(0, 10, (8,), generator=dgen, device="cuda")
    out = {}
    for name, impl, dtype in (("kernels", "pallas", torch.bfloat16),
                              ("plain", "jnp", torch.bfloat16),
                              ("fp32", "jnp", torch.float32)):
        model = tres.ResNet(bn_impl=impl, dtype=dtype, device="cuda", **kw)
        model.load_state_dict(state)
        model.train()
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        out[name] = (float(loss.detach()),
                     {n: p.grad for n, p in model.named_parameters()},
                     {n: b for n, b in model.named_buffers()})
    (lk, gk, bk), (lp, gp, bp), (_, g32, _) = (out["kernels"], out["plain"],
                                               out["fp32"])
    loss_err = abs(lk - lp) / abs(lp)
    stat_err = max(relerr(bk[n], bp[n]) for n in bp)
    direct = max(relerr(gk[n], gp[n]) for n in gp)
    k32, p32 = grad_errors(gk, g32), grad_errors(gp, g32)
    log(f"  parity: loss kernels {lk:.6f} plain {lp:.6f} rel "
        f"{loss_err:.3e}; max running-stat rel err {stat_err:.3e}; max "
        f"grad rel err kernels vs plain {direct:.3e} (not held); grads "
        f"vs the fp32 model (whole-model L2, worst tensor L2): kernels "
        f"{k32[0]:.3e}, {k32[1]:.3e}; plain bf16 {p32[0]:.3e}, "
        f"{p32[1]:.3e}")
    if not (math.isfinite(lk) and loss_err <= 1e-2 and stat_err <= 1e-2
            and k32[0] <= 1.1 * p32[0] and k32[1] <= 1.25 * p32[1]):
        raise AssertionError(
            "the ResNet on the BN kernels disagrees with the plain op "
            f"(loss {loss_err}, running stats {stat_err}, grads vs fp32 "
            f"{k32} against the plain bf16 model's {p32})")


def train_steps(step, model, opt, *batch):
    """STEPS steps; (losses, seconds per step)."""
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, opt, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses, times


def check_launches(launches, per_step):
    for name, n in launches.items():
        if n != per_step * STEPS:
            raise AssertionError(
                f"{name} launched {n} times in {STEPS} steps, expected "
                f"{per_step * STEPS}")


def check_flash_launches(launches, bf16_per_step, f32_per_step,
                         steps=STEPS):
    """Each bf16 form of K1-K3 launched ``bf16_per_step`` times a step
    (or K1, K2 and K3 each its entry of a triple), each fp32 form
    ``f32_per_step`` times."""
    if isinstance(bf16_per_step, int):
        bf16_per_step = (bf16_per_step,) * len(BF16_FLASH)
    want = {**{n: k * steps for n, k in zip(BF16_FLASH, bf16_per_step)},
            **{n: f32_per_step * steps for n in F32_FLASH}}
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"flash launches {got} in {steps} steps, "
                             f"expected {want}")


def kind_of(key):
    """Coarse kind of a kernel name, for the profile's summary."""
    k = key.lower()
    if any(f"bn_{n}_kernel" in k for n in ("stats", "finalize", "norm",
                                           "bwd_reduce", "bwd_dx")):
        return "bn kernels K4-K7"
    if any(f"flash_{n}" in k and "_kernel" in k
           for n in ("fwd", "dkv", "dq")):
        return "flash kernels K1-K3"
    if any(s in k for s in ("conv", "cudnn", "dgrad", "wgrad", "fprop",
                            "implicit", "winograd")):
        return "cuDNN convolutions"
    if any(s in k for s in ("gemm", "cutlass", "nvjet", "sm90_")):
        return "GEMMs"
    if "multi_tensor" in k or "foreach" in k:
        return "optimizer (foreach)"
    if "memcpy" in k or "memset" in k:
        return "memcpy/memset"
    return "elementwise/reductions/other"


def profile_steps(run, path, label, n=2):
    """Device time by kernel over ``n`` calls of ``run`` (torch.profiler),
    appended to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    avgs = prof.key_averages()
    # Kernel rows only: an operator's row, or a range annotation such as
    # the optimizer's step, repeats the time of the kernels inside it.
    dev = [(a.key, a.self_device_time_total / n / 1e3, a.count // n)
           for a in avgs if a.self_device_time_total > 0
           and a.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(a, "is_user_annotation", False)
           and not a.key.startswith("Optimizer.")]
    dev.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in dev)
    kinds = {}
    for key, ms, cnt in dev:
        ms0, cnt0 = kinds.get(kind_of(key), (0.0, 0))
        kinds[kind_of(key)] = (ms0 + ms, cnt0 + cnt)
    with open(path, "a") as f:
        f.write(f"== {label}\nper step: wall {wall * 1e3:.3f} ms, device "
                f"kernels {busy:.3f} ms\n")
        for kind, (ms, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
            f.write(f"  kind {ms:10.3f} ms  {cnt:6d}x  {kind}\n")
        for key, ms, cnt in dev:
            f.write(f"{ms:10.3f} ms  {cnt:6d}x  {key}\n")
    log(f"  profile {label}: wall {wall * 1e3:.2f} ms/step, device busy "
        f"{busy:.2f} ms ({busy / (wall * 1e3):.1%}); by kind: " + "; ".join(
            f"{kind} {ms:.2f} ms/{cnt}x" for kind, (ms, cnt) in
            sorted(kinds.items(), key=lambda r: -r[1][0])))


def timed_synchronize(opt, sync_ms, fires):
    """Wrap ``opt.synchronize`` to log, per call, its host ms into
    ``sync_ms`` and (buckets fired from hooks since the last call,
    buckets fired by this call's flush) into ``fires``."""
    inner = opt.synchronize
    last = dict(opt.bucket_fires)

    def sync():
        hook = opt.bucket_fires["hook"] - last["hook"]
        t0 = time.perf_counter()
        inner()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        fires.append((hook, opt.bucket_fires["flush"] - last["flush"]))
        last.update(opt.bucket_fires)
    opt.synchronize = sync


def check_bucket_fires(opt, fires, want):
    """``want`` buckets, each fired from its last hook in every step."""
    n = len(opt._buckets)
    if n != want or any(f != (n, 0) for f in fires):
        raise AssertionError(f"{n} buckets (expected {want}); fired (hook, "
                             f"flush) per step {fires}")


def bucket_line(opt, sync_ms, fires):
    mib = [round(b.numel * b.buffer.element_size() / 2**20, 1)
           for b in opt._buckets]
    return (f"{len(opt._buckets)} buckets of {mib} MiB; fired (hook, "
            f"flush) per step {fires}; optimizer.synchronize() host ms per "
            f"step {[round(x, 3) for x in sync_ms]}")


def lm_main_path(hvd, tfm, fa, fbn, build_train_step, profile):
    """Phase 5; returns the launch counts of its 5 steps."""
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                d_ff=3072, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    if cfg.n_heads != 6:
        raise AssertionError(f"flagship heads {cfg.n_heads} != 6")
    step = build_train_step(
        cfg, lambda p: torch.optim.AdamW(
            p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    sync_ms, fires = [], []
    timed_synchronize(opt, sync_ms, fires)
    grad_mb = sum(p.numel() * p.element_size() for p in model.parameters())
    b, s = 8, 2048
    tok = torch.randint(0, cfg.vocab, (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fbn.reset_launch_counts()
    losses, times = train_steps(step, model, opt, tokens, targets)
    launches = fa.launch_counts()
    log(f"LM main path: {n_params} params, losses {losses}")
    log(f"  step seconds {times}")
    steady = statistics.median(times[1:])
    log(f"  {b * s / steady:.1f} tok/s (median of steps 2-{STEPS}, "
        f"{steady * 1e3:.2f} ms/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  model FLOPs 6*N*tokens = {6 * n_params * b * s / 1e12:.3f} "
        f"TFLOP/step: {6 * n_params * b * s / steady / 1e12:.1f} TFLOP/s, "
        f"{6 * n_params * b * s / steady / PEAK_BF16_FLOPS:.2%} of the "
        "bf16 peak (attention not counted)")
    log(f"  launches {launches}")
    log(f"  gradient sync ({grad_mb / 1e6:.1f} MB of fp32 gradients): "
        + bucket_line(opt, sync_ms, fires))
    check_flash_launches(launches, cfg.n_layers, 0)
    if sum(fbn.launch_counts().values()):
        raise AssertionError("the LM step launched batch-norm kernels")
    check_bucket_fires(opt, fires, LM_BUCKETS)
    if profile:
        profile_steps(lambda: step(model, opt, tokens, targets), profile,
                      "LM flagship train step")
    return launches, steady, losses


def resnet_main_path(hvd, tres, fa, fbn, build_image_train_step, macs,
                     bn_bound_ms, profile):
    """Phase 8; returns the BN kernels' launch counts of the 5 steps and
    the bn_impl="flax" run's losses."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                         generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                           device="cuda")
    flops = 3 * 2 * macs
    img_s, launches, all_losses = {}, None, {}
    for bn_impl in ("pallas", "flax"):
        step = build_image_train_step(
            functools.partial(tres.ResNet50, num_classes=1000,
                              bn_impl=bn_impl),
            lambda p: torch.optim.SGD(p, lr=0.01 * hvd.size(),
                                      momentum=0.9))
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = step.make_optimizer(model)
        sync_ms, fires = [], []
        timed_synchronize(opt, sync_ms, fires)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        fbn.reset_launch_counts()
        losses, times = train_steps(step, model, opt, images, labels)
        all_losses[bn_impl] = losses
        counts = fbn.launch_counts()
        steady = statistics.median(times[1:])
        img_s[bn_impl] = RESNET_BATCH / steady
        log(f"ResNet-50 main path, bn_impl={bn_impl}: "
            f"{sum(p.numel() for p in model.parameters())} params, "
            f"losses {losses}")
        log(f"  step seconds {times}")
        log(f"  {img_s[bn_impl]:.1f} img/s (median of steps 2-{STEPS}, "
            f"{steady * 1e3:.2f} ms/step); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  model FLOPs (conv + dense, 2*MAC x 3) {flops / 1e12:.3f} "
            f"TFLOP/step: {flops / steady / 1e12:.1f} TFLOP/s, "
            f"{flops / steady / PEAK_BF16_FLOPS:.2%} of the bf16 peak; "
            f"BN kernels' bytes bound {bn_bound_ms:.3f} ms/step")
        log(f"  launches {counts} (flash {fa.launch_counts()})")
        log("  gradient sync: " + bucket_line(opt, sync_ms, fires))
        check_bucket_fires(opt, fires, RESNET_BUCKETS)
        if sum(fa.launch_counts().values()):
            raise AssertionError("the ResNet step launched flash kernels")
        if bn_impl == "pallas":
            check_launches(counts, 53)
            launches = counts
        elif sum(counts.values()):
            raise AssertionError("bn_impl='flax' launched BN kernels")
        if profile:
            profile_steps(lambda: step(model, opt, images, labels), profile,
                          f"ResNet-50 train step, bn_impl={bn_impl}")
        del step, model, opt
        torch.cuda.empty_cache()
    log(f"ResNet-50 img/s: pallas {img_s['pallas']:.1f}, flax "
        f"{img_s['flax']:.1f} (ratio {img_s['pallas'] / img_s['flax']:.3f})")
    return launches, all_losses["flax"]


# ---------------------------------------------------------------- probes

def randn_bf16(seed, *shape):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def probe_phase(pr, shape_probe, mem_probe, ablate_probe, k1_ms):
    """Phase 9; returns (rows, launches of the probe scripts' run)."""
    log("probe kernels P1-P3 vs plain (tolerance: copy and +1 exact; "
        f"stats-like {px.SUM_TOL} of sum |terms|, repeats bit-identical; "
        f"ablation stream 1 bf16 ulp, matmul/nosoft rel {px.REL_TOL}):")
    for seed, (m, c, bm) in enumerate(((4096, 256, 512), (1024, 2048, 8),
                                       (128, 512, 32))):
        x = randn_bf16(seed, m, c) * 8
        px.check_copy(x, bm)
        px.check_addone(x, bm)
    for seed, (m, c, bm) in enumerate(((512, 256, 16), (512, 256, 64),
                                       (8192, 264, 1024))):
        px.check_stats_like(randn_bf16(10 + seed, m, c) + 0.5, bm)
    worst = {}
    for mode in pr.MODES:
        for causal in (True, False):
            for d in (64, 128):
                for tile in pr.CUDA_TILES:
                    q, k, v = (randn_bf16(20 + d + i, 2, 256, d)
                               for i in range(3))
                    unit = px.check_ablate(q, k, v, mode, causal, tile)[1]
                    worst[mode] = max(worst.get(mode, 0.0), unit)
    log(f"  small shapes: copy and +1 exact at 3 shapes, stats-like at 3; "
        f"ablation over causal x D {{64, 128}} x tiles {pr.CUDA_TILES}: "
        f"worst stream {worst['stream']:.3f} ulp, matmul rel "
        f"{worst['matmul']:.2e}, nosoft rel {worst['nosoft']:.2e}")

    # The probes' own path: the three probe scripts' measurements at full
    # size.
    pr.reset_launch_counts()
    p1 = shape_probe.run(check=False)
    p2 = mem_probe.run(check=False)
    p3 = ablate_probe.run(shapes=[ablate_probe.FLAGSHIP], causals=(True,),
                          tiles=(64,), check=False)
    launches = pr.launch_counts()
    log(f"  probe scripts' launches {launches}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"probe kernels never launched by the probe "
                             f"scripts: {idle}")
    for r in p1 + p2 + p3:
        log(f"  {json.dumps(r)}")
    best = min((r for r in p1 if r["bm"]), key=lambda r: r["ms"])
    lib = {r["name"]: r["ms"] for r in p1 + p2 if r["bm"] is None}
    p2_at = {r["kind"]: r for r in p2 if r["bm"] == PROBE_STATS_BM}
    p3_at = {r["mode"]: r for r in p3}
    split = ablate_probe.split(p3)[(*ablate_probe.FLAGSHIP, True, 64)]
    log(f"  P1 best: c2={best['c2']} bm={best['bm']} {best['ms']:.4f} ms "
        f"= {best['gbps']:.1f} GB/s; P3 split of the mma.sync body at the "
        f"flagship (causal, tile 64) beside K1, ms: {json.dumps(split)}; "
        f"K1 in phase 3 {k1_ms:.4f} ms (back-to-back)")

    # The timed configurations against their plain versions (launches
    # not counted).
    def row(r, err, plain_ms, library_ms):
        return {"ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms,
                "max_abs_err": err}

    rows = {}
    x = randn_bf16(0, shape_probe.TOTAL).view(-1, best["c2"])
    rows["probe_copy"] = row(best, px.check_copy(x, best["bm"]),
                             px.time_ms(lambda: pr.copy_reference(x)),
                             lib["y.copy_(x)"])
    x = randn_bf16(1, mem_probe.M, mem_probe.C)
    rows["probe_addone"] = row(
        p2_at["addone"], px.check_addone(x, PROBE_STATS_BM),
        px.time_ms(lambda: pr.addone_reference(x)),
        lib["torch.add(x, 1)"])
    rows["probe_stats_like"] = row(
        p2_at["stats_like"], px.check_stats_like(x, PROBE_STATS_BM),
        px.time_ms(lambda: pr.stats_like_reference(x, PROBE_STATS_BM)),
        lib["torch.batch_norm_stats"])
    del x
    b, h, s = ablate_probe.FLAGSHIP
    q, k, v = ablate_probe.inputs(b * h, s, ablate_probe.D, seed=3)
    for mode in pr.MODES:
        err = px.check_ablate(q, k, v, mode, True, 64)[0]
        rows[f"flash_ablate_{mode}"] = row(
            p3_at[mode], err,
            px.time_ms(lambda: pr.ablate_reference(q, k, v, mode, True, 64,
                                                   64)),
            p3_at[mode]["library_ms"])
    for name, r in rows.items():
        log(f"  {name}: {json.dumps(r)}")
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------- collective engine

ENGINE_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64,
                 torch.float16, torch.float32, torch.float64, torch.bfloat16)
ENGINE_CONFIGS = (("sum", False, 1.0, 1.0), ("average", True, 1.0, 1.0),
                  ("scaled", True, 0.5, 2.0))
BURST = 160
BURST_THRESHOLD = 1 << 20     # bytes: cuts the burst into several groups


def bits(t):
    """``t`` as integers of its width, for bit-for-bit comparison."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def engine_input(dtype, shape, seed):
    """As tests/test_ops.py draws them: floats in [-100, 100), integers
    in [0, 100); on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.rand(shape, generator=gen, dtype=torch.float64)
                * 200 - 100).to(dtype)
    return torch.randint(0, 100, shape, generator=gen).to(dtype)


def same_bits(got, want):
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(bits(got.cpu()), bits(want)))


def engine_sweep(hvd, texec):
    """Every dtype x dims x op through the engine on the card, against
    the executor's arithmetic on CPU copies (identity collective) and
    against the closed form at n = 1: every swept op returns its input
    (the sweep's scale factors 0.5 and 2.0 are exact on its values)."""
    ident = lambda b: b               # noqa: E731  the collective at n = 1
    bad, count = [], 0
    for cfg, avg, pre, post in ENGINE_CONFIGS:
        cases = [(f"{cfg}.{str(dt)[6:]}.{dim}",
                  engine_input(dt, (17,) * dim, 100 * i + dim))
                 for i, dt in enumerate(ENGINE_DTYPES) for dim in (1, 2, 3)]
        handles = [hvd.allreduce_async(x.cuda(), avg, name, pre, post)
                   for name, x in cases]
        for (name, x), h in zip(cases, handles):
            want = texec.fused_allreduce(
                [x], ident, pre, post / hvd.size() if avg else post)[0]
            count += 1
            got = h.wait()
            if not (same_bits(got, want) and same_bits(got, x)):
                bad.append(f"allreduce {name}")
    cases = [(f"{str(dt)[6:]}.{dim}", engine_input(dt, (17,) * dim, dim))
             for dt in ENGINE_DTYPES for dim in (1, 2, 3)]
    gathers = [hvd.allgather_async(x.cuda(), name=f"gather.{name}")
               for name, x in cases]
    bcasts = [hvd.broadcast_async(x.cuda(), 0, name=f"bcast.{name}")
              for name, x in cases]
    for (name, x), g, b in zip(cases, gathers, bcasts):
        want_g = texec.fused_allgather([x], [[x.shape[0]]],
                                       lambda buf: buf[None])[0]
        want_b = texec.fused_broadcast([x], ident)[0]
        count += 2
        got_g, got_b = g.wait(), b.wait()
        if not (same_bits(got_g, want_g) and same_bits(got_g, x)):
            bad.append(f"allgather {name}")
        if not (same_bits(got_b, want_b) and same_bits(got_b, x)):
            bad.append(f"broadcast {name}")
    if bad:
        raise AssertionError(f"engine results differ from the executor's "
                             f"arithmetic on the CPU: {bad}")
    return count


def closed_form(values, dtype, pre, post):
    """An allreduce at n = 1 element by element in Python floats (IEEE
    double): ``v * pre * post``, then the cast back: rounded to a float
    dtype (overflowing to inf), or truncated toward zero and saturated at
    an integer dtype's range. Exact for SATURATING's values, whose
    products need no rounding in the dtype the executor scales in."""
    out = [float(v) * pre * post for v in values.tolist()]
    if dtype.is_floating_point:
        return torch.tensor(out, dtype=torch.float64).to(dtype)
    info = torch.iinfo(dtype)
    return torch.tensor([min(max(math.trunc(y), info.min), info.max)
                         for y in out], dtype=dtype)


SATURATING = (   # (dtype, values, prescale, postscale)
    (torch.int8, torch.arange(-128, 128), 1.0, 2.5),
    (torch.uint8, torch.arange(0, 256), 0.5, 3.0),
    (torch.int64, torch.tensor([-2**62, -2**40 - 3, -7, 0, 5, 2**40 + 1,
                                2**62]), 1.0, 2.5),
    (torch.float16, torch.linspace(-100, 100, 401), 1.0, 1000.0),
    (torch.bfloat16, torch.linspace(-50, 50, 333), 3.0, 1.0),
)


def engine_saturation(hvd):
    """Scaled allreduces whose cast back truncates, saturates or
    overflows, on the card, bit for bit against :func:`closed_form`."""
    bad = []
    for i, (dt, values, pre, post) in enumerate(SATURATING):
        x = values.to(dt)
        got = hvd.allreduce(x.cuda(), average=False, name=f"sat.{i}",
                            prescale_factor=pre, postscale_factor=post)
        if not same_bits(got, closed_form(x, dt, pre, post)):
            bad.append(str(dt))
    if bad:
        raise AssertionError(f"scaled allreduces differ from the closed "
                             f"form: {bad}")
    return len(SATURATING)


def engine_burst(hvd, cp, texec):
    """160 named allreduces of mixed dtypes and both averages, enqueued
    while the engine sleeps; their groups must be the planner's."""
    import os
    gen = torch.Generator().manual_seed(5)
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
              torch.float64, torch.uint8)
    reqs = []
    for i in range(BURST):
        dt = dtypes[i % len(dtypes)]
        n = int(torch.randint(1, 120_000, (1,), generator=gen))
        reqs.append((f"burst.{i}", engine_input(dt, (n,), 1000 + i),
                     bool(i % 3 == 0)))
    items = [cp.Ready(name, cp.fusion_key(cp.ALLREDUCE, cp.dtype_name(
        x.dtype), None, 0, avg, 1.0, 1.0), x.numel() * x.element_size())
        for name, x, avg in reqs]
    want = [tuple(r.name for r in g)
            for g in cp.plan_fusion(items, BURST_THRESHOLD)]
    saved = {k: os.environ.get(k) for k in ("HOROVOD_CYCLE_TIME",
                                            "HOROVOD_FUSION_THRESHOLD")}
    os.environ["HOROVOD_CYCLE_TIME"] = "60000"
    os.environ["HOROVOD_FUSION_THRESHOLD"] = str(BURST_THRESHOLD)
    try:
        hvd.allreduce(torch.zeros(1, device="cuda"), name="burst.quiet")
        time.sleep(0.1)     # the engine now pauses a minute between cycles
        inputs = [(name, x.cuda(), avg) for name, x, avg in reqs]
        t0 = time.perf_counter()
        handles = [hvd.allreduce_async(x, avg, name)
                   for name, x, avg in inputs]
        outs = [h.wait() for h in handles]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got = list(dict.fromkeys(h.group for h in handles))
    if got != want:
        raise AssertionError(f"burst groups {got} differ from the "
                             f"planner's {want}")
    for (name, x, avg), out in zip(reqs, outs):
        if not same_bits(out, texec.fused_allreduce([x], lambda b: b)[0]):
            raise AssertionError(f"burst {name}: wrong result")
    nbytes = sum(x.numel() * x.element_size() for _, x, _ in reqs)
    return len(got), nbytes, ms


def engine_fence(hvd):
    """A producer on a side stream, enqueued without a sync: the engine
    must wait for it (the event recorded at enqueue)."""
    side = torch.cuda.Stream()
    gen = torch.Generator(device="cuda").manual_seed(9)
    w = torch.randn(4096, 4096, generator=gen, device="cuda") / 64
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        x = torch.randn(4096, 4096, generator=gen, device="cuda")
        for _ in range(8):
            x = torch.tanh(x @ w)
        h = hvd.allreduce_async(x, average=False, name="fence")
    out = h.wait()
    torch.cuda.synchronize()
    if not torch.equal(out, x):
        raise AssertionError("the engine read a side-stream producer's "
                             "output before it was written")


def engine_head_dim_96(tfm, fa, build_train_step):
    """d_model 768 with 8 heads (head_dim 96), bf16, S = 1024: the auto
    policy runs the flash kernels (once per layer per step); three steps
    through the engine."""
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_heads=8,
                                n_layers=2, d_ff=3072, max_seq=1024,
                                dtype=torch.bfloat16, remat=False)
    step = build_train_step(cfg, lambda p: torch.optim.AdamW(p, lr=1e-4))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    tok = torch.randint(0, cfg.vocab, (4, 1025),
                        generator=torch.Generator().manual_seed(2)).cuda()
    fa.reset_launch_counts()
    losses = [float(step(model, opt, tok[:, :-1], tok[:, 1:]))
              for _ in range(3)]
    launches = fa.launch_counts()
    want = {name: 3 * cfg.n_layers if name in BF16_FLASH else 0
            for name in launches}
    if not all(math.isfinite(x) for x in losses) or launches != want:
        raise AssertionError(f"head_dim 96: losses {losses}, flash "
                             f"launches {launches}, expected {want}")
    return losses, launches


def engine_phase(hvd, cp, texec, tfm, fa, build_train_step):
    """Phase 10: the collective engine on the card."""
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    n = engine_sweep(hvd, texec)
    log(f"collective engine: {n} sweep results (8 dtypes x 1-3 dims; "
        "allreduce sum/average/scaled, allgather, broadcast) bit for bit "
        "against the executor's arithmetic on the CPU and the n = 1 "
        "closed form")
    n = engine_saturation(hvd)
    log(f"  {n} truncating/saturating/overflowing scaled allreduces bit "
        "for bit against the closed form")
    groups, nbytes, ms = engine_burst(hvd, cp, texec)
    log(f"  burst of {BURST} allreduces ({nbytes / 1e6:.2f} MB, 6 dtypes, "
        f"threshold {BURST_THRESHOLD >> 20} MiB): {groups} groups, as "
        f"planned; {ms:.2f} ms enqueue to done")
    engine_fence(hvd)
    log("  side-stream producer enqueued without a sync: result exact")
    parity(tfm, fa, d_model=768, n_heads=8)
    losses, launches = engine_head_dim_96(tfm, fa, build_train_step)
    log(f"  head_dim 96 (d_model 768, 8 heads), auto policy: flash "
        f"launches {launches} in 3 steps, losses {losses}")
    hvd.shutdown()


# ------------------------------------------------------ the blockwise wire

WIRE_SPECS = ("int8x256", "fp8x256")
WIRE_RAGGED = 1_000_003      # elements: no whole number of blocks
WIRE_STEPS = 3


def wire_input(n, seed):
    """n fp32 values over ten decades (N(0, 1) times e^N(0, 9)), made on
    the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(n, generator=gen, device="cuda")
            * torch.exp(3 * torch.randn(n, generator=gen, device="cuda")))


def same_on_cpu(got, want, what):
    if not same_bits(got, want):
        raise AssertionError(f"{what}: the card's result differs from the "
                             "same function on a CPU copy")


def wire_functions(tq, sizes):
    """The wire's functions on the card against CPU copies, bit for bit;
    returns how many results were compared."""
    count = 0
    for i, n in enumerate(sizes):
        x = wire_input(n, 40 + i)
        xc = x.cpu()
        for name in WIRE_SPECS:
            spec = tq.parse(name)
            pad = tq.padded_size(n, spec.block_size) - n
            xp, xpc = (torch.cat([t, t.new_zeros(pad)]) for t in (x, xc))
            for folded in (False, True):
                q, sc = tq.quantize_blocks(xp, spec, folded)
                qc, scc = tq.quantize_blocks(xpc, spec, folded)
                what = f"quantize_blocks {name} n={n} folded={folded}"
                same_on_cpu(q, qc, what)
                same_on_cpu(sc, scc, what + " scales")
                same_on_cpu(tq.dequantize_blocks(q, sc, spec),
                            tq.dequantize_blocks(qc, scc, spec),
                            f"dequantize_blocks {name} n={n}")
            same_on_cpu(tq.local_roundtrip(x, spec),
                        tq.local_roundtrip(xc, spec),
                        f"local_roundtrip {name} n={n}")
            count += 6
        # The unscaled fp8 cast: magnitudes past ±448, so some overflow.
        y, yc = x * 100, xc * 100
        q, qc = tq.to_e4m3fn(y), tq.to_e4m3fn(yc)
        same_on_cpu(q, qc, f"to_e4m3fn n={n}")
        same_on_cpu(tq.from_e4m3fn(q, torch.float32),
                    tq.from_e4m3fn(qc, torch.float32), f"from_e4m3fn n={n}")
        count += 2
    return count


def wire_allreduce(hvd, tq, n):
    """A blockwise allreduce through the engine at n = 1 against the
    closed form on the CPU: the wire's quantizer twice."""
    for i, name in enumerate(WIRE_SPECS):
        x = wire_input(n, 60 + i)
        spec = tq.parse(name)
        want = torch.cat([x.cpu(), torch.zeros(
            tq.padded_size(n, spec.block_size) - n)])
        # Phase 1 accumulates from zero (so -0 becomes +0), phase 2 not.
        for zero in (0.0, None):
            want = tq.dequantize_blocks(*tq.quantize_blocks(
                want, spec, folded=True), spec)
            want = want if zero is None else want + zero
        comp = (hvd.Compression.int8_blockwise if name.startswith("int8")
                else hvd.Compression.fp8_blockwise)
        got = hvd.allreduce(x, compression=comp, name=f"wire.{name}.{n}")
        same_on_cpu(got, want[:n], f"blockwise allreduce {name} n={n}")


def wire_device_ms(tq, texec, opt, spec):
    """Device ms a step's quantize passes add, per bucket: the error
    feedback (add the residual, round-trip, subtract) and the wire's
    allreduce at n = 1 less the exact one, back-to-back on a copy of each
    bucket's buffer."""
    ident = lambda b: b               # noqa: E731  the collectives at n = 1
    total = []
    for b in opt._buckets:
        buf = b.buffer.clone()
        res = torch.zeros_like(buf)

        def feedback():
            buf.add_(res)
            torch.sub(buf, tq.local_roundtrip(buf, spec), out=res)
        ef = px.time_ms(feedback)
        wire = px.time_ms(lambda: texec.fused_allreduce(
            [buf], ident, wire=spec, world=1, all_to_all_fn=ident,
            all_gather_fn=ident))
        exact = px.time_ms(lambda: texec.fused_allreduce([buf], ident))
        total.append((ef, wire - exact))
    return total


def wire_lm_steps(hvd, tfm, tq, texec, build_train_step, none_step_s):
    """3 flagship LM steps on int8_blockwise; returns the buckets' sizes."""
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                d_ff=3072, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    step = build_train_step(cfg, lambda p: torch.optim.AdamW(
        p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        step.optimizer_factory(model.parameters()),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8_blockwise)
    sync_ms, fires = [], []
    timed_synchronize(opt, sync_ms, fires)
    tok = torch.randint(0, cfg.vocab, (8, 2049),
                        generator=torch.Generator().manual_seed(1)).cuda()
    losses, times = [], []
    for _ in range(WIRE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(model, opt, tok[:, :-1], tok[:, 1:])))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"int8_blockwise LM losses {losses}")
    check_bucket_fires(opt, fires, LM_BUCKETS)
    if len(opt._bucket_residuals) != LM_BUCKETS:
        raise AssertionError("a bucket kept no error-feedback residual")
    per_bucket = wire_device_ms(tq, texec, opt, tq.parse("int8x256"))
    steady = statistics.median(times[1:])
    log(f"  LM on int8_blockwise: losses {losses}; step seconds {times}; "
        f"{8 * 2048 / steady:.1f} tok/s (median of steps 2-{WIRE_STEPS}; "
        f"{8 * 2048 / none_step_s:.1f} on the exact wire in phase 5)")
    log("  " + bucket_line(opt, sync_ms, fires))
    log(f"  quantize device ms per step: error feedback "
        f"{sum(e for e, _ in per_bucket):.3f}, wire less exact "
        f"{sum(w for _, w in per_bucket):.3f}; per bucket (feedback, wire "
        f"less exact) {[(round(e, 3), round(w, 3)) for e, w in per_bucket]}")
    sizes = sorted({b.numel for b in opt._buckets})
    del step, model, opt
    torch.cuda.empty_cache()
    return sizes


def wire_resnet_views(hvd, tres, build_image_train_step, images, labels):
    """One ResNet-50 step on the copy path, on gradient views and with one
    request per gradient: the same gradients, bit for bit. cuDNN runs
    deterministic algorithms for the check."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    step = build_image_train_step(
        functools.partial(tres.ResNet50, num_classes=1000, bn_impl="pallas"),
        lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9))
    grads = {}
    try:
        for kind, kw in (("copy", {}), ("view",
                                        {"gradient_as_bucket_view": True}),
                         ("per-tensor", {"bucket_cap_mb": 0})):
            model = step.make_model(generator=torch.Generator().manual_seed(0))
            opt = hvd.DistributedOptimizer(
                step.optimizer_factory(model.parameters()),
                named_parameters=model.named_parameters(), **kw)
            if kind == "view" and len(opt._grad_views) != len(
                    list(model.parameters())):
                raise AssertionError("gradient views were not installed")
            step(model, opt, images, labels)
            grads[kind] = [p.grad.clone() for p in model.parameters()]
            del model, opt
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    for kind in ("view", "per-tensor"):
        bad = [i for i, (a, b) in enumerate(zip(grads["copy"], grads[kind]))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"ResNet-50 gradients on the {kind} path "
                                 f"differ from the copy path in {len(bad)} "
                                 "tensors")
    return len(grads["copy"])


def wire_phase(hvd, tfm, tres, texec, build_train_step,
               build_image_train_step, none_step_s):
    """Phase 11: the blockwise wire on the card."""
    from horovod_tpu_torch import quantization as tq
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    log("blockwise wire:")
    sizes = wire_lm_steps(hvd, tfm, tq, texec, build_train_step,
                          none_step_s)
    n = wire_functions(tq, sizes + [WIRE_RAGGED])
    log(f"  {n} results of quantize_blocks (both scale forms), "
        f"dequantize_blocks, local_roundtrip and the e4m3 casts at "
        f"{sizes + [WIRE_RAGGED]} elements bit for bit against CPU copies")
    for n in (sizes[0], WIRE_RAGGED):
        wire_allreduce(hvd, tq, n)
    log(f"  blockwise allreduce (int8, fp8) at n = 1 of {sizes[0]} and "
        f"{WIRE_RAGGED} elements bit for bit against the closed form")
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                         generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                           device="cuda")
    n = wire_resnet_views(hvd, tres, build_image_train_step, images, labels)
    log(f"  ResNet-50: {n} gradients bit for bit on the copy path, on "
        "gradient views and with one request per gradient")
    hvd.shutdown()


# ------------------------------------ tensor and sequence parallelism

# (b, h, s, d, causal) of phase 12a; the first is timed. D=128 at the
# flagship's B and H, the S of its shards at n = 1, 2 and 4, and ragged;
# D=96 at the head_dim-96 LM's B and H.
F32_SHAPES = [(8, 6, 2048, 128, True), (8, 6, 2048, 128, False),
              (8, 6, 1024, 128, True), (8, 6, 1024, 128, False),
              (8, 6, 512, 128, True), (8, 6, 512, 128, False),
              (2, 6, 1000, 128, True), (4, 8, 1024, 96, True),
              (4, 8, 1024, 96, False), (2, 3, 200, 96, True)]


def randn_bf16_cuda(seed, *shape):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=gen, device="cuda").bfloat16()


def time_f32_forms(fa, inputs, scale, causal, absmax):
    """Phase 12a's timing: the fp32-output forms of K1-K3, each beside
    its bf16 form, and the plain fp32 versions, back-to-back; their
    rows of the ``kernels`` line."""
    q, k, v, do, lse_ref, delta = inputs
    bh, s, d = q.shape
    f32 = torch.float32
    n_pairs = pairs(s, s, causal) * bh
    elem = bh * s * d
    work = {   # (operations, bytes): bf16 operands, fp32 outputs and stats
        "flash_fwd_f32": (4 * d * n_pairs, 3 * elem * 2 + elem * 4
                          + bh * s * 4),
        "flash_dkv_f32": (8 * d * n_pairs, 4 * elem * 2 + 2 * elem * 4
                          + 2 * bh * s * 4),
        "flash_dq_f32": (6 * d * n_pairs, 4 * elem * 2 + elem * 4
                         + 2 * bh * s * 4),
    }
    calls = {   # out_dtype None: the bf16 form
        "flash_fwd": lambda o=None: fa.flash_fwd_cuda(q, k, v, scale,
                                                      causal, o),
        "flash_dkv": lambda o=None: fa.flash_dkv_cuda(
            q, k, v, do, lse_ref, delta, scale, causal, o),
        "flash_dq": lambda o=None: fa.flash_dq_cuda(
            q, k, v, do, lse_ref, delta, scale, causal, o),
    }
    b2b = {}
    for name, fn in calls.items():   # each bf16 form beside its fp32 form
        b2b[name] = px.time_ms(fn)
        b2b[name + "_f32"] = px.time_ms(functools.partial(fn, f32))
    log(f"  back-to-back ms at the flagship, bf16 and fp32 forms "
        f"{json.dumps(b2b)}")
    plain_fwd = px.time_ms(lambda: fa.flash_fwd_reference(
        q, k, v, scale, causal, f32))
    plain_bwd = px.time_ms(lambda: fa.flash_bwd_reference(
        q, k, v, do, lse_ref, delta, scale, causal, f32))
    rows = {}
    for name in F32_FLASH:
        ops, nbytes = work[name]
        b_ms, b_by = bound_ms(ops, nbytes)
        rows[name] = {"ms": b2b[name],
                      "plain_ms": plain_fwd if name == "flash_fwd_f32"
                      else plain_bwd,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "max_abs_err": absmax[name], "gflop": ops / 1e9,
                      "mbytes": nbytes / 1e6, "bf16_ms": b2b[name[:-4]]}
        log(f"  {name}: {json.dumps(rows[name])}")
    return rows


def shift(blocks):
    """The ring's shift by hand: virtual rank i receives rank i-1's."""
    return [blocks[(i - 1) % len(blocks)] for i in range(len(blocks))]


def virtual_ring(fa, rf, n, b=8, h=6, s=2048, d=128, causal=True):
    """Phase 12b: one sequence split into ``n`` virtual ranks in this
    process, each running the ring's per-step bodies, held against the
    single-device kernels and the plain version."""
    bh = b * h
    q, k, v, do = (randn_bf16_cuda(77 + i, bh, s, d) for i in range(4))
    scale = d ** -0.5
    o1, lse1 = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta1 = (do.float() * o1.float()).sum(-1, keepdim=True)
    dk1, dv1 = fa.flash_dkv_cuda(q, k, v, do, lse1, delta1, scale, causal)
    dq1 = fa.flash_dq_cuda(q, k, v, do, lse1, delta1, scale, causal)
    op, lsep = fa.flash_fwd_reference(q, k, v, scale, causal)
    deltap = (do.float() * op.float()).sum(-1, keepdim=True)
    dqp, dkp, dvp = fa.flash_bwd_reference(q, k, v, do, lsep, deltap, scale,
                                           causal)
    qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(n, dim=1)]
                       for x in (q, k, v, do))

    fa.reset_launch_counts()
    carry = [(None, None)] * n
    kres, vres = ks, vs
    for t in range(n):
        carry = [rf.ring_flash_fwd_step(qs[i], kres[i], vres[i], *carry[i],
                                        rf.ring_branch(i, t, n, causal),
                                        scale) for i in range(n)]
        kres, vres = shift(kres), shift(vres)
    fwd_counts = fa.launch_counts()
    outs = [o.to(torch.bfloat16) for o, _ in carry]
    lses = [lse for _, lse in carry]
    deltas = [(g.float() * o.float()).sum(-1, keepdim=True)
              for g, o in zip(dos, outs)]
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    kres, vres = ks, vs
    for t in range(n):
        for i in range(n):
            dq[i], dk[i], dv[i] = rf.ring_flash_bwd_step(
                qs[i], kres[i], vres[i], dos[i], lses[i], deltas[i], dq[i],
                dk[i], dv[i], rf.ring_branch(i, t, n, causal), scale)
        kres, vres, dk, dv = shift(kres), shift(vres), shift(dk), shift(dv)
    counts = fa.launch_counts()
    blocks = n * (n + 1) // 2 if causal else n * n
    want_fwd = {**{x: 0 for x in counts}, "flash_fwd_f32": blocks}
    want = {**want_fwd, "flash_dkv_f32": blocks, "flash_dq_f32": blocks}
    if fwd_counts != want_fwd or counts != want:
        raise AssertionError(f"virtual ring n={n}: launches forward "
                             f"{fwd_counts}, in all {counts}; the branch "
                             f"rule gives {want}")
    o = torch.cat(outs, dim=1)
    lse = torch.cat(lses, dim=1)
    got = [torch.cat([x.to(torch.bfloat16) for x in g], dim=1)
           for g in (dq, dk, dv)]
    errs = {"kernels": {"o": relerr(o, o1), "lse": abserr(lse, lse1),
                        "dq": relerr(got[0], dq1), "dk": relerr(got[1], dk1),
                        "dv": relerr(got[2], dv1)},
            "plain": {"o": relerr(o, op), "lse": abserr(lse, lsep),
                      "dq": relerr(got[0], dqp), "dk": relerr(got[1], dkp),
                      "dv": relerr(got[2], dvp)}}
    for against, e in errs.items():
        for out, val in e.items():
            tol = LSE_TOL if out == "lse" else REL_TOL
            if not (val <= tol):
                raise AssertionError(
                    f"virtual ring n={n}: {out} against the single-device "
                    f"{against} off by {val} > {tol}")
    split = (f"{n} diagonal, {blocks - n} past, {n * n - blocks} skipped"
             if causal else f"{blocks} non-causal")
    log(f"  virtual ring n={n} (B={b} H={h} S={s} D={d} causal={causal}): "
        f"launches {dict((x, counts[x]) for x in F32_FLASH)} ({split}); "
        f"errors {json.dumps(errs)}")


def same_or_close(got, want, what):
    """Bit for bit, or (a finding, logged) within 1e-3 relative."""
    if torch.equal(got, want):
        return True
    rel = relerr(got, want)
    log(f"  FINDING: {what} not bit for bit; max rel diff {rel:.3e}")
    if not rel <= 1e-3:
        raise AssertionError(f"{what}: {rel} > 1e-3 relative")
    return False


def tp_sp_main_path(hvd, tfm, fa, build_train_step, create_mesh, lm_loss1,
                    lm_step_s, f32_rows, profile):
    """Phase 12c; returns the fp32 forms' launch counts of its 5 steps."""
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    mesh = create_mesh(dp=1, tp=1, sp=1)
    kw = dict(vocab=32000, d_model=768, n_layers=12, d_ff=3072,
              max_seq=2048, dtype=torch.bfloat16, remat=False)
    b, s = 8, 2048
    tok = torch.randint(0, kw["vocab"], (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()

    def factory(p):
        return torch.optim.AdamW(p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    # Phase 5's first step on the same weights and tokens: its loss and
    # the gradients that step's backward gives.
    ref = tfm.Transformer(tfm.TransformerConfig(**kw),
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    ref_loss = ref.loss_fn(tokens, targets)
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref

    cfg = tfm.TransformerConfig(tp_axis="tp", sp_axis="sp", **kw)
    step = build_train_step(cfg, factory, mesh=mesh)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses, times = [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    launches = fa.launch_counts()
    log(f"tp/sp main path (mesh dp=1 tp=1 sp=1, ring): losses {losses}")
    log(f"  step seconds {times}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"tp/sp losses not finite and falling: {losses}")
    check_flash_launches(launches, 0, cfg.n_layers)
    steady = statistics.median(times[1:])
    per_step = cfg.n_layers * sum(f32_rows[n]["ms"] for n in F32_FLASH)
    log(f"  {b * s / steady:.1f} tok/s (median of steps 2-{STEPS}, "
        f"{steady * 1e3:.2f} ms/step) beside phase 5's "
        f"{b * s / lm_step_s:.1f} ({lm_step_s * 1e3:.2f} ms/step); fp32 "
        f"forms {per_step:.3f} ms per step ({cfg.n_layers} launches each "
        f"at their back-to-back ms); launches {launches}")
    exact = same_or_close(torch.tensor(losses[0]), torch.tensor(ref_loss),
                          "step 1 loss against phase 5's first step")
    exact &= same_or_close(torch.tensor(losses[0]), torch.tensor(lm_loss1),
                           "step 1 loss against phase 5's logged loss")
    if grads.keys() != ref_grads.keys():
        raise AssertionError("the mesh model's parameters are not phase 5's")
    for n in ref_grads:
        exact &= same_or_close(grads[n], ref_grads[n], f"gradient {n}")
    log(f"  step 1: loss {losses[0]!r} against phase 5's {lm_loss1!r} "
        f"(recomputed {ref_loss!r}), {len(grads)} gradients: "
        f"{'bit for bit' if exact else 'within 1e-3 (see FINDING)'}")
    if profile:
        profile_steps(lambda: step(model, opt, tokens, targets), profile,
                      "LM tp/sp mesh step (ring, fp32 forms)")
    del model, opt, grads, ref_grads

    cfg_u = tfm.TransformerConfig(tp_axis="tp", sp_axis="sp",
                                  sp_impl="ulysses", **kw)
    step_u = build_train_step(cfg_u, factory, mesh=mesh)
    model_u = step_u.make_model(generator=torch.Generator().manual_seed(0))
    opt_u = step_u.make_optimizer(model_u)
    fa.reset_launch_counts()
    losses_u = [float(step_u(model_u, opt_u, tokens, targets))
                for _ in range(2)]
    counts_u = fa.launch_counts()
    if not all(math.isfinite(x) for x in losses_u):
        raise AssertionError(f"Ulysses losses {losses_u}")
    check_flash_launches(counts_u, cfg.n_layers, 0, steps=2)
    log(f"  Ulysses (sp_impl='ulysses'): losses {losses_u}, launches "
        f"{counts_u}")
    hvd.shutdown()
    return {n: launches[n] for n in F32_FLASH}


def tp_sp_phase(hvd, tfm, fa, build_train_step, lm_loss1, lm_step_s,
                profile):
    """Phase 12: the fp32 forms, the virtual ring and the tp/sp step."""
    from horovod_tpu_torch.parallel import ring_attention as rf
    from horovod_tpu_torch.parallel.mesh import create_mesh
    log("fp32-output forms of K1-K3 vs plain fp32 (tolerance: rel "
        f"{REL_TOL} on O/dQ/dK/dV, abs {LSE_TOL} on lse):")
    rows = {}
    for k, shape in enumerate(F32_SHAPES):
        rows.update(check_kernels(fa, *shape, timed=k == 0,
                                  out_dtype=torch.float32) or {})
    for n in (2, 4):
        virtual_ring(fa, rf, n)
    launches = tp_sp_main_path(hvd, tfm, fa, build_train_step, create_mesh,
                               lm_loss1, lm_step_s, rows, profile)
    torch.cuda.empty_cache()
    return rows, launches


FLAGSHIP = dict(vocab=32000, d_model=768, n_layers=12, d_ff=3072,
                max_seq=2048, dtype=torch.bfloat16, remat=False)
BUCKET_ELEMENTS = 64 * 2**20 // 4   # one 64 MiB bucket of fp32


def adamw(p):
    return torch.optim.AdamW(p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def flagship_batch(vocab, b=8, s=2048):
    tok = torch.randint(0, vocab, (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    return tok[:, :-1].cuda(), tok[:, 1:].cuda()


def state_bytes(opt):
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def zero1_run(step, tokens, targets, zero1, ref):
    """5 steps through ``step`` from the seed-0 flagship; (losses, step
    seconds, optimizer-state bytes). Without ``zero1`` ``ref`` receives
    the parameters after steps 1-3 (``"params"``) and step 1's gradients
    (``"grads"``); with it, the parameters are held to them bit for
    bit."""
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model, zero1=zero1)
    losses, times = [], []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i >= 3:
            continue
        params = dict(model.named_parameters())
        if not zero1:
            ref.setdefault("params", []).append(
                {n: p.detach().clone() for n, p in params.items()})
            if i == 0:
                ref["grads"] = {n: p.grad.clone() for n, p in params.items()}
            continue
        want = ref["params"][i]
        bad = [n for n in want if not torch.equal(params[n], want[n])]
        if bad:
            raise AssertionError(f"ZeRO-1 step {i + 1}: {len(bad)} "
                                 f"parameters differ, first {bad[0]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    return losses, times, state_bytes(opt)


def dcn_step(build_train_step, tfm, mesh, wire, tokens, targets):
    """One flagship step with ``dcn_axis="dcn"``; (loss, parameters,
    reduced gradients)."""
    step = build_train_step(tfm.TransformerConfig(**FLAGSHIP), adamw,
                            mesh=mesh, dcn_axis="dcn", dcn_wire=wire)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    loss = float(step(model, opt, tokens, targets))
    return (loss, {n: p.detach() for n, p in model.named_parameters()},
            {n: p.grad for n, p in model.named_parameters()})


def quantized_psum_check(tq, mesh):
    """quantized_psum over a world-1 axis on the card against the same
    call on the CPU copy of its input, bit for bit."""
    for k, spec in enumerate(("int8x256", "fp8x256")):
        x = torch.randn(BUCKET_ELEMENTS, generator=torch.Generator()
                        .manual_seed(40 + k)).mul_(1e-3)
        got = tq.quantized_psum(x.cuda(), mesh, "dcn", spec).cpu()
        want = tq.quantized_psum(x, mesh, "dcn", spec)
        if not same_bits(got, want):
            raise AssertionError(f"quantized_psum {spec} on the card is not "
                                 "the CPU's")
        log(f"  quantized_psum {spec}, {BUCKET_ELEMENTS} elements at world "
            f"1: bit for bit the CPU copy (max |x - q(x)| "
            f"{float((got - x).abs().max()):.3e})")


def zero_dcn_phase(hvd, tfm, tq, build_train_step, create_mesh, lm_step_s):
    """Phase 13: ZeRO-1 and the hierarchical step at world 1."""
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    tokens, targets = flagship_batch(FLAGSHIP["vocab"])
    n_tok = tokens.numel()
    step = build_train_step(tfm.TransformerConfig(**FLAGSHIP), adamw,
                            mesh=create_mesh(dp=1))
    ref = {}
    runs = {}
    for zero1 in (False, True):
        runs[zero1] = zero1_run(step, tokens, targets, zero1, ref)
        losses, times, nbytes = runs[zero1]
        steady = statistics.median(times[1:])
        log(f"ZeRO-1 {'on ' if zero1 else 'off'} (mesh dp=1): losses "
            f"{losses}; {n_tok / steady:.1f} tok/s (median of steps "
            f"2-{STEPS}, {steady * 1e3:.2f} ms/step; phase 5's "
            f"{n_tok / lm_step_s:.1f}); optimizer state "
            f"{nbytes / 2**20:.1f} MiB on the rank")
    if runs[True][0][0] != runs[False][0][0]:
        raise AssertionError(f"ZeRO-1 step 1 loss {runs[True][0][0]!r} is "
                             f"not the mesh step's {runs[False][0][0]!r}")
    log("  ZeRO-1: step 1's loss and the parameters after steps 1-3 bit "
        "for bit the mesh step's")
    flat_loss = runs[False][0][0]
    flat_params, flat_grads = ref["params"][0], ref["grads"]
    del ref
    mesh = create_mesh(dcn=1, dp=1)
    loss, params, grads = dcn_step(build_train_step, tfm, mesh, None,
                                   tokens, targets)
    if loss != flat_loss or any(not torch.equal(params[n], flat_params[n])
                                for n in flat_params):
        raise AssertionError("the hierarchical step at dcn=1, dp=1 is not "
                             "the flat step bit for bit")
    log("  hierarchical (dcn_axis='dcn', exact): step 1's loss and "
        "parameters bit for bit the flat step's")
    del params, grads
    loss, params, grads = dcn_step(build_train_step, tfm, mesh, "int8x256",
                                   tokens, targets)
    if loss != flat_loss:
        raise AssertionError(f"the int8x256 step's loss {loss!r} is not the "
                             f"flat step's {flat_loss!r}")
    names = list(flat_grads)
    want = tq.quantized_psum_many([flat_grads[n].cpu() for n in names],
                                  mesh, "dcn", "int8x256")
    for n, w in zip(names, want):
        if not same_bits(grads[n].cpu(), w):
            raise AssertionError(f"int8x256 gradient {n} is not "
                                 "quantized_psum of the flat one")
    moved = max(float((params[n] - flat_params[n]).abs().max())
                for n in names)
    log(f"  hierarchical with dcn_wire='int8x256': step 1's loss bit for "
        f"bit; its {len(names)} reduced gradients bit for bit "
        f"quantized_psum of the flat ones on the CPU; parameters within "
        f"{moved:.3e} of the flat step's")
    del params, grads, flat_params, flat_grads
    quantized_psum_check(tq, mesh)
    hvd.shutdown()
    torch.cuda.empty_cache()


def moe_main_path(hvd, tfm, fa, build_train_step, create_mesh, profile):
    """Phase 14: the MoE flagship, 5 steps on one card."""
    hvd.init()
    cfg = tfm.TransformerConfig(num_experts=8, capacity_factor=2.0,
                                ep_axis="ep", **FLAGSHIP)
    step = build_train_step(cfg, adamw, mesh=create_mesh(dp=1, ep=1))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    opt = step.make_optimizer(model)
    tokens, targets = flagship_batch(cfg.vocab)
    model.moe_drops = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = train_steps(step, model, opt, tokens, targets)
    launches = fa.launch_counts()
    n_moe = cfg.n_layers // 2
    dropped = [int(d) / tokens.numel() for d in model.moe_drops[:n_moe]]
    model.moe_drops = None
    steady = statistics.median(times[1:])
    log(f"MoE main path (8 experts, capacity factor 2.0, mesh dp=1 ep=1): "
        f"{n_params} params, losses {losses}")
    log(f"  step seconds {times}")
    log(f"  {tokens.numel() / steady:.1f} tok/s (median of steps 2-{STEPS}, "
        f"{steady * 1e3:.2f} ms/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  tokens dropped at step 1 per MoE layer: "
        f"{[round(x, 4) for x in dropped]}")
    log(f"  launches {launches}")
    check_flash_launches(launches, cfg.n_layers, 0)
    if profile:
        profile_steps(lambda: step(model, opt, tokens, targets), profile,
                      "LM MoE train step")
    del model, opt
    hvd.shutdown()
    torch.cuda.empty_cache()


# ------------------------------------------------ the pipelined flagship

# (schedule, num_virtual) of phase 15; interleaved at V = 3 so that the
# 12 layers divide into pp·V = 12 chunks at pp = 4.
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("zb-h1", 1),
                  ("interleaved", 3))
PIPE_M = 8            # phase 5's 8 x 2048 tokens as 8 microbatches of 1
PIPE_VIRTUAL = 4      # (b)'s stages in one process
PIPE_VIRTUAL_STEPS = 3
# K1, K2, K3 launches per microbatch and layer: gpipe recomputes the
# forward in its backward sweep; zb-h1's W walks the activation-gradient
# chain again after Bx.
PIPE_PER_MB_LAYER = {"gpipe": (2, 1, 1), "1f1b": (1, 1, 1),
                     "interleaved": (1, 1, 1), "zb-h1": (1, 2, 2)}
# Step 1's loss against phase 5's on the same weights and tokens
# (relative). The fused schedules add 8 microbatch means where phase 5
# takes one mean of 16,384 tokens: fp32 sums in another order, 6.4e-8
# on an H100 with torch 2.11 and CUDA 12.8, where the per-token losses
# came out the same bits (gpipe's mean of the stacked means: 0). The
# bound leaves room for GEMMs that a cuBLAS tiles otherwise on 2,048
# rows than on 16,384, which would round the bf16 activations otherwise.
PIPE_LOSS_TOL = 1e-4


def pipe_tensors(models, n, grads=False):
    """{name: tensor} of the whole model (or with ``grads`` its
    gradients) from the 'pp' ranks' models: ``layers.{i}.{key}`` in
    layer order, and ``rank{r}.{name}`` for every rank's ``embed``,
    ``pos`` and ``ln_f``."""
    out = {}
    for r, model in enumerate(models):
        lpc = len(model.chunks[0])
        for key, p in model.named_parameters():
            t = p.grad if grads else p.detach()
            if key.startswith("chunks."):
                _, v, i, leaf = key.split(".")
                out[f"layers.{(int(v) * n + r) * lpc + int(i)}.{leaf}"] = t
            else:
                out[f"rank{r}.{key}"] = t
    return out


def same_tensors(got, want, what):
    """Bit for bit over matching names (``rank{r}.`` entries of a
    multi-rank ``got`` against ``rank0.`` of ``want``), or (a finding,
    logged) each within 1e-3 relative."""
    exact = True
    for name, t in got.items():
        ref = want[name if name in want else "rank0." + name.split(".", 1)[1]]
        exact &= same_or_close(t, ref, f"{what}: {name}")
    return exact


def pipe_launches(schedule, n_layers):
    """K1, K2 and K3 launches per pipelined step of PIPE_M
    microbatches."""
    return tuple(c * PIPE_M * n_layers for c in PIPE_PER_MB_LAYER[schedule])


def pipe_one_card(ttrain, cfg, mesh, full, schedule, v, tok_mb, tgt_mb, fa,
                  lm_loss1, lm_step_s, profile):
    """(a): ``create_mesh(pp=1)``, STEPS steps; returns (losses, step
    seconds, parameters and gradients after step 1, launches)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    step = ttrain.build_pipeline_train_step(cfg, mesh, adamw,
                                            schedule=schedule,
                                            num_virtual=v)
    model = step.make_model(params=step.shard_params(
        ttrain.to_pipeline_params(cfg, full, 1, v)))
    opt = step.make_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, opt, tok_mb, tgt_mb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            after1 = {k: t.clone()
                      for k, t in pipe_tensors([model], 1).items()}
            grads1 = {k: t.clone()
                      for k, t in pipe_tensors([model], 1, True).items()}
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(times[1:])
    n_tok = tok_mb.numel()
    rel = abs(losses[0] - lm_loss1) / abs(lm_loss1)
    log(f"  (a) {schedule}{f' V={v}' if v > 1 else ''} on pp=1: losses "
        f"{losses}; step seconds {times}; {n_tok / steady:.1f} tok/s "
        f"(median of steps 2-{STEPS}, {steady * 1e3:.2f} ms/step) beside "
        f"phase 5's {n_tok / lm_step_s:.1f} ({lm_step_s * 1e3:.2f} "
        f"ms/step); peak memory {peak:.2f} GiB ({base:.2f} GiB held "
        f"before the model); step 1 loss {losses[0]!r} "
        f"against phase 5's {lm_loss1!r}: rel {rel:.3e} (tolerance "
        f"{PIPE_LOSS_TOL}); launches {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{schedule}: losses not finite and falling: "
                             f"{losses}")
    if not rel <= PIPE_LOSS_TOL:
        raise AssertionError(f"{schedule}: step 1 loss {losses[0]} against "
                             f"phase 5's {lm_loss1}: {rel} > "
                             f"{PIPE_LOSS_TOL}")
    check_flash_launches(launches, pipe_launches(schedule, cfg.n_layers), 0)
    if profile:
        profile_steps(lambda: step(model, opt, tok_mb, tgt_mb), profile,
                      f"LM pipeline step, {schedule}, pp=1")
    del model, opt
    return losses, times, after1, grads1, launches, peak


def pipe_virtual(ttrain, cfg, full, schedule, v, tok_mb, tgt_mb, fa,
                 loss1, after1):
    """(b): PIPE_VIRTUAL stages in this process, PIPE_VIRTUAL_STEPS
    steps; step 1's loss and parameters against (a)'s. Returns the step
    seconds."""
    n = PIPE_VIRTUAL
    step = ttrain._virtual_pipeline_train_step(cfg, n, adamw,
                                               schedule=schedule,
                                               num_virtual=v)
    tree = ttrain.to_pipeline_params(cfg, full, n, v)
    models = [step.make_model(params=step.shard_params(tree, r))
              for r in range(n)]
    opts = [step.make_optimizer(m) for m in models]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    times = []
    for i in range(PIPE_VIRTUAL_STEPS):
        t0 = time.perf_counter()
        loss = float(step(models, opts, tok_mb, tgt_mb))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            exact = same_or_close(torch.tensor(loss), torch.tensor(loss1),
                                  f"(b) {schedule} step 1 loss")
            exact &= same_tensors(pipe_tensors(models, n), after1,
                                  f"(b) {schedule} after step 1")
    check_flash_launches(fa.launch_counts(),
                         pipe_launches(schedule, cfg.n_layers), 0,
                         steps=PIPE_VIRTUAL_STEPS)
    info = step.schedule_info(PIPE_M)
    log(f"  (b) {schedule} on {n} virtual stages: step 1's loss and "
        f"{sum(p.numel() for m in models for p in m.parameters())} "
        f"parameter values "
        f"{'bit for bit' if exact else 'within 1e-3 (see FINDING)'} (a)'s; "
        f"step seconds {times}; (e) schedule_info n={n} m={PIPE_M}"
        f"{f' V={v}' if v > 1 else ''}: ticks {info.ticks}, bubble share "
        f"{info.bubble_share:.4f} (the virtual stages run one after "
        f"another on one card, so their wall time holds no bubble)")
    del models, opts
    return times


def pipeline_phase(hvd, tfm, fa, create_mesh, lm_loss1, lm_step_s,
                   profile):
    """Phase 15: the pipelined flagship; returns the launch counts of
    (a), its main path."""
    from horovod_tpu_torch.parallel import train as ttrain
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    cfg = tfm.TransformerConfig(**FLAGSHIP)
    full = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, targets = flagship_batch(cfg.vocab)
    tok_mb = tokens.reshape(PIPE_M, -1, tokens.shape[1])
    tgt_mb = targets.reshape(PIPE_M, -1, targets.shape[1])
    mesh = create_mesh(pp=1)
    launches = {n: 0 for n in BF16_FLASH}
    runs = {}
    for schedule, v in PIPE_SCHEDULES:
        losses, _, after1, grads1, counts, _ = pipe_one_card(
            ttrain, cfg, mesh, full, schedule, v, tok_mb, tgt_mb, fa,
            lm_loss1, lm_step_s, profile)
        for n in BF16_FLASH:
            launches[n] += counts[n]
        pipe_virtual(ttrain, cfg, full, schedule, v, tok_mb, tgt_mb, fa,
                     losses[0], after1)
        runs[schedule] = (losses[0], grads1)
        del after1
        torch.cuda.empty_cache()
    base_loss, base_grads = runs["gpipe"]
    for schedule in ("1f1b", "zb-h1", "interleaved"):
        loss, grads = runs[schedule]
        exact = same_or_close(torch.tensor(loss), torch.tensor(base_loss),
                              f"{schedule} step 1 loss against gpipe's")
        exact &= same_tensors(grads, base_grads,
                              f"{schedule} step 1 gradients against gpipe's")
        log(f"  {schedule} against gpipe at step 1: loss and "
            f"{len(grads)} gradients "
            f"{'bit for bit' if exact else 'within 1e-3 (see FINDING)'}")
    del runs
    log("  (d) K1-K3 at the microbatch's shape (B=1, H=6, S=2048):")
    check_kernels(fa, 1, 6, 2048, 128, True, timed=True)
    hvd.shutdown()
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# Phases 3b, 16 and 17: the flash forms of every operand dtype and head
# dim, the flagship LM in fp16 and fp32, and the engine's remainder.
# ---------------------------------------------------------------------------

FORMS = {   # entry-point suffix: (operand dtype, out_dtype)
    "": (torch.bfloat16, None), "_f32": (torch.bfloat16, torch.float32),
    "_f16": (torch.float16, None),
    "_f16_f32": (torch.float16, torch.float32),
    "_fp32": (torch.float32, None)}
NEW_FORMS = ("_f16", "_f16_f32", "_fp32")
# Per operand dtype: O's and the gradients' tolerance (share of max
# |plain|), lse's, and whether lse's is relative too.
FORM_TOL = {torch.bfloat16: (REL_TOL, REL_TOL, LSE_TOL, False),
            torch.float16: (5e-3, 5e-3, 1e-3, False),
            torch.float32: (2e-5, 1e-4, 2e-5, True)}
PEAK = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float16: PEAK_BF16_FLOPS,
        torch.float32: PEAK_FP32_FLOPS}
SWEEP_DIMS = (8, 16, 48, 80, 112, 160, 192, 256)
SWEEP_SHAPES = ((True, 200, 200), (False, 130, 250), (True, 257, 70))
DTYPE_STEPS = 3
DTYPE_LOSS_TOL = {torch.float16: 1e-4, torch.float32: 1e-5}
STALL_WARNING_S = 1.0


def form_names(sfx):
    return tuple(f"flash_{k}{sfx}" for k in ("fwd", "dkv", "dq"))


def check_form(fa, sfx, bh, sq, sk, d, causal, seed):
    """Hold one form of K1-K3 to its plain versions at one shape (sq
    queries, sk keys) and to bit-identical repeats. Returns ({kernel: max
    abs error}, {output: error in its tolerance's unit}, the inputs and
    the plain statistics)."""
    dtype, out = FORMS[sfx]
    tol, gtol, ltol, lrel = FORM_TOL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal, out)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(
        q, k, v, do, lse_ref, delta, scale, causal, out)

    def kernels():
        return (*fa.flash_fwd_cuda(q, k, v, scale, causal, out),
                *fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale,
                                   causal, out),
                fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal,
                                 out))
    (o, lse, dk, dv, dq), again = kernels(), kernels()
    torch.cuda.synchronize()
    where = f"flash{sfx} at BH={bh} sq={sq} sk={sk} D={d} causal={causal}"
    if not all(t.dtype == (out or dtype) for t in (o, dk, dv, dq)):
        raise AssertionError(f"{where}: wrote another dtype than "
                             f"{out or dtype}")
    if not all(torch.equal(x, y)
               for x, y in zip((o, lse, dk, dv, dq), again)):
        raise AssertionError(f"{where}: two calls gave different bits")
    lse_err = abserr(lse, lse_ref)
    if lrel:
        lse_err /= float(lse_ref.abs().max())
    errs = {"o": relerr(o, o_ref), "lse": lse_err, "dq": relerr(dq, dq_ref),
            "dk": relerr(dk, dk_ref), "dv": relerr(dv, dv_ref)}
    limits = {"o": tol, "lse": ltol, "dq": gtol, "dk": gtol, "dv": gtol}
    for name, err in errs.items():
        if not err <= limits[name]:
            raise AssertionError(f"{where}: {name} off its plain version by "
                                 f"{err} > {limits[name]}")
    fwd, dkv, dq_name = form_names(sfx)
    absmax = {fwd: max(abserr(o, o_ref), abserr(lse, lse_ref)),
              dkv: max(abserr(dk, dk_ref), abserr(dv, dv_ref)),
              dq_name: abserr(dq, dq_ref)}
    return absmax, errs, (q, k, v, do, lse_ref, delta)


def time_form(fa, sfx, b, h, s, d, causal=True):
    """One form of K1-K3 at [B*H, S, D]: checked, then timed
    back-to-back beside its plain versions and, for a form with the
    operands' own output dtype, PyTorch's SDPA at that dtype (a
    yardstick only); bounds at the dtype's peak. Returns the rows."""
    dtype, out = FORMS[sfx]
    bh = b * h
    absmax, _, (q, k, v, do, lse, delta) = check_form(
        fa, sfx, bh, s, s, d, causal, 1234 + s + d)
    scale = d ** -0.5
    calls = {
        "fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, causal, out),
        "dkv": lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale,
                                         causal, out),
        "dq": lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, scale,
                                       causal, out)}
    b2b = {kn: px.time_ms(fn) for kn, fn in calls.items()}
    plain = {"fwd": px.time_ms(lambda: fa.flash_fwd_reference(
        q, k, v, scale, causal, out))}
    plain["dkv"] = plain["dq"] = px.time_ms(lambda: fa.flash_bwd_reference(
        q, k, v, do, lse, delta, scale, causal, out))
    library = {"fwd": None, "dkv": None, "dq": None}
    if out is None:
        sdpa = flash_times.calls(q, k, v, do, b, h, causal)
        library["fwd"] = px.time_ms(sdpa["sdpa_fwd"])
        library["dkv"] = library["dq"] = px.time_ms(sdpa["sdpa_bwd"])
    n_pairs = pairs(s, s, causal) * bh
    elem, stats = bh * s * d, bh * s * 4
    isz, osz = dtype.itemsize, (out or dtype).itemsize
    work = {   # (operations, bytes): each input read once, output written once
        "fwd": (4 * d * n_pairs, 3 * elem * isz + elem * osz + stats),
        "dkv": (8 * d * n_pairs, 4 * elem * isz + 2 * elem * osz + 2 * stats),
        "dq": (6 * d * n_pairs, 4 * elem * isz + elem * osz + 2 * stats)}
    rows = {}
    for kn, name in zip(("fwd", "dkv", "dq"), form_names(sfx)):
        ops, nbytes = work[kn]
        b_ms, b_by = bound_ms(ops, nbytes, PEAK[dtype])
        rows[name] = {"ms": b2b[kn], "plain_ms": plain[kn],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library[kn], "max_abs_err": absmax[name],
                      "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        log(f"  B={b} H={h} S={s} D={d} {name}: {json.dumps(rows[name])}")
    return rows


def flash_forms_phase(fa):
    """Phase 3b: every form (bf16, fp16 and fp32 operands; the 16-bit
    ones with their fp32-output forms) against its plain version at head
    dims 8-256, causal and not, ragged; the new forms timed at the
    flagship, and each operand dtype's own form at D=256. Returns the
    new forms' rows of the ``kernels`` line."""
    log("flash forms vs plain at head dims "
        f"{SWEEP_DIMS} x (causal, sq, sk) {SWEEP_SHAPES}; tolerances "
        "(O, gradients of max |plain|; lse) bf16 "
        f"{FORM_TOL[torch.bfloat16][:3]}, fp16 "
        f"{FORM_TOL[torch.float16][:3]}, fp32 "
        f"{FORM_TOL[torch.float32][:3]} (lse relative):")
    t0 = time.perf_counter()
    for sfx in FORMS:
        worst = {}
        for d in SWEEP_DIMS:
            for causal, sq, sk in SWEEP_SHAPES:
                _, errs, _ = check_form(fa, sfx, 3, sq, sk, d, causal,
                                        sq + sk + d)
                for name, err in errs.items():
                    worst[name] = max(worst.get(name, 0.0), err)
        n = len(SWEEP_DIMS) * len(SWEEP_SHAPES)
        log(f"  flash{sfx or '_bf16'} ({FORMS[sfx][0]}, out "
            f"{FORMS[sfx][1] or 'same'}): {n} shapes, worst "
            f"{json.dumps(worst)}; repeats bit-identical")
    log(f"  sweep {time.perf_counter() - t0:.1f} s")
    rows = {}
    log("new forms timed at the flagship (B=8, H=6, S=2048, D=128, causal):")
    for sfx in NEW_FORMS:
        rows.update(time_form(fa, sfx, 8, 6, 2048, 128))
    log("each dtype's own form at D=256 (B=8, H=3, S=2048, causal):")
    for sfx in ("", "_f16", "_fp32"):
        time_form(fa, sfx, 8, 3, 2048, 256)
    return rows


WIDE_DIMS = (272, 320, 384, 512)
WIDE_TIMED = (8, 3, 2048, 512)    # B, H, S, D of the timed wide forms


def wide_forms_phase(fa):
    """Phase 3c: every form of K1-K3 at head dims above 256 (the _wide
    kernels, D zero-padded to a multiple of 128) against its plain
    version, causal and not, ragged, repeat-exact; then each operand
    dtype's own form timed at D=512. Returns those rows of the
    ``kernels`` line, named by the kernels' launch keys
    ``<kernel>_wide``."""
    log(f"flash forms vs plain at head dims {WIDE_DIMS} x (causal, sq, sk) "
        f"{SWEEP_SHAPES}, phase 3b's tolerances:")
    t0 = time.perf_counter()
    for sfx in FORMS:
        worst = {}
        for d in WIDE_DIMS:
            for causal, sq, sk in SWEEP_SHAPES:
                _, errs, _ = check_form(fa, sfx, 3, sq, sk, d, causal,
                                        sq + sk + d)
                for name, err in errs.items():
                    worst[name] = max(worst.get(name, 0.0), err)
        log(f"  flash{sfx or '_bf16'}: "
            f"{len(WIDE_DIMS) * len(SWEEP_SHAPES)} shapes, worst "
            f"{json.dumps(worst)}; repeats bit-identical")
    log(f"  sweep {time.perf_counter() - t0:.1f} s")
    b, h, s, d = WIDE_TIMED
    log(f"each dtype's own form at D={d} (B={b}, H={h}, S={s}, causal; "
        "SDPA's flash backend stops at 256, so library_ms is whichever "
        "backend PyTorch picks):")
    rows = {}
    for sfx in ("", "_f16", "_fp32"):
        rows.update({f"{name}_wide": row for name, row in
                     time_form(fa, sfx, b, h, s, d).items()})
    return rows


def dtype_lm_phase(hvd, tfm, fa, build_train_step, create_mesh, lm_step_s):
    """Phase 16: the flagship LM of phase 5 in fp16 and in fp32 through
    the automatic flash choice, then the fp16 tp/sp mesh step (ring
    attention's fp32-output blocks). Returns the launch counts."""
    b, s = 8, 2048
    tok = torch.randint(0, FLAGSHIP["vocab"], (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()
    launches = {}
    for dtype, sfx in ((torch.float16, "_f16"), (torch.float32, "_fp32")):
        kw = dict(FLAGSHIP, dtype=dtype)
        hvd.init()
        # Step 1's loss on plain attention, the same weights and tokens.
        ref = tfm.Transformer(tfm.TransformerConfig(use_flash=False, **kw),
                              generator=torch.Generator().manual_seed(0),
                              device="cuda")
        with torch.no_grad():
            ref_loss = float(ref.loss_fn(tokens, targets))
        del ref
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 2**30
        step = build_train_step(tfm.TransformerConfig(**kw), adamw)
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = step.make_optimizer(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, times = [], []
        for _ in range(DTYPE_STEPS):
            t0 = time.perf_counter()
            loss = step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30 - base
        steady = statistics.median(times[1:])
        rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        log(f"flagship LM in {dtype} (auto flash): losses {losses}; step "
            f"seconds {times}; {b * s / steady:.1f} tok/s (median of steps "
            f"2-{DTYPE_STEPS}, {steady * 1e3:.2f} ms/step) beside phase "
            f"5's bf16 {b * s / lm_step_s:.1f}; peak memory {peak:.2f} GiB "
            f"above the {base:.2f} GiB held before the model; "
            f"step 1 loss {losses[0]!r} against use_flash=False "
            f"{ref_loss!r}: rel {rel:.3e} (tolerance "
            f"{DTYPE_LOSS_TOL[dtype]}); launches {counts}")
        want = {n: 0 for n in counts}
        want.update({n: FLAGSHIP["n_layers"] * DTYPE_STEPS
                     for n in form_names(sfx)})
        if counts != want:
            raise AssertionError(f"{dtype} LM launches {counts}, expected "
                                 f"{want}")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"{dtype} LM losses not finite and "
                                 f"falling: {losses}")
        if not rel <= DTYPE_LOSS_TOL[dtype]:
            raise AssertionError(f"{dtype} LM step 1 loss {losses[0]} "
                                 f"against plain attention's {ref_loss}: "
                                 f"{rel} > {DTYPE_LOSS_TOL[dtype]}")
        launches.update({n: counts[n] for n in form_names(sfx)})
        del step, model, opt
        hvd.shutdown()
        torch.cuda.empty_cache()

    hvd.init()
    mesh = create_mesh(dp=1, tp=1, sp=1)
    cfg = tfm.TransformerConfig(tp_axis="tp", sp_axis="sp",
                                **dict(FLAGSHIP, dtype=torch.float16))
    step = build_train_step(cfg, adamw, mesh=mesh)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    fa.reset_launch_counts()
    losses = [float(step(model, opt, tokens, targets)) for _ in range(2)]
    counts = fa.launch_counts()
    log(f"fp16 tp/sp mesh step (ring, fp32 blocks): losses {losses}; "
        f"launches {counts}")
    want = {n: 0 for n in counts}
    want.update({n: 2 * cfg.n_layers for n in form_names("_f16_f32")})
    if counts != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fp16 ring: losses {losses}, launches "
                             f"{counts}, expected {want}")
    launches.update({n: counts[n] for n in form_names("_f16_f32")})
    del step, model, opt
    hvd.shutdown()
    torch.cuda.empty_cache()
    return launches


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def stall_probe(hvd):
    """A request placed in the engine's table of announced ops and never
    planned, with a 1 s warning time: the engine's own cycle must warn
    about it within a few seconds."""
    from horovod_tpu_torch.ops import collective as coll
    eng = coll.engine()
    rec = _Records()
    logger = logging.getLogger("horovod_tpu_torch.ops.collective")
    logger.addHandler(rec)
    req = coll._Request(coll.Meta("stall.probe", coll.ALLREDUCE, "float32",
                                  (3,)),
                        torch.ones(3, device=hvd.device()),
                        coll.Handle("stall.probe", eng._cv), None)
    old = eng.stall_warning_s
    t0 = time.perf_counter()
    try:
        eng.stall_warning_s = STALL_WARNING_S
        with eng._lock:
            eng._announced["stall.probe"] = req
        while time.perf_counter() - t0 < 4 * STALL_WARNING_S and not any(
                "stall.probe" in m for m in rec.messages):
            time.sleep(0.05)
    finally:
        with eng._lock:
            eng._announced.pop("stall.probe", None)
        eng.stall_warning_s = old
        logger.removeHandler(rec)
    hits = [m for m in rec.messages if "stall.probe" in m]
    if not hits:
        raise AssertionError("the stall inspector did not warn about a "
                             "request stalled past its warning time")
    log(f"  stall probe: warned after {time.perf_counter() - t0:.2f} s: "
        + hits[0].splitlines()[-1])


def engine_remainder_phase(hvd, tfm, fa, fbn, build_train_step, lm_losses,
                           lm_step_s):
    """Phase 17: phase 5's dp step with HOROVOD_TPU_HIERARCHICAL_ALLREDUCE
    and HOROVOD_TPU_TIMELINE set (at one card the hierarchy is the
    identity: its losses must be phase 5's bit for bit); the timeline
    must be catapult JSON with a NEGOTIATE_ALLREDUCE and an
    NCCL_ALLREDUCE span for each bucket in every step; and the stall
    probe."""
    import os
    import tempfile
    from horovod_tpu_torch.ops import collective as coll
    from horovod_tpu_torch.ops.control_plane import (
        FLAG_HIERARCHICAL_ALLREDUCE)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "timeline.json")
        env = {"HOROVOD_TPU_HIERARCHICAL_ALLREDUCE": "1",
               "HOROVOD_TPU_TIMELINE": path}
        os.environ.update(env)
        try:
            hvd.init()
            if not coll.engine()._coord.flags & FLAG_HIERARCHICAL_ALLREDUCE:
                raise AssertionError("the plan does not carry the "
                                     "hierarchical allreduce")
            log("phase 5's dp step, hierarchical allreduce and timeline on:")
            _, steady, losses = lm_main_path(hvd, tfm, fa, fbn,
                                             build_train_step, None)
            stall_probe(hvd)
        finally:
            hvd.shutdown()
            for k in env:
                os.environ.pop(k, None)
        with open(path) as f:
            events = json.load(f)
        size = os.path.getsize(path)
    if losses != lm_losses:
        raise AssertionError(f"hierarchical losses {losses} are not phase "
                             f"5's {lm_losses}")
    pids = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            key = (pids[e["pid"]], e["name"])
            spans[key] = spans.get(key, 0) + 1
    # Every allreduce (the gradient buckets, and the step's loss) has
    # both spans once a step.
    reduced = sorted({t for t, n in spans if n == "NCCL_ALLREDUCE"})
    for t in reduced:
        for n in ("NEGOTIATE_ALLREDUCE", "NCCL_ALLREDUCE"):
            if spans.get((t, n), 0) != STEPS:
                raise AssertionError(f"timeline: {n} of {t} "
                                     f"{spans.get((t, n))} times in {STEPS} "
                                     "steps")
    buckets = [t for t in reduced if ".bucket." in t]
    if len(buckets) != LM_BUCKETS:
        raise AssertionError(f"timeline: NCCL_ALLREDUCE spans of "
                             f"{reduced}, expected {LM_BUCKETS} buckets")
    log(f"  losses bit for bit phase 5's; {len(events)} timeline events "
        f"({size} bytes), NEGOTIATE_ALLREDUCE and NCCL_ALLREDUCE {STEPS} "
        f"times each for {reduced}; {8 * 2048 / steady:.1f} tok/s beside "
        f"phase 5's {8 * 2048 / lm_step_s:.1f} (the timeline's cost)")


def base_of(name):
    """A row's kernel form: ``flash_fwd_f16_wide`` (phase 3c's kernel
    above head dim 256) is ``flash_fwd_f16``."""
    return name.removesuffix("_wide")


# ---------------------------------------------------------------------------
# Phases 18 and 19: the conv zoo through the input pipeline, the small
# models and sync BN.
# ---------------------------------------------------------------------------

ZOO = (("VGG16", 224), ("InceptionV3", 299))   # (model, image size)
ZOO_BATCH = 32          # examples/jax_synthetic_benchmark.py's default
MNIST_STEPS, MNIST_BATCH = 20, 64
W2V = dict(vocab=5000, dim=128, batch=256, negatives=64, steps=20)
SYNC_BN_STEPS = 3


def zoo_macs(model, image):
    """Conv and dense multiply-adds of one image through ``model``, from
    one eval-mode forward (no kernel of the port runs)."""
    from horovod_tpu_torch.models.layers import Conv
    macs = [0]

    def on_conv(mod, args, out):
        macs[0] += out.numel() * mod.weight[0].numel()

    def on_dense(mod, args, out):
        macs[0] += mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(on_conv) for m in model.modules()
             if isinstance(m, Conv)]
    hooks += [m.register_forward_hook(on_dense) for m in model.modules()
              if isinstance(m, torch.nn.Linear)]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=model.device))
    model.train()
    for h in hooks:
        h.remove()
    return macs[0]


def pipeline_steps(step, model, opt, it, n):
    """``n`` steps on batches from the prefetcher ``it``: (losses, step
    seconds, host ms each step waited for its batch)."""
    losses, times, waits = [], [], []
    for _ in range(n):
        w0 = it.waited_s
        t0 = time.perf_counter()
        images, labels = next(it).data
        waits.append((it.waited_s - w0) * 1e3)
        loss = step(model, opt, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    return losses, times, waits


def zoo_main_path(hvd, data, zoo, fa, fbn, build_image_train_step, profile):
    """Phase 18: VGG16 and InceptionV3 at full width and depth, bf16,
    ImageNet shapes, ``synthetic("image", seed=1234)`` ->
    ``build_loader(batch_size=32, seed=0)`` -> ``prefetch_to_device(
    depth=2)`` -> ``DistributedOptimizer(SGD(0.01 n, momentum 0.9))``, 5
    steps each. The dataset holds one batch, so every step is an epoch of
    the same 32 images (reshuffled): at 1000 classes 5 steps on new
    images would show no falling loss, as phase 8 repeats its batch. The
    synthetic batch is materialised once into an ``ArraySource``: drawn
    anew each step on the prefetcher's one host thread (numpy's RNG, 2-4
    ms an image) it would bound the step, and img/s would measure the
    source. Its own rate is logged apart."""
    import numpy as np
    for name, image in ZOO:
        src = data.synthetic("image", n=ZOO_BATCH, image_size=image,
                             num_classes=1000, seed=1234)
        t0 = time.perf_counter()
        cached = data.ArraySource(*src.take(np.arange(ZOO_BATCH)))
        src_s = time.perf_counter() - t0
        log(f"{name}: the synthetic source draws a {ZOO_BATCH} x {image}^2 "
            f"batch in {src_s * 1e3:.1f} ms on one host thread (alone it "
            f"would bound the step at {ZOO_BATCH / src_s:.1f} img/s)")
        loader = data.build_loader(cached, batch_size=ZOO_BATCH, seed=0)
        step = build_image_train_step(
            functools.partial(getattr(zoo, name), num_classes=1000),
            lambda p: torch.optim.SGD(p, lr=0.01 * hvd.size(),
                                      momentum=0.9))
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        flops = 3 * 2 * zoo_macs(model, image) * ZOO_BATCH
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = step.make_optimizer(model)
        sync_ms, fires = [], []
        timed_synchronize(opt, sync_ms, fires)
        it = data.prefetch_to_device(loader, depth=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        fbn.reset_launch_counts()
        losses, times, waits = pipeline_steps(step, model, opt, it, STEPS)
        steady = statistics.median(times[1:])
        log(f"{name} main path ({n_params} params, bf16, {ZOO_BATCH} x "
            f"{image}^2 through build_loader -> prefetch_to_device): losses "
            f"{losses}")
        log(f"  step seconds {times}; host ms waiting for the batch "
            f"{[round(w, 3) for w in waits]} (prefetcher h2d "
            f"{it.h2d_s * 1e3 / STEPS:.3f} ms/batch)")
        log(f"  {ZOO_BATCH / steady:.1f} img/s (median of steps 2-{STEPS}, "
            f"{steady * 1e3:.2f} ms/step); model FLOPs (conv + dense, "
            f"2*MAC x 3) {flops / 1e12:.3f} TFLOP/step: "
            f"{flops / steady / 1e12:.1f} TFLOP/s, "
            f"{flops / steady / PEAK_BF16_FLOPS:.2%} of the bf16 peak; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB")
        log("  gradient sync: " + bucket_line(opt, sync_ms, fires))
        n_buckets = len(opt._buckets)
        if n_buckets < 1 or any(f != (n_buckets, 0) for f in fires):
            raise AssertionError(f"{name}: buckets did not all fire from "
                                 f"their hooks: {fires}")
        if sum(fa.launch_counts().values()) or sum(
                fbn.launch_counts().values()):
            raise AssertionError(f"{name} launched a flash or BN kernel")
        if profile:
            profile_steps(lambda: step(model, opt, *next(it).data), profile,
                          f"{name} train step through prefetch_to_device")
        it.close()
        del step, model, opt, it
        torch.cuda.empty_cache()


def synthetic_mnist(n=4096, num_classes=10, seed=1234):
    """``examples/_data.py``'s learnable MNIST stand-in: (images [n, 28,
    28, 1] in [0, 1], labels [n])."""
    import numpy as np
    rng = np.random.RandomState(seed)
    protos = rng.rand(num_classes, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    images = protos[labels] + 0.3 * rng.randn(n, 28, 28, 1).astype(
        np.float32)
    return np.clip(images, 0.0, 1.0), labels


def text8_like_tokens(n=100_000, vocab=5000, seed=7):
    """``examples/_data.py``'s Zipf token stream (the word2vec corpus
    stand-in)."""
    import numpy as np
    tokens = np.random.RandomState(seed).zipf(1.3, size=n).astype(np.int64)
    return np.clip(tokens, 0, vocab - 1).astype(np.int32)


def mnist_steps(hvd, data, zoo, build_image_train_step):
    step = build_image_train_step(
        zoo.MnistConvNet, lambda p: torch.optim.SGD(
            p, lr=0.01 * hvd.size(), momentum=0.9))
    model = step.make_model(generator=torch.Generator().manual_seed(42))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    loader = data.build_loader(synthetic_mnist(), batch_size=MNIST_BATCH,
                               seed=0)
    it = data.prefetch_to_device(loader, depth=2)
    losses, times, waits = pipeline_steps(step, model, opt, it, MNIST_STEPS)
    it.close()
    log(f"MnistConvNet: {MNIST_STEPS} steps at batch {MNIST_BATCH} through "
        f"the loader, losses {[round(x, 4) for x in losses]}; "
        f"{MNIST_BATCH / statistics.median(times[1:]):.1f} img/s (median); "
        f"host ms waiting per step median "
        f"{statistics.median(waits):.3f}")


def word2vec_steps(hvd):
    from horovod_tpu_torch.models import word2vec as w2v
    p = W2V
    dev = hvd.device()
    tokens = torch.from_numpy(text8_like_tokens(vocab=p["vocab"])).to(dev)
    params = w2v.init_params(p["vocab"], p["dim"],
                             torch.Generator().manual_seed(0), device=dev)
    named = list(zip(w2v.Word2VecParams._fields, params))
    hvd.broadcast_parameters(dict(named), root_rank=0)
    # optax.adagrad(1.0)'s accumulator start and eps, as the JAX example.
    opt = hvd.DistributedOptimizer(
        torch.optim.Adagrad(params, lr=1.0, initial_accumulator_value=0.1,
                            eps=1e-7), named_parameters=named)
    gen = torch.Generator(device=dev)
    losses, times = [], []
    for i in range(p["steps"]):
        t0 = time.perf_counter()
        gen.manual_seed(i)
        centers, contexts = w2v.skipgram_batch(
            tokens, i * hvd.size() + hvd.rank(), p["batch"])
        opt.zero_grad()
        loss = w2v.nce_loss(params, centers.long(), contexts.long(), gen,
                            p["negatives"])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t0)
    near = w2v.nearest(params, torch.arange(4, device=dev), k=5)
    log(f"word2vec: {p['steps']} NCE steps (vocab {p['vocab']}, dim "
        f"{p['dim']}, batch {p['batch']}, {p['negatives']} negatives, "
        f"Adagrad 1.0), losses {[round(x, 3) for x in losses]}; step ms "
        f"median {statistics.median(times[1:]) * 1e3:.3f}; nearest(0..3, "
        f"k=5) {near.tolist()}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"word2vec losses not finite and falling: "
                             f"{losses}")
    if tuple(near.shape) != (4, 5) or not bool(
            ((near >= 0) & (near < p["vocab"])).all()):
        raise AssertionError(f"nearest returned invalid ids {near}")


def sync_bn_steps(hvd, tres, create_mesh, build_image_train_step,
                  flax_loss1):
    """ResNet-50 with every BN a SyncBatchNorm over 'dp' of a world-1
    mesh: SYNC_BN_STEPS steps at phase 8's batch, images and weights."""
    from horovod_tpu_torch.data import sync_bn
    mesh = create_mesh(dp=hvd.size())
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                         generator=gen, device=dev)
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                           device=dev)
    step = build_image_train_step(
        functools.partial(tres.ResNet50, num_classes=1000,
                          bn_axis_name="dp", mesh=mesh),
        lambda p: torch.optim.SGD(p, lr=0.01 * hvd.size(), momentum=0.9))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    n_bn = sum(isinstance(m, sync_bn.SyncBatchNorm) for m in model.modules())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    losses, counts, times = [], [], []
    for _ in range(SYNC_BN_STEPS):
        sync_bn.reset_allreduce_count()
        t0 = time.perf_counter()
        losses.append(float(step(model, opt, images, labels)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(sync_bn.allreduce_count())
    rel = abs(losses[0] - flax_loss1) / abs(flax_loss1)
    log(f"ResNet-50 with sync BN (bn_axis_name='dp', world {hvd.size()}): "
        f"{n_bn} SyncBatchNorm layers, losses {losses}; step seconds "
        f"{times}; [2C] statistics all-reduces per step {counts}; step 1 "
        f"loss {losses[0]!r} beside phase 8's bn_impl='flax' "
        f"{flax_loss1!r} (rel {rel:.3e}: no variance clamp, another "
        "order of the normalising product)")
    if n_bn != 53 or counts != [n_bn] * SYNC_BN_STEPS:
        raise AssertionError(f"{n_bn} SyncBatchNorm layers made {counts} "
                             "statistics all-reduces per step, expected one "
                             "each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"sync-BN ResNet losses {losses}")


def small_models_phase(hvd, data, zoo, tres, fa, fbn, create_mesh,
                       build_image_train_step, flax_loss1):
    """Phase 19: the MNIST net and word2vec through the engine, and
    ResNet-50 with sync BN; no hand-written kernel runs."""
    fa.reset_launch_counts()
    fbn.reset_launch_counts()
    mnist_steps(hvd, data, zoo, build_image_train_step)
    word2vec_steps(hvd)
    sync_bn_steps(hvd, tres, create_mesh, build_image_train_step,
                  flax_loss1)
    if sum(fa.launch_counts().values()) or sum(
            fbn.launch_counts().values()):
        raise AssertionError("phase 19 launched a flash or BN kernel")
    torch.cuda.empty_cache()


ELASTIC_STEPS = 4       # phase 20: commit after step 2, replay 3-4
ELASTIC_COMMIT = 2


def elastic_steps(step, model, opt, it, n):
    """``n`` flagship steps on batches of ``it`` (a prefetcher of [8,
    2049] token rows): their losses."""
    losses = []
    for _ in range(n):
        (tok,) = next(it).data
        tok = tok.long()
        losses.append(float(step(model, opt, tok[:, :-1], tok[:, 1:])))
    return losses


def moments_of(opt):
    return [{k: v.clone() for k, v in st.items()}
            for st in opt.state.values()]


def elastic_phase(hvd, tfm, fa, data, build_train_step, smi):
    """Phase 20: the flagship of phase 5 fed by ``build_loader(synthetic(
    "tokens"))`` -> ``prefetch_to_device``, committed through
    ``ElasticState(backend="sharded")`` after step 2 (model, AdamW and
    the consumed cursor), steps 3-4 taken while the writer runs; a fresh
    model and optimizer from another seed and a fresh loader restored,
    and steps 3-4 replayed bit for bit (losses, every parameter and
    moment), K1-K3 launched 12 times a step in the replay; then a second
    commit with one shard corrupted: ``restore()`` falls back to the
    first commit and ``strict=True`` raises ``CorruptShardError``."""
    import os
    import shutil
    import tempfile
    from horovod_tpu_torch.checkpoint import (CheckpointEngine,
                                              CorruptShardError,
                                              read_manifest)
    from horovod_tpu_torch.elastic import ElasticState
    hvd.init()
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                d_ff=3072, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    step = build_train_step(cfg, adamw)
    src = data.synthetic("tokens", n=64, vocab=32000, seq_len=2049, seed=7)

    def loader():
        return data.build_loader(src, batch_size=8, seed=0)

    tmp = tempfile.mkdtemp(prefix="hvd_elastic_")
    try:
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        it = data.prefetch_to_device(loader(), depth=2)
        losses = elastic_steps(step, model, opt, it, ELASTIC_COMMIT)
        at_commit = {k: v.clone() for k, v in model.state_dict().items()}
        state = ElasticState(directory=tmp, backend="sharded", model=model,
                             optimizer=opt, data=it.commit_cursor())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.commit(ELASTIC_COMMIT)
        blocked_ms = (time.perf_counter() - t0) * 1e3
        busy = state.engine.busy
        engine_ms = state.engine.blocked_s * 1e3
        losses += elastic_steps(step, model, opt, it,
                                ELASTIC_STEPS - ELASTIC_COMMIT)
        state.wait()
        it.close()
        save_s = state.engine.save_s
        want_params = {k: v.clone() for k, v in model.state_dict().items()}
        want_moments = moments_of(opt)
        n_params = sum(p.numel() for p in model.parameters())
        man = read_manifest(tmp, ELASTIC_COMMIT)
        nbytes = sum(s["nbytes"] for e in man["leaves"] for s in e["shards"])
        del model, opt, state
        torch.cuda.empty_cache()

        model = step.make_model(generator=torch.Generator().manual_seed(1))
        opt = step.make_optimizer(model)
        fresh = loader()
        state = ElasticState(directory=tmp, backend="sharded", model=model,
                             optimizer=opt, data=fresh.cursor())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        fresh.restore(state.data)
        if state.step != ELASTIC_COMMIT or fresh.offset != ELASTIC_COMMIT:
            raise AssertionError(f"restored step {state.step}, loader "
                                 f"offset {fresh.offset}; expected "
                                 f"{ELASTIC_COMMIT}")
        it = data.prefetch_to_device(fresh, depth=2)
        fa.reset_launch_counts()
        replay = elastic_steps(step, model, opt, it,
                               ELASTIC_STEPS - ELASTIC_COMMIT)
        torch.cuda.synchronize()
        launches = fa.launch_counts()
        it.close()
        log(f"elastic resume (phase 20): losses {losses}; replayed steps "
            f"{ELASTIC_COMMIT + 1}-{ELASTIC_STEPS} {replay}; launches "
            f"{launches}")
        if replay != losses[ELASTIC_COMMIT:]:
            raise AssertionError(f"replayed losses {replay} are not "
                                 f"{losses[ELASTIC_COMMIT:]}")
        bad = [k for k, v in model.state_dict().items()
               if not torch.equal(v, want_params[k])]
        got_moments = moments_of(opt)
        bad += [f"moment {i}.{k}" for i, (g, w) in
                enumerate(zip(got_moments, want_moments))
                for k in w if not torch.equal(g[k], w[k])]
        if bad or len(got_moments) != len(want_moments):
            raise AssertionError(f"after the replay {len(bad)} tensors "
                                 f"differ, first {bad[:1]}")
        want = (ELASTIC_STEPS - ELASTIC_COMMIT) * cfg.n_layers
        for name in BF16_FLASH:
            if launches[name] != want:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times in the replay, expected {want}")

        # A second commit, one shard of it corrupted: the fallback.
        state.commit(ELASTIC_STEPS, block=True)
        sdir = os.path.join(tmp, f"step-{ELASTIC_STEPS}")
        victim = max((f for f in os.listdir(sdir) if f.endswith(".npy")),
                     key=lambda f: os.path.getsize(os.path.join(sdir, f)))
        with open(os.path.join(sdir, victim), "r+b") as f:
            f.seek(os.path.getsize(os.path.join(sdir, victim)) // 2)
            f.write(b"\x13\x37\x13\x37")
        rec = _Records()
        logger = logging.getLogger("horovod_tpu_torch.checkpoint.engine")
        logger.addHandler(rec)
        try:
            state.restore()
        finally:
            logger.removeHandler(rec)
        if state.step != ELASTIC_COMMIT or not any(
                "falling back" in m for m in rec.messages):
            raise AssertionError(f"no logged fallback: step {state.step}, "
                                 f"log {rec.messages}")
        bad = [k for k, v in model.state_dict().items()
               if not torch.equal(v, at_commit[k])]
        if bad:
            raise AssertionError(f"the fallback restored {len(bad)} "
                                 f"parameters other than step "
                                 f"{ELASTIC_COMMIT}'s, first {bad[0]}")
        try:
            CheckpointEngine(tmp).restore(strict=True)
        except CorruptShardError as e:
            strict = e.reason
        else:
            raise AssertionError("strict restore of the corrupt commit did "
                                 "not raise CorruptShardError")
        log(f"  fallback: {rec.messages[0]}; strict=True raised "
            f"CorruptShardError ({strict})")
        reckoned = n_params * 4 + 2 * n_params * 4
        log(f"  commit on {smi}: {nbytes} bytes in "
            f"{sum(len(e['shards']) for e in man['leaves'])} shard files "
            f"({len(man['leaves'])} leaves; reckoned {n_params} fp32 "
            f"parameters {n_params * 4 / 1e9:.3f} GB + AdamW moments "
            f"{2 * n_params * 4 / 1e9:.3f} GB = {reckoned / 1e9:.3f} GB); "
            f"commit blocked the loop {blocked_ms:.1f} ms (writer busy "
            f"after: {busy}; the engine's share {engine_ms:.1f} ms, the "
            f"rest the elastic state's host snapshot); durable in "
            f"{save_s:.2f} s "
            f"({nbytes / save_s / 1e9:.3f} GB/s); restore "
            f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.3f} GB/s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        hvd.shutdown()


# ------------------------------------------------ phase 21: serving

SERVE_LENS = (32, 128, 256, 512, 768, 1024, 1536, 1984)
SERVE_NEW = 64
SERVE_SLOTS, SERVE_BLOCK, SERVE_KV_BLOCKS = 8, 16, 1025
SERVE_TOL = 3e-2        # logits against the full forward, of max |logit|
SERVE_TIMEOUT_S = 300   # the server's start, each request, its drain
SERVE_PROFILED_STEPS = 20


def serve_prompts(vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in SERVE_LENS]


def serve_post(port, body):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_TIMEOUT_S)
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise AssertionError(f"/generate answered {resp.status}: {data!r}")
    if body.get("stream"):
        lines = [json.loads(x) for x in data.splitlines() if x.strip()]
        if not lines[-1].get("done") or lines[-1]["status"] != "completed":
            raise AssertionError(f"stream ended with {lines[-1]}")
        return [x["t"] for x in lines[1:-1]]
    return json.loads(data)


def http_serve(ckpt, prompts, extra_args=(),
               launcher=("horovod_tpu_torch.serving",)):
    """Start ``python -m horovod_tpu_torch.serving`` on the commit (or
    through ``launcher``: the runner's ``--serve --``), send the prompts
    at once from one client thread each, then a streamed copy of the
    first; SIGTERM, and the server must drain and exit 0. Returns the
    replies and the streamed tokens."""
    import queue
    import signal
    import subprocess
    import threading
    cmd = [sys.executable, "-m", *launcher,
           "--checkpoint-dir", ckpt, "--framework", "torch", "--port", "0",
           "--host", "127.0.0.1", "--slots", str(SERVE_SLOTS),
           "--block-size", str(SERVE_BLOCK), "--kv-blocks",
           str(SERVE_KV_BLOCKS), "--max-new-tokens", str(SERVE_NEW),
           *extra_args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        try:
            ready = lines.get(timeout=SERVE_TIMEOUT_S)
        except queue.Empty:
            raise AssertionError("the server printed no ready line") from None
        if "[serving] ready on :" not in ready:
            raise AssertionError(f"no ready line: {ready!r} "
                                 f"{proc.stderr.read()[-2000:]}")
        port = int(ready.split("ready on :")[1].split()[0])
        start_s = time.perf_counter() - t0
        replies = [None] * len(prompts)
        errors = []

        def client(i):
            try:
                replies[i] = serve_post(port, {"tokens": prompts[i]})
            except Exception as e:   # re-raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t1
        if errors or any(r is None for r in replies):
            raise AssertionError(f"HTTP clients failed: {errors}")
        streamed = serve_post(port, {"tokens": prompts[0], "stream": True})
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_TIMEOUT_S)
        if rc != 0:
            raise AssertionError(f"the server exited {rc} after SIGTERM: "
                                 f"{proc.stderr.read()[-2000:]}")
        return replies, streamed, start_s, wall
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


class _Captured:
    """Wraps an engine's forwards: keeps each request's prefill row (its
    last prompt position) and its decode logits for the 64th token, and
    the seconds of every batched decode step (the step ends in a host
    copy of the logits, so the host clock covers the device's work)."""

    def __init__(self, eng):
        self.prefill, self.last, self.step_s = {}, {}, []
        self.peak_blocks = 0
        fwd_prefill, fwd, decode = eng._fwd_prefill, eng._fwd, \
            eng._decode_step

        def on_prefill(toks, starts, tabs):
            logits = fwd_prefill(toks, starts, tabs)
            slot = next(i for i, r in enumerate(eng._reqs) if r is not None
                        and np.array_equal(eng._tables[i], tabs[0]))
            req = eng._reqs[slot]
            ns = len(req.prompt) - int(starts[0])
            self.prefill[req.id] = logits[0, ns - 1].float().cpu()
            return logits

        def on_decode(toks, lens, tabs):
            logits = fwd(toks, lens, tabs)
            for i, r in enumerate(eng._reqs):
                if r is not None and r.prefill_pos is None \
                        and len(r.tokens) == r.max_new_tokens - 1:
                    self.last[r.id] = logits[i, -1].float().cpu()
            return logits

        def on_step():
            t0 = time.perf_counter()
            decode()
            self.step_s.append(time.perf_counter() - t0)
            self.peak_blocks = max(self.peak_blocks, eng._alloc.in_use)

        eng._fwd_prefill, eng._fwd, eng._decode_step = \
            on_prefill, on_decode, on_step


def serve_engine(model, prompts, drafter=None, wrap=False, submit=None,
                 **over):
    """An in-process engine of phase 21's configuration on the model's
    device: the prompts submitted at once and run to the end (or as
    ``submit(engine)`` drives them). Returns (tokens, requests, seconds,
    the capture or None)."""
    import gc
    from horovod_tpu_torch.serving import InferenceEngine, ServingConfig
    cfg = ServingConfig(**dict(dict(
        block_size=SERVE_BLOCK, kv_blocks=SERVE_KV_BLOCKS,
        max_batch_slots=SERVE_SLOTS, max_new_tokens=SERVE_NEW,
        max_queue=32), **over))
    eng = InferenceEngine(model, cfg, drafter=drafter, device=model.device)
    cap = _Captured(eng) if wrap else None
    sync(model.device)
    t0 = time.perf_counter()
    if submit is not None:
        reqs = submit(eng)
    else:
        reqs = [eng.submit(p) for p in prompts]
        eng.run_until_idle()
    wall = time.perf_counter() - t0
    toks = [r.result(timeout=SERVE_TIMEOUT_S) for r in reqs]
    del eng
    gc.collect()
    empty_cache(model.device)
    return toks, reqs, wall, cap


def serve_divergence(model, prompts, got, want, what):
    """Token lists that should agree. At the first divergent position of
    each request, the full forward over the common prefix says how far
    apart the two chosen tokens' logits are (of max |logit|) and its own
    top-2 margin: above SERVE_TOL the divergence is a fault, below it a
    near-tie, logged as a finding."""
    findings = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        p = next(k for k in range(min(len(g), len(w))) if g[k] != w[k])
        with torch.inference_mode():
            row = model.apply(torch.tensor([prompts[i] + w[:p]],
                                           device=model.device))[0, -1]
        row = row.float()
        top = torch.topk(row, 2).values
        scale = float(row.abs().max())
        gap = abs(float(row[g[p]] - row[w[p]])) / scale
        margin = float(top[0] - top[1]) / scale
        findings.append((i, p, g[p], w[p], gap, margin))
        log(f"  {what}: request {i} (prompt {len(prompts[i])}) diverges at "
            f"generated token {p}: {g[p]} against {w[p]}; the full "
            f"forward's logits of the two differ by {gap:.3e} of max "
            f"|logit|, its top-2 margin {margin:.3e}")
        if gap > SERVE_TOL:
            raise AssertionError(f"{what}: request {i} diverges at token "
                                 f"{p} with a logit gap of {gap:.3e} of max "
                                 f"|logit| (> {SERVE_TOL})")
    return findings


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def serve_profile(model, prompts):
    """20 batched decode steps of 8 live slots under torch.profiler: the
    CUDA kernels and copies a step, the share of the window the device
    was busy (the union of their intervals over the wall), and the six
    largest by device time."""
    from torch.profiler import ProfilerActivity, profile
    from horovod_tpu_torch.serving import InferenceEngine, ServingConfig
    eng = InferenceEngine(model, ServingConfig(
        block_size=SERVE_BLOCK, kv_blocks=SERVE_KV_BLOCKS,
        max_batch_slots=SERVE_SLOTS, max_new_tokens=SERVE_NEW),
        device=model.device)
    for p in prompts:
        eng.submit(p)
    eng.step()   # admits and prefills all eight, one decode step
    eng.step()
    sync(model.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILED_STEPS):
            eng.step()
        sync(model.device)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    eng.run_until_idle()
    del eng
    empty_cache(model.device)
    if not spans:
        return None, None, wall, []
    by_kind = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = by_kind.get(e.name, (0, 0.0))
            by_kind[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_kind.items(), key=lambda kv: -kv[1][1])[:6]
    return (len(spans) / SERVE_PROFILED_STEPS, busy / 1e6 / wall, wall,
            [(name[:60], n // SERVE_PROFILED_STEPS,
              round(t / 1e3 / SERVE_PROFILED_STEPS, 4))
             for name, (n, t) in top])


def serving_phase(tfm, fa, fbn, smi, cfg=None, device="cuda", ckpt=None):
    """Phase 21: the flagship served on one card. The seed-0 bf16
    flagship is committed through ``checkpoint_hook`` with
    ``transformer_extra``; ``python -m horovod_tpu_torch.serving`` serves
    it (8 slots, 16-token blocks, 1025 blocks) to 8 concurrent HTTP
    clients and one streamed request, then drains on SIGTERM. In-process
    engines on the same loaded weights check (a) the HTTP tokens and the
    streamed ones, (b) batched against sequential, (c) the prefill row
    and the 64th token's logits against ``Transformer.apply`` (3e-2 of
    max |logit|; K1 runs there from S = 1024), (d) the int8 pool, (e)
    speculative decoding with the flagship as its drafter, (f) the
    prefix cache; (b), (e) and (f) divergences are judged by
    :func:`serve_divergence`. The serve path launches no hand-written
    kernel: every count is 0 across the in-process runs. ``cfg`` and
    ``device`` exist for a rehearsal on the CPU at a small width. With
    ``ckpt`` (a directory) the commit lands there and is kept, for phase
    22. Returns the in-process engine's tok/s at 8 concurrent requests
    and the HTTP tokens."""
    import shutil
    import tempfile
    import types
    from horovod_tpu_torch.checkpoint import CheckpointEngine, checkpoint_hook
    from horovod_tpu_torch.serving import (TORCH_MODEL_PREFIX,
                                           config_from_manifest,
                                           load_params, serving_config,
                                           transformer_extra)
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if cfg is None:
        cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                    d_ff=3072, max_seq=2048,
                                    dtype=torch.bfloat16, remat=False)
    prompts = serve_prompts(cfg.vocab)
    tmp = ckpt or tempfile.mkdtemp(prefix="hvd_serve_")
    try:
        trained = tfm.Transformer(
            cfg, generator=torch.Generator().manual_seed(0), device=dev)
        save = checkpoint_hook(tmp, model=types.SimpleNamespace(
            state_dict=trained.params_tree), every=1,
            extra=transformer_extra(cfg))
        save(0, block=True)
        del trained
        empty_cache(dev)
        replies, streamed, start_s, http_wall = http_serve(
            tmp, prompts, [] if on_card else ["--device", "cpu"])
        http_toks = [r["tokens"] for r in replies]

        man = CheckpointEngine(tmp).restore_manifest()
        scfg = serving_config(config_from_manifest(man))
        if scfg != cfg:
            raise AssertionError(f"the manifest gives {scfg}, not {cfg}")
        model = tfm.Transformer(scfg, device=dev, params=load_params(
            tmp, scfg, key_prefix=TORCH_MODEL_PREFIX, device=dev))
        fa.reset_launch_counts()
        fbn.reset_launch_counts()
        # A first pass of every shape (each prefill bucket, the decode
        # step) loads their kernels, so that (a)'s times are steady.
        serve_engine(model, prompts, max_new_tokens=2)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
        # (a) the in-process engine on the same weights
        toks, reqs, wall, cap = serve_engine(model, prompts, wrap=True)
        peak_mem = torch.cuda.max_memory_allocated() if on_card else 0
        if toks != http_toks:
            raise AssertionError("the HTTP tokens are not the in-process "
                                 "engine's")
        if streamed != http_toks[0]:
            raise AssertionError("the streamed tokens are not the unary "
                                 "reply's")
        if any(len(t) != SERVE_NEW for t in toks):
            raise AssertionError(f"lengths {[len(t) for t in toks]}")

        # (b) the same prompts one at a time through the 8-slot engine
        def one_at_a_time(eng):
            out = []
            for p in prompts:
                out.append(eng.submit(p))
                eng.run_until_idle()
            return out

        seq_toks, seq_reqs, seq_wall, _ = serve_engine(
            model, prompts, submit=one_at_a_time)
        # (d) the int8 pool
        q_toks, _, q_wall, _ = serve_engine(model, prompts,
                                            kv_quant="int8")
        if [t[0] for t in q_toks] != [t[0] for t in toks]:
            raise AssertionError("an int8 first token differs from the bf16 "
                                 "pool's: prefill is not exact")
        agree = sum(a == b for x, y in zip(q_toks, toks)
                    for a, b in zip(x, y))
        qb, bb = (tfm.kv_bytes_per_block(cfg, SERVE_BLOCK, "int8"),
                  tfm.kv_bytes_per_block(cfg, SERVE_BLOCK))
        if on_card and (qb, bb) != (304128, 589824):
            raise AssertionError(f"bytes per block {qb}, {bb}")
        # (e) speculative decoding, the flagship as its own drafter
        spec_toks, _, spec_wall, _ = serve_engine(model, prompts,
                                                  drafter=model,
                                                  spec_tokens=4)
        # (f) the prefix cache: 4 requests share a 512-token system prompt
        shared = [prompts[3] + p[:64] for p in prompts[:4]]

        def first_then_rest(eng):
            out = [eng.submit(shared[0])]
            eng.run_until_idle()
            out += [eng.submit(p) for p in shared[1:]]
            eng.run_until_idle()
            return out

        pc_toks, pc_reqs, _, _ = serve_engine(model, shared,
                                              prefix_cache=True,
                                              submit=first_then_rest)
        plain = serve_engine(model, shared)[0]
        # The serve runs end here: the divergence judgments and (c) run
        # the full forward, which launches K1 from S = 1024 on the card.
        serve_launches = {**fa.launch_counts(), **fbn.launch_counts()}
        if any(serve_launches.values()):
            raise AssertionError(f"the serve path launched {serve_launches}")
        hits = [r.cached_tokens for r in pc_reqs]
        if hits != [0] + [len(prompts[3])] * 3:
            raise AssertionError(f"prompt tokens from the cache {hits}; "
                                 f"expected 0, then {len(prompts[3])} each")
        solo = serve_divergence(model, prompts, toks, seq_toks,
                                "(b) batched against sequential")
        spec = serve_divergence(model, prompts, spec_toks, toks,
                                "(e) speculative against (a)")
        prefix = serve_divergence(model, shared, pc_toks, plain,
                                  "(f) prefix-cached against uncached")

        # (c) against the full forward (K1 from S = 1024 on the card)
        fa.reset_launch_counts()
        worst = [0.0, 0.0]
        with torch.inference_mode():
            for i, r in enumerate(reqs):
                seq = prompts[i] + toks[i][:SERVE_NEW - 1]
                full = model.apply(torch.tensor([seq], device=dev))[0]
                for k, (got, row) in enumerate((
                        (cap.prefill[r.id], len(prompts[i]) - 1),
                        (cap.last[r.id], len(seq) - 1))):
                    want = full[row].float().cpu()
                    err = float((got - want).abs().max() / want.abs().max())
                    worst[k] = max(worst[k], err)
                del full
        k1 = fa.launch_counts()["flash_fwd"]
        if max(worst) > SERVE_TOL:
            raise AssertionError(f"decode logits against the full forward: "
                                 f"{worst} of max |logit| (> {SERVE_TOL})")
        probe = torch.empty(0, device=dev)
        want_k1 = sum(tfm._use_flash(cfg, probe, len(p) + SERVE_NEW - 1)
                      for p in prompts) * cfg.n_layers
        if k1 != want_k1:
            raise AssertionError(f"K1 launched {k1} times in the reference "
                                 f"forward, expected {want_k1}")
        launches, busy, prof_wall, top = serve_profile(model, prompts)
        ttft_http = {len(p): r["ttft_ms"] for p, r in zip(prompts, replies)}
        ttft_proc = {len(p): round(r.ttft_s * 1e3, 3)
                     for p, r in zip(prompts, reqs)}
        ttft_alone = {len(p): round(r.ttft_s * 1e3, 3)
                      for p, r in zip(prompts, seq_reqs)}
        step_ms = statistics.median(cap.step_s) * 1e3
        n_tok = SERVE_SLOTS * SERVE_NEW
        log(f"serving (phase 21) on {smi}: the seed-0 {cfg.dtype} flagship "
            f"(d_model {cfg.d_model}, {cfg.n_layers} layers) served by "
            f"python -m horovod_tpu_torch.serving, {SERVE_SLOTS} slots, "
            f"pool {SERVE_KV_BLOCKS} blocks of {SERVE_BLOCK} tokens = "
            f"{SERVE_KV_BLOCKS * bb / 1e6:.1f} MB; server ready in "
            f"{start_s:.2f} s, 8 HTTP requests in {http_wall:.3f} s; "
            "SIGTERM drained, exit 0")
        log(f"  TTFT ms by prompt length: HTTP (the server's first "
            f"forwards) {ttft_http}; in process, 8 at once {ttft_proc}; "
            f"one at a time {ttft_alone}")
        log(f"  decode step at 8 slots: median {step_ms:.3f} ms over "
            f"{len(cap.step_s)} steps; {n_tok} tokens generated in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tok/s; sequential "
            f"{seq_wall:.3f} s = {n_tok / seq_wall:.1f} tok/s (batched "
            f"{seq_wall / wall:.2f}x); int8 pool {n_tok / q_wall:.1f} "
            f"tok/s; speculative (k=4, self-drafter) "
            f"{n_tok / spec_wall:.1f} tok/s")
        log(f"  {SERVE_PROFILED_STEPS} profiled decode steps: "
            f"{'not measured' if launches is None else f'{launches:.1f}'} "
            f"CUDA kernels and copies a step; device busy "
            f"{'not measured' if busy is None else f'{busy:.3f}'} of "
            f"{prof_wall * 1e3 / SERVE_PROFILED_STEPS:.3f} ms a step; the "
            f"largest by device time (name, launches, ms a step): {top}")
        if on_card:
            log(f"  peak memory {peak_mem / 1e9:.3f} GB ({base_mem / 1e9:.3f}"
                f" GB before the engine); KV resident at the peak "
                f"{cap.peak_blocks} blocks = "
                f"{cap.peak_blocks * bb / 1e6:.1f} MB")
        log(f"  (c) prefill rows within {worst[0]:.3e}, 64th-token rows "
            f"within {worst[1]:.3e} of max |logit| of Transformer.apply; "
            f"K1 launched {k1} times there (the reference forward); the "
            f"serve path launched {sum(serve_launches.values())} "
            "hand-written kernels")
        log(f"  (d) int8: first tokens equal; {agree}/{n_tok} tokens agree "
            f"with the bf16 pool; {qb} bytes a block against {bb} "
            f"({bb / qb:.2f}x)")
        log(f"  (b) {'identical' if not solo else solo}; (e) "
            f"{'identical' if not spec else spec}; (f) prompt tokens from "
            f"the cache {hits}, {'identical' if not prefix else prefix}")
        log(f"  phase 21: {time.perf_counter() - t_phase:.1f} s")
        return n_tok / wall, http_toks
    finally:
        if ckpt is None:
            shutil.rmtree(tmp, ignore_errors=True)
        empty_cache(dev)


# ------------------------------------------------ phase 22: the fleet

FLEET_REPLICAS = 2
FLEET_RATE, FLEET_DURATION_S, FLEET_SEED = 3.0, 20.0, 0
FLEET_PROMPT = (32, 1024)
# Replica 1's first incarnation crashes at this decode tick, about a
# quarter into the load: two replicas sharing the card and its host
# step ~30 times a second each (tick 300 fell 10-11 s in on an H100).
FLEET_CRASH_TICK = 150
FLEET_TIMEOUT_S = 300


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get_json(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=FLEET_TIMEOUT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def smi_query(*args):
    """Rows of ``nvidia-smi *args --format=csv,noheader,nounits``, each a
    list of fields; [] without nvidia-smi."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", *args, "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [[x.strip() for x in line.split(",")]
            for line in out.splitlines() if line.strip()]


def card_memory():
    """({pid: MiB} of the processes ``nvidia-smi --query-compute-apps``
    lists, the card's used MiB); ({}, None) without nvidia-smi."""
    apps = {int(r[0]): int(r[1]) for r in smi_query(
        "--query-compute-apps=pid,used_memory")
        if len(r) == 2 and r[0].isdigit() and r[1].isdigit()}
    used = [int(r[0]) for r in smi_query("--query-gpu=memory.used")
            if r and r[0].isdigit()]
    return apps, (used[0] if used else None)


def read_dump(path):
    rows = [json.loads(x) for x in open(path).read().splitlines()
            if x.strip()]
    return rows[0], rows[1:]


def fleet_values(port, family):
    status, snap = get_json(port, f"/metrics.json?prefix={family}")
    if status != 200:
        raise AssertionError(f"the supervisor's /metrics.json answered "
                             f"{status}")
    return snap.get(family, {"values": {}})["values"]


def fleet_phase(tfm, smi, ckpt, one_replica_tok_s, device="cuda", bb=None):
    """Phase 22: the fleet on the card, driven through its CLI.
    ``python -m horovod_tpu_torch.serving --fleet 2`` serves phase 21's
    commit (each replica phase 21's engine: 8 slots, 16-token blocks,
    1025 blocks, 64 new tokens) behind the failover router; replica 1's
    first incarnation is set to crash at decode tick
    ``FLEET_CRASH_TICK``. The port's loadgen drives it open-loop:
    Poisson at 3 requests a second for 20 s, seed 0, prompts of 32-1024
    tokens, greedy. It fails on any failed request; on a token that
    differs from an in-process engine on the same weights, unless the
    full forward's logits of the two tokens lie within 3e-2 of max
    |logit| (a near-tie, logged); without a failover on the
    supervisor's ``/metrics.json``; unless replica 1 is back in rotation
    at generation 1; without ``gen0/blackbox-rank1.jsonl`` ending in the
    fault; and unless the supervisor drains and exits 0 on SIGTERM.
    ``bb``: the blackbox directory to use and leave in place (phase 26
    reads it), else a temporary one. Returns the loadgen's run.
    ``device`` exists for a rehearsal on the CPU."""
    import collections
    import os
    import queue
    import shutil
    import signal
    import subprocess
    import tempfile
    import threading
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    from horovod_tpu_torch.serving import (TORCH_MODEL_PREFIX,
                                           config_from_manifest,
                                           load_params, loadgen,
                                           serving_config)
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cfg = serving_config(config_from_manifest(
        CheckpointEngine(ckpt).restore_manifest()))
    base_used = card_memory()[1]       # this process's own holdings
    keep = bb is not None
    bb = bb if keep else tempfile.mkdtemp(prefix="hvd_fleet_bb_")
    mport = free_port()
    env = dict(os.environ, HOROVOD_TPU_METRICS_PORT=str(mport),
               HOROVOD_TPU_BLACKBOX=bb, HOROVOD_TPU_BLACKBOX_WINDOW="3600",
               HOROVOD_TPU_FAULT_SPEC=f"rank=1:replica_crash_at="
                                      f"{FLEET_CRASH_TICK}:gen=0")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.serving", "--fleet",
           str(FLEET_REPLICAS), "--device", device, "--checkpoint-dir", ckpt,
           "--framework", "torch", "--port", "0", "--host", "127.0.0.1",
           "--slots", str(SERVE_SLOTS), "--block-size", str(SERVE_BLOCK),
           "--kv-blocks", str(SERVE_KV_BLOCKS), "--max-new-tokens",
           str(SERVE_NEW)]
    t0 = time.perf_counter()
    # Its own process group: the replicas join it, so a supervisor that
    # dies or is killed leaves none of them behind (the finally below).
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    lines, tail = queue.Queue(), collections.deque(maxlen=60)

    def pump():
        for line in proc.stderr:
            tail.append(line)
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()

    def fail(msg):
        raise AssertionError(f"{msg}; the supervisor's last lines:\n"
                             + "".join(tail))

    try:
        port, deadline = None, time.monotonic() + FLEET_TIMEOUT_S
        while port is None:
            if proc.poll() is not None:
                fail(f"the supervisor exited {proc.returncode}")
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    fail("the fleet printed no routing line")
                continue
            if "[fleet] routing on :" in line:
                port = int(line.split("routing on :")[1].split()[0])
        start_s = time.perf_counter() - t0

        arrivals = loadgen.build_schedule(
            FLEET_RATE, FLEET_DURATION_S, FLEET_SEED,
            [loadgen.TenantSpec("flagship", prompt_len=FLEET_PROMPT,
                                max_new_tokens=SERVE_NEW, vocab=cfg.vocab)])
        index = {id(a): i for i, a in enumerate(arrivals)}
        replies = [None] * len(arrivals)
        http_send = loadgen._http_sender("127.0.0.1", port, FLEET_TIMEOUT_S)

        def send(arrival):
            reply = http_send(arrival)
            replies[index[id(arrival)]] = reply
            return reply

        apps, used, stop_sampling = {}, [], threading.Event()

        def sample_memory():
            while not stop_sampling.wait(2.0):
                rows, total = card_memory()
                for pid, mib in rows.items():
                    apps[pid] = max(apps.get(pid, 0), mib)
                if total is not None:
                    used.append(total)

        sampler = threading.Thread(target=sample_memory, daemon=True)
        sampler.start()
        t_run = time.monotonic()       # the clock the recorder's t_us reads
        run = loadgen.run_schedule(arrivals, max_inflight=64,
                                   timeout_s=FLEET_TIMEOUT_S, sender=send)
        stop_sampling.set()
        sampler.join(timeout=60)
        summary = loadgen.summarize(run)
        bad = [r for r in run["results"] if r["status"] != "completed"]
        if run["dropped"] or bad:
            fail(f"{len(bad)} of {run['offered']} requests failed, "
                 f"{run['dropped']} dropped: {bad[:3]}")
        got = [r["tokens"] for r in replies]
        if any(len(t) != SERVE_NEW for t in got):
            fail(f"reply lengths {sorted({len(t) for t in got})}")
        failovers = fleet_values(mport, "hvdtpu_fleet_failovers_total")
        if sum(failovers.values()) < 1:
            fail(f"no failover on the supervisor's metrics ({failovers})")
        key = 'replica="1",why="crash"'
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while True:
            restarts = fleet_values(mport,
                                    "hvdtpu_fleet_replica_restarts_total")
            health = get_json(port, "/healthz")[1]
            ready = {r["index"] for r in health["replicas"] if r["ready"]}
            if restarts.get(key) == 1 and ready == {0, 1}:
                break
            if time.monotonic() > deadline:
                fail(f"replica 1 not back in rotation: restarts "
                     f"{restarts}, ready {sorted(ready)}")
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=FLEET_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail("the supervisor did not exit after SIGTERM")
        if rc != 0:
            fail(f"the supervisor exited {rc} after SIGTERM")

        gen0 = os.path.join(bb, "gen0", "blackbox-rank1.jsonl")
        if not os.path.exists(gen0):
            fail("no gen0/blackbox-rank1.jsonl")
        header, events = read_dump(gen0)
        last = events[-1] if events else {}
        if header["reason"] != "fault_crash" or last.get("kind") != "fault" \
                or last.get("fault") != "replica_crash":
            fail(f"gen0 dump: reason {header['reason']}, last event {last}")
        gen1, _ = read_dump(os.path.join(bb, "gen1", "blackbox-rank1.jsonl"))
        if gen1["generation"] != 1:
            fail(f"replica 1's second incarnation says generation "
                 f"{gen1['generation']}")
        _, sup = read_dump(os.path.join(bb, f"blackbox-rank"
                                            f"{FLEET_REPLICAS}.jsonl"))
        t_crash = next(e["t_us"] for e in sup if e["kind"] ==
                       "serving_replica" and e["event"] == "crash"
                       and e["replica"] == 1)
        t_back = next(e["t_us"] for e in sup if e["kind"] ==
                      "serving_replica" and e["event"] == "ready"
                      and e["replica"] == 1 and e["t_us"] > t_crash)

        # The in-process engine on the same weights, every prompt at once.
        prompts = [list(a.tokens) for a in arrivals]
        model = tfm.Transformer(cfg, device=dev, params=load_params(
            ckpt, cfg, key_prefix=TORCH_MODEL_PREFIX, device=dev))
        want = serve_engine(model, prompts, max_queue=len(prompts))[0]
        ties = serve_divergence(model, prompts, got, want,
                                "(22) the fleet against in-process")
        del model
        empty_cache(dev)

        tot = summary["tenants"]["flagship"]
        n_tok = SERVE_NEW * len(got)
        ours = os.getpid()
        log(f"fleet (phase 22) on {smi}: python -m horovod_tpu_torch."
            f"serving --fleet {FLEET_REPLICAS} --device {device}, each "
            f"replica phase 21's engine; routing after {start_s:.2f} s; "
            f"loadgen Poisson {FLEET_RATE} req/s for {FLEET_DURATION_S} s "
            f"(seed {FLEET_SEED}, prompts {FLEET_PROMPT[0]}-"
            f"{FLEET_PROMPT[1]} tokens, {SERVE_NEW} new, greedy): "
            f"{run['offered']} offered, {tot['completed']} completed, "
            f"0 failed, goodput {summary['totals']['goodput_frac']}")
        log(f"  TTFT ms p50 {tot['ttft_p50_ms']} p99 {tot['ttft_p99_ms']}; "
            f"latency ms p50 {tot['latency_p50_ms']} p99 "
            f"{tot['latency_p99_ms']} (the replica's, on the request's last "
            f"hop); client wall {run['wall_s']} s")
        log(f"  replica 1 crashed at its decode tick {FLEET_CRASH_TICK}, "
            f"{t_crash / 1e6 - t_run:.2f} s into the load; back in rotation at generation 1 after "
            f"{(t_back - t_crash) / 1e6:.2f} s (crash to ready); failovers "
            f"by phase {failovers}; gen0/blackbox-rank1.jsonl ends in the "
            f"fault; SIGTERM drained, exit 0")
        log(f"  fleet {n_tok / run['wall_s']:.1f} tok/s over the load "
            f"(open loop: bound by the offered {FLEET_RATE} req/s x "
            f"{SERVE_NEW}) beside phase 21's one replica "
            f"{one_replica_tok_s:.1f} tok/s at 8 requests at once")
        log(f"  card memory, peak over the load (nvidia-smi): MiB by "
            f"process row of --query-compute-apps "
            + (", ".join(f"{'this smoke' if pid == ours else pid}: {mib}"
                         for pid, mib in sorted(apps.items()))
               or "not measured")
            + "; the card's memory.used "
            + (f"{max(used)} MiB, {max(used) - base_used} above this "
               f"process's {base_used} before the fleet: the replicas "
               f"together" if used and base_used is not None
               else "not measured"))
        log(f"  tokens against the in-process engine: "
            f"{'identical' if not ties else ties}")
        log(f"  phase 22: {time.perf_counter() - t_phase:.1f} s")
        return run
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)     # drains the replicas
            try:
                proc.wait(timeout=FLEET_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # whatever is left
        except ProcessLookupError:
            pass
        proc.wait(timeout=60)
        if not keep:
            shutil.rmtree(bb, ignore_errors=True)


# ------------------------------------------- phase 23: launch and elastic

LAUNCH_STEPS, LAUNCH_COMMIT, LAUNCH_KILL = 6, 2, 3
LAUNCH_TIMEOUT_S = 600


def launch_phase(smi, ckpt, serve_toks, device="cuda", width=None,
                 dtype=torch.bfloat16):
    """Phase 23: the elastic driver over the launcher on the card, and
    23b: serving through the runner. ``device``, ``width`` and ``dtype``
    exist for a rehearsal on the CPU at a small width."""
    import os
    import shutil
    import tempfile
    from horovod_tpu_torch.elastic import FailureConfig, run_elastic
    from horovod_tpu_torch.experiments import elastic_lm
    from horovod_tpu_torch.runner import run
    t_phase = time.perf_counter()
    empty_cache(torch.device(device))
    kw = dict(device=device, width=width, dtype=dtype)
    # One commit kept: a flagship commit is 1.33 GB.
    env = {"HOROVOD_TPU_CHECKPOINT_KEEP": "1"}
    state_dir = tempfile.mkdtemp(prefix="hvd_launch_")
    clean_dir = tempfile.mkdtemp(prefix="hvd_launch_clean_")
    try:
        t0 = time.perf_counter()
        (res,) = run_elastic(
            elastic_lm.train, args=(LAUNCH_STEPS, LAUNCH_COMMIT, LAUNCH_KILL),
            kwargs=kw, min_np=1, max_np=1, state_dir=state_dir,
            config=FailureConfig(max_restarts=1, backoff_s=0.5),
            extra_env=env, start_timeout=LAUNCH_TIMEOUT_S,
            run_timeout=LAUNCH_TIMEOUT_S)
        elastic_s = time.perf_counter() - t0
        with open(os.path.join(state_dir, "killed_at")) as f:
            killed_at = float(f.read())
        t0 = time.perf_counter()
        (clean,) = run(elastic_lm.train, args=(LAUNCH_STEPS, 0, None),
                       kwargs=kw, np=1,
                       extra_env=dict(env, HOROVOD_TPU_ELASTIC_DIR=clean_dir),
                       start_timeout=LAUNCH_TIMEOUT_S,
                       run_timeout=LAUNCH_TIMEOUT_S)
        clean_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
        shutil.rmtree(clean_dir, ignore_errors=True)
    if (res["generation"], res["start"]) != (1, LAUNCH_COMMIT):
        raise AssertionError(f"generation {res['generation']} resumed at "
                             f"step {res['start']}; expected 1 at "
                             f"{LAUNCH_COMMIT}")
    if res["losses"] != clean["losses"][LAUNCH_COMMIT:]:
        raise AssertionError(f"resumed losses {res['losses']} are not the "
                             f"clean run's {clean['losses']}")
    bad = [k for k, v in clean["params"].items() if res["params"][k] != v]
    if bad or res["moments"] != clean["moments"]:
        raise AssertionError(f"after the elastic restart {len(bad)} "
                             f"parameters differ from the clean run "
                             f"(first {bad[:1]}); moments equal: "
                             f"{res['moments'] == clean['moments']}")
    n_layers = (width or elastic_lm.FLAGSHIP)["n_layers"]
    want = {k: n_layers for k in BF16_FLASH} if device == "cuda" else None
    if want is not None and any(c != want for c in
                                res["launches"] + clean["launches"]):
        raise AssertionError(f"K1-K3 launched {res['launches']} (resumed) "
                             f"and {clean['launches']} (clean) a step; "
                             f"expected {want}")
    log(f"launch and elastic (phase 23) on {smi}: run_elastic of "
        f"elastic_lm.train, {LAUNCH_STEPS} flagship steps, commits every "
        f"{LAUNCH_COMMIT}, generation 0 SIGKILLed after step {LAUNCH_KILL}: "
        f"2 generations, generation 1 restored step {res['start']} in "
        f"{res['restore_s']:.2f} s, its first step "
        f"{res['t_first'] - killed_at:.2f} s after the kill; the driver "
        f"took {elastic_s:.1f} s, the clean run(fn, np=1) {clean_s:.1f} s")
    log(f"  resumed losses {res['losses']}; clean {clean['losses']}; "
        f"{len(res['params'])} parameters and {len(res['moments'])} "
        "moment sets bit for bit the clean run's")
    log(f"  K1-K3 launches a step: resumed {res['launches'][0]}, every "
        f"step of both runs alike")

    # 23b. serving through the runner
    t0 = time.perf_counter()
    replies, streamed, start_s, wall = http_serve(
        ckpt, serve_prompts((width or elastic_lm.FLAGSHIP)["vocab"]),
        ["--device", device, "--tp", "1"],
        launcher=("horovod_tpu_torch.runner", "--serve", "--"))
    toks = [r["tokens"] for r in replies]
    if toks != serve_toks or streamed != serve_toks[0]:
        raise AssertionError("the runner's --serve tokens are not phase "
                             "21's")
    log(f"  23b: python -m horovod_tpu_torch.runner --serve -- --tp 1 on "
        f"phase 21's commit: ready in {start_s:.2f} s, 8 requests in "
        f"{wall:.3f} s, tokens identical to phase 21's; SIGTERM to the "
        f"runner drained the server, exit 0 ({time.perf_counter() - t0:.1f}"
        " s)")
    log(f"  phase 23: {time.perf_counter() - t_phase:.1f} s")


def source_of(name):
    name = base_of(name)
    if name in BN_KERNELS:
        return BN_SOURCE
    if name.startswith("flash_ablate"):
        return ABLATE_SOURCE
    if name.startswith("probe_"):
        return PROBE_SOURCE
    for sfx, src in FLASH_FORM_SOURCES.items():
        if sfx and name.endswith(sfx):
            return src
    return FLASH_SOURCE


def _family(snap, name, labels):
    return snap[name]["values"][labels]


def telemetry_phase(hvd, tfm, fa, build_train_step, lm_losses, lm_step_s):
    """Phase 24; returns the launch counts of its 5 steps."""
    from horovod_tpu_torch.observability import registry as treg
    from horovod_tpu_torch.observability.step_metrics import flops_of_step
    hvd.init()
    dev = hvd.device()
    kw = dict(vocab=32000, d_model=768, n_layers=12, d_ff=3072,
              max_seq=2048, dtype=torch.bfloat16, remat=False)

    def adamw(p):
        return torch.optim.AdamW(p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    b, s = 8, 2048
    tok = torch.randint(0, kw["vocab"], (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()
    counts = {}
    for flash in (True, False):
        step = build_train_step(tfm.TransformerConfig(use_flash=flash, **kw),
                                adamw)
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        counts[flash] = flops_of_step(step, model, opt, tokens, targets)
        # The hooks tie the model and its optimizer in a cycle: collect
        # it, so the timed steps' memory is the flagship's alone.
        del step, model, opt
        gc.collect()
        torch.cuda.empty_cache()
    flops, plain = counts[True], counts[False]
    step = build_train_step(tfm.TransformerConfig(**kw), adamw)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    log(f"  FLOPs a step: {flops:.6e} on the kernels (flash counted by "
        f"torch's SDPA formulas), {plain:.6e} through the plain "
        f"attention; 6*N*tokens {6 * n_params * b * s:.6e}")
    if abs(flops - plain) > FLOPS_TOL * plain:
        raise AssertionError(f"flops_of_step {flops:.6e} is not within "
                             f"{FLOPS_TOL:.0%} of the plain step's "
                             f"{plain:.6e}")
    metrics = hvd.StepMetrics(batch_size=b, flops_per_step=flops)
    label = f'device="cuda:{dev.index}"'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {n: 0 for n in BF16_FLASH}
    losses, times, lines = [], [], []
    for i in range(STEPS):
        fires0 = dict(opt.bucket_fires)
        snap0 = treg.snapshot("hvdtpu_ops_total")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with metrics:
            loss = step(model, opt, tokens, targets)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        launches = fa.launch_counts()
        if any(launches[n] != 12 for n in BF16_FLASH):
            raise AssertionError(f"step {i}: flash launches "
                                 f"{ {n: launches[n] for n in BF16_FLASH} }, "
                                 "expected 12 each")
        for n in BF16_FLASH:
            total[n] += launches[n]
        snap = treg.snapshot()
        fired = sum(opt.bucket_fires.values()) - sum(fires0.values())
        key = 'op="allreduce"'
        ops = (_family(snap, "hvdtpu_ops_total", key)
               - snap0.get("hvdtpu_ops_total", {}).get(
                   "values", {}).get(key, 0.0))
        if ops != fired + 1:
            raise AssertionError(f"step {i}: {ops} allreduce requests, "
                                 f"expected {fired} buckets + the loss")
        shares = {p: _family(snap, "hvdtpu_step_phase_share",
                             f'framework="torch",phase="{p}"')
                  for p in ("input", "h2d", "compute", "collective")}
        if abs(sum(shares.values()) - 1.0) > 1e-6:
            raise AssertionError(f"step {i}: phase shares {shares} sum to "
                                 f"{sum(shares.values())}")
        mfu = _family(snap, "hvdtpu_mfu", 'framework="torch"')
        lines.append(
            f"step {i}: {times[-1] * 1e3:.2f} ms, phases ms "
            + ", ".join(f"{p} {v * 1e3:.3f}"
                        for p, v in metrics.last_phases.items())
            + f", MFU {mfu:.4f}, HBM in use "
            f"{_family(snap, 'hvdtpu_hbm_bytes_in_use', label) / 2**30:.3f}"
            f" GiB, {fired} buckets")
    peak = _family(treg.snapshot("hvdtpu_hbm_peak_bytes"),
                   "hvdtpu_hbm_peak_bytes", label)
    if peak != torch.cuda.max_memory_allocated(dev):
        raise AssertionError(f"hvdtpu_hbm_peak_bytes {peak} != "
                             f"max_memory_allocated "
                             f"{torch.cuda.max_memory_allocated(dev)}")
    if losses != lm_losses:
        raise AssertionError(f"losses under StepMetrics {losses} are not "
                             f"phase 5's {lm_losses}")
    for line in lines:
        log("  " + line)
    steady = statistics.median(times[1:])
    log(f"  {b * s / steady:.1f} tok/s (median of steps 2-{STEPS}, "
        f"{steady * 1e3:.2f} ms/step) beside phase 5's "
        f"{b * s / lm_step_s:.1f} ({lm_step_s * 1e3:.2f} ms/step): "
        f"{(b * s / steady) / (b * s / lm_step_s) - 1:+.2%}; MFU of the "
        f"median step {flops / steady / 989e12:.4f}; HBM peak "
        f"{peak / 2**30:.3f} GiB (= max_memory_allocated); collective "
        f"share of the last step {metrics.last_collective_share:.4f}; "
        "losses phase 5's bit for bit")
    hvd.shutdown()
    return total


NUMERICS_TOL = 1e-3     # phase 25: grad norm, update ratio vs fp64
LEGACY_POINTS = 4       # phase 25: CSV rows the legacy tuner must log
LEGACY_MAX_STEPS = 150


def lm_setup(tfm, build_train_step, **kw):
    """Phase 5's flagship config, AdamW and tokens."""
    cfg = tfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                d_ff=3072, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)

    def adamw(p):
        return torch.optim.AdamW(p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    tok = torch.randint(0, cfg.vocab, (8, 2049),
                        generator=torch.Generator().manual_seed(1))
    step = build_train_step(cfg, adamw, **kw)
    return step, tok[:, :-1].cuda(), tok[:, 1:].cuda()


def timed_steps(step, model, opt, tokens, targets, n, fa=None):
    """n steps; (losses, seconds, launches a step) on the host clock."""
    losses, times, launches = [], [], []
    for _ in range(n):
        if fa is not None:
            fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if fa is not None:
            launches.append({n_: fa.launch_counts()[n_] for n_ in BF16_FLASH})
    return losses, times, launches


def numerics_mesh_runs(hvd, tfm, fa, build_train_step, create_mesh, tnum,
                       lm_step_s):
    """Phase 25a: the world-1 mesh step plane off, then armed; returns
    the armed steps' launch counts."""
    from horovod_tpu_torch.observability import registry as treg
    runs = {}
    for armed in (False, True):
        tnum.set_enabled(armed)
        step, tokens, targets = lm_setup(tfm, build_train_step,
                                         mesh=create_mesh(dp=1))
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        losses, times, launches = timed_steps(step, model, opt, tokens,
                                              targets, STEPS - 1, fa)
        old = [p.detach().double() for p in model.parameters()]
        more, t, ln = timed_steps(step, model, opt, tokens, targets, 1, fa)
        losses += more
        times += t
        launches += ln
        if any(v != 12 for lc in launches for v in lc.values()):
            raise AssertionError(f"phase 25 launches {launches}, expected "
                                 "12 of each a step")
        params = [p.detach().clone() for p in model.parameters()]
        run = {"losses": losses, "times": times, "params": params,
               "launches": {n: sum(lc[n] for lc in launches)
                            for n in BF16_FLASH}}
        if armed:
            tnum.step_stats().flush()
            snap = treg.snapshot("hvdtpu_numerics_")
            got_gn = _family(snap, "hvdtpu_numerics_grad_norm", "")
            got_ur = _family(snap, "hvdtpu_numerics_update_ratio", "")
            g = sum(float(p.grad.double().square().sum())
                    for p in model.parameters())
            u = sum(float((p.detach().double() - o).square().sum())
                    for p, o in zip(model.parameters(), old))
            w = sum(float(o.square().sum()) for o in old)
            want_gn, want_ur = math.sqrt(g), math.sqrt(u) / math.sqrt(w)
            for what, got, want in (("grad norm", got_gn, want_gn),
                                    ("update ratio", got_ur, want_ur)):
                rel = abs(got - want) / abs(want)
                log(f"  step 5 {what}: {got!r} against fp64 {want!r}, rel "
                    f"{rel:.3e} (tolerance {NUMERICS_TOL})")
                if rel > NUMERICS_TOL:
                    raise AssertionError(f"phase 25 {what} {got} is not "
                                         f"within {NUMERICS_TOL} of {want}")
            t0 = time.perf_counter()
            digests = tnum.fingerprint_tree(model)
            run["fp_ms"] = (time.perf_counter() - t0) * 1e3
            run["n_params"] = sum(d[2] for d in digests.values())
        del step, model, opt, old
        gc.collect()
        torch.cuda.empty_cache()
        runs[armed] = run
    tnum.set_enabled(False)
    off, on = runs[False], runs[True]
    if any(not torch.equal(a, b) for a, b in zip(off["params"],
                                                  on["params"])):
        raise AssertionError("phase 25: the armed step's parameters are not "
                             "the plane-off step's bit for bit")
    if off["losses"] != on["losses"]:
        raise AssertionError(f"phase 25: armed losses {on['losses']} != "
                             f"plane-off {off['losses']}")
    tok = 8 * 2048
    for what, r in (("plane off", off), ("armed", on)):
        steady = statistics.median(r["times"][1:])
        log(f"  mesh step {what}: {tok / steady:.1f} tok/s (median of steps "
            f"2-{STEPS}, {steady * 1e3:.2f} ms/step), losses {r['losses']}")
    a, b = (statistics.median(r["times"][1:]) for r in (off, on))
    log(f"  armed {tok / b:.1f} tok/s: {(a / b) - 1:+.2%} against the "
        f"plane-off mesh step, {lm_step_s / b - 1:+.2%} against phase 5's "
        f"{tok / lm_step_s:.1f}; parameters after step 5 bit for bit")
    log(f"  fingerprint probe: {on['fp_ms']:.1f} host ms over "
        f"{on['n_params']} parameters ({on['fp_ms'] / 50 / (b * 1e3):.2%} of "
        "the step time at the default interval of 50)")
    return on["launches"]


def nan_at_run(tfm, build_train_step, tnum, tfaults, tcoll):
    """Phase 25b: phase 5's dp step, armed, under a nan_at clause."""
    import os
    step, tokens, targets = lm_setup(tfm, build_train_step)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    # An armed step enqueues its buckets, the loss and the numerics
    # vector: the clause poisons step 1's third bucket.
    nan_tick = (len(opt._buckets) + 2) + 2
    os.environ["HOROVOD_TPU_FAULT_SPEC"] = f"rank=0:nan_at={nan_tick}"
    tfaults.reset()
    eng = tcoll.engine()
    eng._faults_tried = False       # the engine resolves the clause anew
    tnum.set_enabled(True)
    tnum._monitor = None
    scan = []
    try:
        for _ in range(2):
            t0 = tnum._scan_tick
            step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            eng.collect_timings(block=True)
            scan.append((t0, tnum._scan_tick))
        tnum.step_stats().flush()
        alerts = [a for a in tnum._alert_monitor().alerts
                  if a.kind == "nonfinite_rate"]
    finally:
        os.environ.pop("HOROVOD_TPU_FAULT_SPEC", None)
        tfaults.reset()
        eng._faults_tried = False
        eng._faults = None
        tnum.set_enabled(False)
    if len(alerts) != 1:
        raise AssertionError(f"phase 25: nan_at gave {len(alerts)} "
                             f"nonfinite_rate alerts: "
                             f"{[a.evidence for a in alerts]}")
    ev = alerts[0].evidence
    lo, hi = scan[1]
    if ev["rank"] != 0 or not lo <= ev["step"] < hi:
        raise AssertionError(f"phase 25: the alert {ev} does not name rank "
                             f"0 and a scan tick of step 1 ({lo}-{hi - 1})")
    log(f"  nan_at={nan_tick}: one nonfinite_rate alert, rank {ev['rank']}, "
        f"source {ev['source']}, scan tick {ev['step']} (step 1's ticks "
        f"{lo}-{hi - 1})")
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()


def legacy_tuner_run(hvd, tfm, build_train_step, tcoll, lm_losses):
    """Phase 25c: phase 5's dp step under HOROVOD_AUTOTUNE=1."""
    import os
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="hvd_autotune_"),
                        "autotune.csv")
    os.environ["HOROVOD_AUTOTUNE"] = "1"
    os.environ["HOROVOD_AUTOTUNE_LOG"] = path
    try:
        hvd.init()
        step, tokens, targets = lm_setup(tfm, build_train_step)
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        pm = tcoll.engine()._coord._pm
        losses, n, t0 = [], 0, time.perf_counter()
        while pm.steps < LEGACY_POINTS and n < LEGACY_MAX_STEPS:
            losses.append(float(step(model, opt, tokens, targets)))
            n += 1
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rounds = tcoll.engine().rounds
        hvd.shutdown()
    finally:
        os.environ.pop("HOROVOD_AUTOTUNE", None)
        os.environ.pop("HOROVOD_AUTOTUNE_LOG", None)
    with open(path) as f:
        lines = f.read().strip().splitlines()
    rows = [tuple(float(v) for v in ln.split(",")) for ln in lines[1:]]
    points = {(r[0], r[1]) for r in rows}
    log(f"  legacy tuner: {n} steps, {rounds} rounds, {secs:.1f} s; "
        f"CSV {lines[0]!r}, rows {rows}")
    if lines[0] != "fusion_mb,cycle_ms,hier_allreduce,hier_allgather,score" \
            or len(points) < 3:
        raise AssertionError(f"phase 25: the legacy tuner logged "
                             f"{len(points)} distinct points: {lines}")
    if losses[:STEPS] != lm_losses:
        raise AssertionError(f"phase 25: losses under the legacy tuner "
                             f"{losses[:STEPS]} are not phase 5's "
                             f"{lm_losses}")
    log(f"  losses of the first {STEPS} steps phase 5's bit for bit; "
        f"{len(points)} distinct (fusion, cycle) points")


def global_tuner_run(hvd, tfm, build_train_step, tcoll):
    """Phase 25d: the AutoTuner's online moves on phase 5's dp step."""
    from horovod_tpu_torch.autotune import (ApplyPlane, AutoTuner,
                                            default_registry)
    hvd.init()
    step, tokens, targets = lm_setup(tfm, build_train_step)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    eng = tcoll.engine()
    verdicts, losses = [], []

    def move(knob, value):
        v = eng.tuner_move(knob, value)
        verdicts.append((knob, value, v))
        if not v["accepted"] and v["reason"] != "noop":
            raise AssertionError(f"phase 25: tuner move {knob}={value} "
                                 f"refused: {v}")

    def measure(budget):
        times = []
        for _ in range(2 * budget):
            t0 = time.perf_counter()
            losses.append(float(step(model, opt, tokens, targets)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    plane = ApplyPlane(set_fusion=lambda mb: move("fusion_threshold_mb", mb),
                       set_bucket_mb=opt.set_bucket_cap_mb,
                       set_engine_param=move)
    tuner = AutoTuner(default_registry(include=(
        "fusion_threshold_mb", "torch_bucket_mb", "cycle_time_ms")),
        plane=plane, measure=measure, trial_budget=1)
    measure(1)      # warm-up
    moves = tuner.run()
    for m in moves:
        log(f"  move {m.knob} {m.old!r} -> {m.new!r}: {m.outcome} "
            f"{m.detail}; step ms {m.baseline_s * 1e3:.2f} -> "
            f"{m.after_s * 1e3:.2f}")
    log(f"  coordinator verdicts: {[(k, v['reason']) for k, _, v in verdicts]}"
        f"; final {tuner.current}")
    # Every value of each knob's domain but the current one (a kept move
    # makes the old value a candidate too), and one GP move.
    if len(moves) < 8 or not all(math.isfinite(x) for x in losses) \
            or any(m.outcome not in ("kept", "reverted", "rolled_back")
                   for m in moves):
        raise AssertionError(f"phase 25: {len(moves)} tuner moves, losses "
                             f"{losses}")
    hvd.shutdown()


def numerics_autotune_phase(hvd, tfm, fa, build_train_step, create_mesh,
                            lm_losses, lm_step_s):
    """Phase 25; returns the launch counts of the armed mesh steps."""
    from horovod_tpu_torch.adaptation import faults as tfaults
    from horovod_tpu_torch.observability import numerics as tnum
    from horovod_tpu_torch.ops import collective as tcoll
    hvd.init()
    launches = numerics_mesh_runs(hvd, tfm, fa, build_train_step,
                                  create_mesh, tnum, lm_step_s)
    nan_at_run(tfm, build_train_step, tnum, tfaults, tcoll)
    hvd.shutdown()
    legacy_tuner_run(hvd, tfm, build_train_step, tcoll, lm_losses)
    global_tuner_run(hvd, tfm, build_train_step, tcoll)
    return launches


# ------------------------------------------ phase 26: the offline tools

TOOLS_STEPS = 20
TOOLS_COLD_STEPS = 3     # the cold window: logged, not gated
TOOLS_SHARE_TOL = 0.10   # trace report's shares against StepMetrics'
TOOLS_TIMEOUT_S = 300


def run_tool(name, *argv):
    """``horovod_tpu_torch.tools.run``: (stdout, host seconds); fails on a
    nonzero exit code."""
    from horovod_tpu_torch.tools import run
    rc, out, err, secs = run(name, *argv, timeout=TOOLS_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"tools.{name} {' '.join(argv)} exited "
                             f"{rc}:\n{err[-3000:]}")
    return out, secs


def tools_steps(hvd, tfm, fa, build_train_step, steps):
    """``steps`` of phase 5's flagship under ``StepMetrics`` (K1-K3 12
    times each): (StepMetrics' phase sums, the launches, the losses)."""
    step, tokens, targets = lm_setup(tfm, build_train_step)
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = step.make_optimizer(model)
    metrics = hvd.StepMetrics(batch_size=8)
    sums = {p: 0.0 for p in ("input", "h2d", "compute", "collective")}
    total = {n: 0 for n in BF16_FLASH}
    losses = []
    for i in range(steps):
        fa.reset_launch_counts()
        with metrics:
            losses.append(float(step(model, opt, tokens, targets)))
        launches = fa.launch_counts()
        if any(launches[n] != 12 for n in BF16_FLASH):
            raise AssertionError(f"step {i}: flash launches "
                                 f"{ {n: launches[n] for n in BF16_FLASH} }")
        for n in BF16_FLASH:
            total[n] += launches[n]
        for p, v in metrics.last_phases.items():
            sums[p] += v
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses {losses}")
    return sums, total, losses


def tools_shares(d, sums):
    """``trace report`` over the timeline in ``d``: (rank 0's report,
    StepMetrics' shares from ``sums`` in its buckets, the gaps, the
    tool's host seconds)."""
    import os
    rep = os.path.join(d, "trace.json")
    _, secs = run_tool("trace", "report",
                       os.path.join(d, "timeline.{rank}.json"),
                       "--report", rep)
    with open(rep) as f:
        trace = json.load(f)["per_rank"]["0"]
    cycle = sum(sums.values())
    ours = {"input": (sums["input"] + sums["h2d"]) / cycle,
            "compute": sums["compute"] / cycle,
            "comm": sums["collective"] / cycle}
    gaps = {b: abs(trace["phase_share"][b] - ours[b]) for b in ours}
    return trace, ours, gaps, secs


def fmt_shares(shares):
    return "{" + ", ".join(f"'{b}': {v:.4f}" for b, v in shares.items()) + "}"


def tools_phase(hvd, tfm, fa, build_train_step, fleet_bb, fleet_run, smi):
    """Phase 26; returns the launch counts of its gated steps."""
    import os
    import shutil
    import subprocess
    import tempfile
    from horovod_tpu_torch.observability import flight_recorder, history
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="hvd_tools_")
    # The cold window, logged and not gated: a few steps with the
    # timeline armed on a communicator that init makes, so its set-up
    # (the first collective) falls inside the window. The trace report
    # (JAX's arithmetic) sums that step's overlapping NEGOTIATE and NCCL
    # spans as they are, while StepMetrics caps a step's collective at
    # its wall time: the report over-counts comm there.
    cold_dir = os.path.join(d, "cold")
    os.makedirs(cold_dir)
    os.environ["HOROVOD_TIMELINE"] = os.path.join(cold_dir,
                                                  "timeline.{rank}.json")
    try:
        hvd.init()
        cold_sums, _, _ = tools_steps(hvd, tfm, fa, build_train_step,
                                      TOOLS_COLD_STEPS)
        hvd.shutdown()
    finally:
        os.environ.pop("HOROVOD_TIMELINE", None)
    env = {"HOROVOD_TIMELINE": os.path.join(d, "timeline.{rank}.json"),
           "HOROVOD_TPU_HISTORY": os.path.join(d, "history"),
           "HOROVOD_TPU_HISTORY_INTERVAL": "0.25",
           "HOROVOD_TPU_BLACKBOX": os.path.join(d, "bb"),
           "HOROVOD_TPU_BLACKBOX_INTERVAL": "0"}
    # The gated window is the steady state: the communicator's set-up
    # (~1.9 s on the first collective) happens before the timeline
    # opens, on a process group this phase makes, which init adopts.
    import torch.distributed as dist
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    warm = torch.zeros(1, device="cuda" if torch.cuda.is_available()
                       else "cpu")
    dist.all_reduce(warm)
    float(warm)
    os.environ.update(env)
    try:
        hvd.init()
        if hvd.get_topology().owns_group:
            raise AssertionError("init made a group of its own")
        sums, total, losses = tools_steps(hvd, tfm, fa, build_train_step,
                                          TOOLS_STEPS)
        flight_recorder.recorder().dump("exit")
        history.stop_sampler()
        hvd.shutdown()
    finally:
        for k in env:
            os.environ.pop(k, None)
        if dist.is_initialized():
            dist.destroy_process_group()
    try:
        secs = {}
        # trace report over the port's own timeline: the cold window
        # logged, the steady one gated
        cold, cold_ours, cold_gaps, secs["trace report (cold)"] = \
            tools_shares(cold_dir, cold_sums)
        trace, ours, gaps, secs["trace report"] = tools_shares(d, sums)
        log(f"  trace report, rank 0: phase means (s) "
            f"{trace['phase_mean_s']}; StepMetrics' sums (s) "
            + "{" + ", ".join(f"'{p}': {v:.6f}" for p, v in sums.items())
            + "}")
        if trace["phase_mean_s"]["execute"] <= 0:
            raise AssertionError(f"trace report: no execute seconds "
                                 f"({trace['phase_mean_s']})")
        if max(gaps.values()) > TOOLS_SHARE_TOL:
            raise AssertionError(
                f"trace report's shares {trace['phase_share']} against "
                f"StepMetrics' {ours}: gaps {gaps}")
        # health over the history, and against itself
        hdir = os.path.join(d, "history")
        out, secs["health"] = run_tool("health", hdir, "--json")
        health = json.loads(out)
        out, secs["health --baseline"] = run_tool(
            "health", hdir, "--baseline", hdir, "--json")
        base = json.loads(out)["baseline"]
        if base["verdict"] != "no_regressions" or not base["series_compared"]:
            raise AssertionError(f"health --baseline against itself: {base}")
        # postmortem over phase 22's replica dumps, and this phase's own
        pm = os.path.join(d, "pm.json")
        _, secs["postmortem"] = run_tool(
            "postmortem", os.path.join(fleet_bb, "gen0"), "--json", pm)
        with open(pm) as f:
            post = json.load(f)
        died = post["died_first"]
        if died["rank"] != 1 or "serving replica crash" not in died["phase"] \
                or not post["per_rank"]["1"]["inflight_requests"]:
            raise AssertionError(f"postmortem of phase 22: {died}, "
                                 f"{post['per_rank'].get('1')}")
        own = os.path.join(d, "pm26.json")
        _, secs["postmortem (phase 26)"] = run_tool(
            "postmortem", os.path.join(d, "bb"), "--json", own)
        with open(own) as f:
            own = json.load(f)
        if own["first_divergent_group_seq"] is not None \
                or own["per_rank"]["0"]["reason"] != "exit":
            raise AssertionError(f"postmortem of a clean run: {own}")
        # what every tool pays before its own work: the package's import
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import horovod_tpu_torch"],
                       check=True, timeout=TOOLS_TIMEOUT_S)
        import_s = time.perf_counter() - t0
        # slo over phase 22's loadgen rows
        runf = os.path.join(d, "loadgen.json")
        with open(runf, "w") as f:
            json.dump(dict(fleet_run, name="fleet"), f)
        sj = os.path.join(d, "slo.json")
        _, secs["slo"] = run_tool("slo", runf, "--json", sj)
        with open(sj) as f:
            slo = json.load(f)
        arm = slo["arms"][0]
        if arm["offered"] != fleet_run["offered"] or arm["dropped"] != 0:
            raise AssertionError(f"slo report of phase 22's run: {arm}")
        log(f"tools (phase 26) on {smi}: phase 5's flagship, {TOOLS_STEPS} "
            f"steps under StepMetrics with the timeline, the history "
            f"sampler (0.25 s) and the blackbox armed; losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        log("  trace report, steady window (gated): execute mean "
            f"{trace['phase_mean_s']['execute'] * 1e3:.3f} ms a span, "
            f"negotiate {trace['phase_mean_s']['negotiate'] * 1e3:.3f} ms; "
            f"shares {trace['phase_share']} against StepMetrics' "
            f"{fmt_shares(ours)} (largest gap {max(gaps.values()):.4f}, "
            f"tolerance {TOOLS_SHARE_TOL}); verdict {trace['verdict']}")
        log(f"  trace report, cold window ({TOOLS_COLD_STEPS} steps, the "
            "communicator's set-up inside; logged, not gated): execute "
            f"mean {cold['phase_mean_s']['execute'] * 1e3:.3f} ms a span, "
            f"negotiate {cold['phase_mean_s']['negotiate'] * 1e3:.3f} ms; "
            f"shares {cold['phase_share']} against StepMetrics' "
            f"{fmt_shares(cold_ours)} (largest gap "
            f"{max(cold_gaps.values()):.4f}); verdict {cold['verdict']}")
        log(f"  health: {len(health['labels'])} label(s), "
            f"{health['labels'][0]['samples']} samples, "
            f"{len(health['alerts'])} alert(s); --baseline against itself: "
            f"{base['verdict']} over {base['series_compared']} series")
        log(f"  postmortem of phase 22's gen0 dumps: rank {died['rank']} "
            f"went first ({died['how']}), {died['phase']}; in flight "
            f"{len(post['per_rank']['1']['inflight_requests'])} request(s); "
            f"of this phase's own dump: reason "
            f"{own['per_rank']['0']['reason']}, no divergence")
        log(f"  slo of phase 22's loadgen: {arm['offered']} offered, "
            f"goodput {arm['goodput']} ({arm['goodput_frac']}), TTFT p99 "
            f"{arm['ttft_p99_ms']} ms")
        log("  host seconds by tool (subprocess, imports included): "
            + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
            + f"; python -c 'import horovod_tpu_torch' alone {import_s:.2f}")
        log(f"  phase 26: {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return total


# ------------------------------------------ phase 27: the mxnet shim

MX_DTYPES = (np.uint8, np.int8, np.int32, np.float16, np.float32)
FLAGSHIP_PARAMS = 111_102_720
MX_LR = 0.1
MX_TIMED = 5


class MxSGD:
    """The shape of ``tests/test_mxnet.py``'s optimizer stub
    (``update(index, weight, grad, state)`` for one index or a list),
    its arithmetic on the NDArrays' card: ``weight -= lr * grad``."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def update(self, index, weight, grad, state):
        if isinstance(index, (tuple, list)):
            for w, g in zip(weight, grad):
                w -= self.learning_rate * g
        else:
            weight -= self.learning_rate * grad


def mx_collectives(mx, nd, dev):
    """test_mxnet.py's sweeps over NDArrays on ``dev`` (the card) at
    n = 1, against numpy: every result is its input, bit for bit."""
    n = 0
    for dtype in MX_DTYPES:
        for dim in (1, 2, 3):
            rs = np.random.RandomState(dim)
            x = (rs.randint(0, 10, [17] * dim) if np.dtype(dtype).kind
                 in "iu" else rs.rand(*[17] * dim)).astype(dtype)
            t = nd.array(x, dtype=dtype)
            if t.context != dev:
                raise AssertionError(f"NDArray on {t.context}, not {dev}")
            for what, out in (("sum", mx.allreduce(t, average=False)),
                              ("average", mx.allreduce(t)),
                              ("allgather", mx.allgather(t)),
                              ("broadcast", mx.broadcast(t, 0))):
                if out.dtype != dtype or not np.array_equal(out.asnumpy(), x):
                    raise AssertionError(f"mxnet {what} {np.dtype(dtype)} "
                                         f"dim {dim} is not its input")
                n += 1
    t = nd.array(np.arange(12.0).reshape(3, 4), dtype=np.float32)
    if mx.allreduce_(t, average=False) is not t \
            or mx.broadcast_(t, 0) is not t \
            or not np.array_equal(t.asnumpy(), np.arange(12.0).reshape(3, 4)):
        raise AssertionError("mxnet in-place ops")
    ts = [nd.array(np.full(8, i + 1.0), dtype=np.float32) for i in range(5)]
    mx.allreduce_multi_(ts, average=False)
    if any(not np.array_equal(t_.asnumpy(), np.full(8, i + 1.0))
           for i, t_ in enumerate(ts)):
        raise AssertionError("mxnet allreduce_multi_")
    big = np.array([[2 ** 40 + 3, -7], [1, 2 ** 52 + 1]], dtype=np.int64)
    f64 = np.array([1e300, -2.5e-308, 3.14], dtype=np.float64)
    if not np.array_equal(mx.allgather(nd.array(big, dtype=np.int64))
                          .asnumpy(), big) \
            or not np.array_equal(mx.broadcast(nd.array(f64, dtype=np.float64),
                                               0).asnumpy(), f64):
        raise AssertionError("mxnet 64-bit payloads")
    return n + 4


def mxnet_phase(hvd, tfm, smi):
    """Phase 27."""
    t_phase = time.perf_counter()
    hvd.init()
    import horovod_tpu_torch.mxnet as mx
    from horovod_tpu_torch.mxnet import nd
    n_checked = mx_collectives(mx, nd, hvd.device())
    dev = hvd.device()
    model = tfm.Transformer(tfm.TransformerConfig(**FLAGSHIP), device=dev)
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(27)
    ws = [nd.array(p.detach().float()) for p in model.parameters()]
    gs = [nd.array(torch.randn(p.shape, generator=gen, device=dev))
          for p in model.parameters()]
    del model
    n_params = sum(w.size for w in ws)
    if n_params != FLAGSHIP_PARAMS:
        raise AssertionError(f"{n_params} parameters, not the flagship's")
    before = [w.asnumpy() for w in ws]
    mx.broadcast_parameters(dict(zip(names, ws)), root_rank=0)
    if any(not np.array_equal(w.asnumpy(), b) for w, b in zip(ws, before)):
        raise AssertionError("broadcast_parameters changed a parameter")
    grads = [g.asnumpy() for g in gs]
    opt = mx.DistributedOptimizer(MxSGD(MX_LR))
    index = list(range(len(ws)))
    states = [None] * len(ws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update(index, ws, gs, states)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    lr = np.float32(MX_LR)
    for w, b, g, name in zip(ws, before, grads, names):
        if not np.array_equal(w.asnumpy(), b - lr * g):
            raise AssertionError(f"update of {name} is not numpy's "
                                 "w - lr * g")
    for g, want in zip(gs, grads):
        if not np.array_equal(g.asnumpy(), want):
            raise AssertionError("the averaged gradient at n = 1 is not "
                                 "the gradient")
    times, sgd_times = [], []
    for _ in range(MX_TIMED):
        t0 = time.perf_counter()
        opt.update(index, ws, gs, states)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for _ in range(MX_TIMED):
        t0 = time.perf_counter()
        opt._optimizer.update(index, ws, gs, states)
        torch.cuda.synchronize()
        sgd_times.append((time.perf_counter() - t0) * 1e3)
    nbytes = 3 * 4 * n_params
    bound, _ = bound_ms(2 * n_params, nbytes, PEAK_FP32_FLOPS)
    log(f"mxnet shim (phase 27) on {smi}: {n_checked} collectives over CUDA "
        f"NDArrays (test_mxnet.py's dtypes x dims, in place, fused, "
        f"64-bit) equal their inputs at n = 1; broadcast_parameters over "
        f"{len(ws)} NDArrays of the flagship's {n_params:,} parameters "
        "unchanged; DistributedOptimizer.update (SGD lr 0.1) equals "
        "numpy's w - lr * g bit for bit")
    log(f"  update (fused allreduce of {len(ws)} gradients + SGD), host "
        f"clock to a synchronize: first {first_ms:.2f} ms, median of "
        f"{MX_TIMED} {statistics.median(times):.2f} ms; the SGD alone "
        f"{statistics.median(sgd_times):.2f} ms (two kernels a tensor: "
        f"lr * g, then w -= it); bytes bound of the update's arithmetic "
        f"(3 passes over {nbytes / 3 / 1e9:.3f} GB: read w and g, write "
        f"w) {bound:.3f} ms")
    del ws, gs
    empty_cache(dev)
    hvd.shutdown()
    log(f"  phase 27: {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="after each main path, profile 2 more steps and "
                         "append the kernel table to PATH")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as tres
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch import executor as texec
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import control_plane as cp
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_bn as fbn
    from horovod_tpu_torch.ops import probes as pr
    from horovod_tpu_torch.experiments import (flash_ablate_probe,
                                               mem_probe, shape_probe)
    from horovod_tpu_torch.parallel.train import (build_image_train_step,
                                                  build_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.profile:
        open(args.profile, "w").close()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = device_line()
    log(f"device: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)")

    # 3. flash kernels vs plain
    log("flash kernels vs plain (tolerance: rel "
        f"{REL_TOL} on O/dQ/dK/dV, abs {LSE_TOL} on lse):")
    rows = check_kernels(fa, 8, 6, 2048, 128, True, timed=True)
    check_kernels(fa, 2, 6, 1000, 128, True, timed=False)
    check_kernels(fa, 1, 2, 384, 128, True, timed=False)
    check_kernels(fa, 1, 3, 129, 128, True, timed=False)
    check_kernels(fa, 2, 1, 100, 128, True, timed=False)
    check_kernels(fa, 2, 1, 192, 128, True, timed=False)
    check_kernels(fa, 2, 4, 512, 64, False, timed=False)
    # The head_dim-96 LM's attention, and D=128 at the same shape: logged.
    check_kernels(fa, 4, 8, 1024, 96, True, timed=True)
    check_kernels(fa, 4, 8, 1024, 128, True, timed=True)
    check_kernels(fa, 2, 3, 200, 96, True, timed=False)
    check_kernels(fa, 2, 2, 130, 96, False, timed=False)
    check_kernels(fa, 2, 3, 300, 80, True, timed=False)
    check_kernels(fa, 2, 2, 130, 32, True, timed=False)

    # 3b. every operand dtype and head dim of the flash forms
    rows.update(flash_forms_phase(fa))

    # 3c. head dims above 256
    rows.update(wide_forms_phase(fa))

    # 4. parity of the LM on the flash kernels
    parity(tfm, fa)

    # 5. LM main path
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
    launches, lm_step_s, lm_losses = lm_main_path(hvd, tfm, fa, fbn,
                                                  build_train_step,
                                                  args.profile)
    lm_loss1 = lm_losses[0]
    torch.cuda.empty_cache()

    # 6. BN kernels vs plain, per-call and per-step times
    probe = tres.ResNet50(num_classes=1000, bn_impl="pallas", device="cuda")
    layers, macs = bn_layers_and_macs(probe, RESNET_BATCH, RESNET_IMAGE)
    del probe
    if len(layers) != 53:
        raise AssertionError(f"ResNet-50 has {len(layers)} BN layers, not 53")
    rows.update(bn_phase(fbn, layers))
    bn_bound_ms = sum(bound_ms(*bn_work(name, *layer), PEAK_FP32_FLOPS)[0]
                      for layer in layers for name in BN_KERNELS)

    # 7. parity of a small ResNet on the BN kernels
    resnet_parity(tres)

    # 8. ResNet-50 main path
    bn_launches, resnet_flax_losses = resnet_main_path(
        hvd, tres, fa, fbn, build_image_train_step, macs, bn_bound_ms,
        args.profile)
    launches.update(bn_launches)
    hvd.shutdown()

    # 9. the probes P1-P3
    probe_rows, probe_launches = probe_phase(
        pr, shape_probe, mem_probe, flash_ablate_probe,
        rows["flash_fwd"]["ms"])
    rows.update(probe_rows)
    launches.update(probe_launches)

    # 10. the collective engine on the card
    engine_phase(hvd, cp, texec, tfm, fa, build_train_step)

    # 11. the blockwise wire on the card
    wire_phase(hvd, tfm, tres, texec, build_train_step,
               build_image_train_step, lm_step_s)

    # 12. tensor and sequence parallelism
    f32_rows, f32_launches = tp_sp_phase(hvd, tfm, fa, build_train_step,
                                         lm_loss1, lm_step_s, args.profile)
    rows.update(f32_rows)
    launches.update(f32_launches)

    # 13. ZeRO-1 and the hierarchical reduction at one card
    from horovod_tpu_torch import quantization as tq
    from horovod_tpu_torch.parallel.mesh import create_mesh
    zero_dcn_phase(hvd, tfm, tq, build_train_step, create_mesh, lm_step_s)

    # 14. the MoE flagship
    moe_main_path(hvd, tfm, fa, build_train_step, create_mesh, args.profile)

    # 15. the pipelined flagship
    t15 = time.perf_counter()
    for name, n in pipeline_phase(hvd, tfm, fa, create_mesh, lm_loss1,
                                  lm_step_s, args.profile).items():
        launches[name] += n
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")

    # 16. the flagship LM in fp16 and fp32
    t16 = time.perf_counter()
    launches.update(dtype_lm_phase(hvd, tfm, fa, build_train_step,
                                   create_mesh, lm_step_s))
    log(f"  phase 16: {time.perf_counter() - t16:.1f} s")

    # 17. the engine's remainder at one card
    engine_remainder_phase(hvd, tfm, fa, fbn, build_train_step, lm_losses,
                           lm_step_s)

    # 18. the conv zoo's main path through the input pipeline
    from horovod_tpu_torch import data
    from horovod_tpu_torch import models as zoo
    t18 = time.perf_counter()
    hvd.init()
    zoo_main_path(hvd, data, zoo, fa, fbn, build_image_train_step,
                  args.profile)
    log(f"  phase 18: {time.perf_counter() - t18:.1f} s")

    # 19. the small models and sync BN
    t19 = time.perf_counter()
    small_models_phase(hvd, data, zoo, tres, fa, fbn, create_mesh,
                       build_image_train_step, resnet_flax_losses[0])
    hvd.shutdown()
    log(f"  phase 19: {time.perf_counter() - t19:.1f} s")

    # 20. checkpoint and elastic resume of the flagship
    t20 = time.perf_counter()
    elastic_phase(hvd, tfm, fa, data, build_train_step, smi)
    log(f"  phase 20: {time.perf_counter() - t20:.1f} s")

    # 21. the flagship served on the card; 22. the fleet on its commit
    # (its blackbox kept for phase 26)
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="hvd_serve_")
    fleet_bb = tempfile.mkdtemp(prefix="hvd_fleet_bb_")
    atexit.register(shutil.rmtree, fleet_bb, True)
    try:
        serve_tok_s, serve_toks = serving_phase(tfm, fa, fbn, smi,
                                                ckpt=ckpt)
        fleet_run = fleet_phase(tfm, smi, ckpt, serve_tok_s, bb=fleet_bb)
        # 23. the launcher and the elastic driver; 23b. --serve
        launch_phase(smi, ckpt, serve_toks)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # 24. step telemetry on the flagship
    t24 = time.perf_counter()
    for name, n in telemetry_phase(hvd, tfm, fa, build_train_step,
                                   lm_losses, lm_step_s).items():
        launches[name] += n
    log(f"  phase 24: {time.perf_counter() - t24:.1f} s")

    # 25. the numerics plane and the autotuners
    t25 = time.perf_counter()
    for name, n in numerics_autotune_phase(hvd, tfm, fa, build_train_step,
                                           create_mesh, lm_losses,
                                           lm_step_s).items():
        launches[name] += n
    log(f"  phase 25: {time.perf_counter() - t25:.1f} s")

    # 26. the offline tools over the port's own files; 27. the mxnet shim
    for name, n in tools_phase(hvd, tfm, fa, build_train_step, fleet_bb,
                               fleet_run, smi).items():
        launches[name] += n
    mxnet_phase(hvd, tfm, smi)

    kernels = [dict(name=name, route="cuda", source=source_of(name),
                    replaces=REPLACES[base_of(name)],
                    launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in rows.items()]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
