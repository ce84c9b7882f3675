#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: nvcc builds the flash-attention kernels from
   ``horovod_tpu_torch/ops/csrc`` (first use);
3. kernels: each kernel against its plain PyTorch version on the card at
   the flagship shape (B=8, H=6, S=2048, D=128, causal), a ragged causal
   shape (S=1000) and a non-causal D=64 shape, with timings of the
   kernel, the plain version and, as a yardstick only, PyTorch's
   ``scaled_dot_product_attention``;
4. parity: a 2-layer model with the flash kernels against the same model
   on plain attention, loss and gradients;
5. main path: ``init`` (NCCL, world 1), the 111M flagship LM,
   ``broadcast_parameters``, ``DistributedOptimizer(AdamW)`` and 5 train
   steps of 8 x 2048 tokens; the loss must be finite and fall, and each
   kernel must launch exactly 12 times per step.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. ``--profile PATH`` also writes the
device time of each kernel over 2 more train steps to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:123",
    "flash_dkv": "horovod_tpu/ops/flash_attention.py:178",
    "flash_dq": "horovod_tpu/ops/flash_attention.py:246",
}
STEPS = 5
REL_TOL = 2e-2    # max |kernel - plain| / max |plain| on O, dQ, dK, dV
LSE_TOL = 1e-3    # max |kernel - plain| on lse


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=10, warmup=2):
    """Median over ``iters`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(q + 1, sk) for q in range(sq))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def relerr(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def abserr(got, want):
    return float((got.float() - want.float()).abs().max())


def check_kernels(fa, b, h, s, d, causal, timed):
    """Hold K1-K3 against their plain versions at one shape; with
    ``timed`` also time kernel, plain version and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(1234 + s + d)
    bh = b * h
    shape = (bh, s, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5

    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref,
                                                    delta, scale, causal)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse_ref, delta, scale, causal)
    dq = fa.flash_dq_cuda(q, k, v, do, lse_ref, delta, scale, causal)
    torch.cuda.synchronize()

    errs = {
        "flash_fwd": {"o": relerr(o, o_ref), "lse": abserr(lse, lse_ref)},
        "flash_dkv": {"dk": relerr(dk, dk_ref), "dv": relerr(dv, dv_ref)},
        "flash_dq": {"dq": relerr(dq, dq_ref)},
    }
    absmax = {
        "flash_fwd": max(abserr(o, o_ref), abserr(lse, lse_ref)),
        "flash_dkv": max(abserr(dk, dk_ref), abserr(dv, dv_ref)),
        "flash_dq": abserr(dq, dq_ref),
    }
    log(f"  shape B={b} H={h} S={s} D={d} causal={causal}: "
        f"{json.dumps(errs)}")
    for name, e in errs.items():
        for out, val in e.items():
            tol = LSE_TOL if out == "lse" else REL_TOL
            if not (val <= tol):
                raise AssertionError(
                    f"{name}.{out} disagrees with its plain version at "
                    f"S={s} D={d} causal={causal}: {val} > {tol}")
    if not timed:
        return None

    n_pairs = pairs(s, s, causal) * bh
    elem = bh * s * d
    work = {   # (operations, bytes): each input read once, output written once
        "flash_fwd": (4 * d * n_pairs, 4 * elem * 2 + bh * s * 4),
        "flash_dkv": (8 * d * n_pairs, 6 * elem * 2 + 2 * bh * s * 4),
        "flash_dq": (6 * d * n_pairs, 5 * elem * 2 + 2 * bh * s * 4),
    }
    ms = {
        "flash_fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale,
                                                       causal)),
        "flash_dkv": time_ms(lambda: fa.flash_dkv_cuda(
            q, k, v, do, lse_ref, delta, scale, causal)),
        "flash_dq": time_ms(lambda: fa.flash_dq_cuda(
            q, k, v, do, lse_ref, delta, scale, causal)),
    }
    plain_fwd = time_ms(lambda: fa.flash_fwd_reference(q, k, v, scale,
                                                       causal))
    plain_bwd = time_ms(lambda: fa.flash_bwd_reference(
        q, k, v, do, lse_ref, delta, scale, causal))
    plain = {"flash_fwd": plain_fwd, "flash_dkv": plain_bwd,
             "flash_dq": plain_bwd}

    # Yardstick only: PyTorch's fused attention on the same inputs. Its
    # backward is one call computing dQ, dK and dV together, so it stands
    # beside both backward kernels.
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q4, k4, v4, is_causal=causal))
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4))
    out = sdpa(qg, kg, vg, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do4, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_dkv": lib_bwd,
               "flash_dq": lib_bwd}

    rows = {}
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        ops, nbytes = work[name]
        b_ms, b_by = bound(ops, nbytes)
        rows[name] = {"ms": ms[name], "plain_ms": plain[name],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library[name],
                      "max_abs_err": absmax[name],
                      "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
        log(f"  {name}: {json.dumps(rows[name])}")
    return rows


def parity(hvd_tfm, fa):
    """Small model, flash kernels vs plain attention on the card."""
    cfg_kw = dict(vocab=512, d_model=256, n_layers=2, d_ff=512,
                  max_seq=1024, dtype=torch.bfloat16, remat=False)
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
    log(f"  parity: loss flash {lf:.6f} plain {lp:.6f} rel {loss_err:.3e}; "
        f"max grad rel err {grad_err:.3e}")
    if not (math.isfinite(lf) and loss_err <= 1e-2 and grad_err <= 5e-2):
        raise AssertionError("flash model disagrees with plain attention "
                             f"(loss {loss_err}, grads {grad_err})")


def profile_steps(step, model, opt, tokens, targets, path, n=2):
    """Device time by kernel over ``n`` train steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(model, opt, tokens, targets)
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
    with open(path, "w") as f:
        f.write(f"per step: wall {wall * 1e3:.3f} ms, device kernels "
                f"{busy:.3f} ms\n")
        for key, ms, cnt in dev:
            f.write(f"{ms:10.3f} ms  {cnt:6d}x  {key}\n")
    flash = sum(ms for key, ms, _ in dev if "flash_" in key)
    log(f"  profile: wall {wall * 1e3:.2f} ms/step, device busy "
        f"{busy:.2f} ms ({busy / (wall * 1e3):.1%}), flash kernels "
        f"{flash:.2f} ms; top: " + "; ".join(
            f"{key[:60]} {ms:.2f} ms" for key, ms, _ in dev[:6]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="after the main path, profile 2 more steps and "
                         "write the kernel table to PATH")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.train import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)")

    # 3. kernels vs plain
    log("kernels vs plain (tolerance: rel "
        f"{REL_TOL} on O/dQ/dK/dV, abs {LSE_TOL} on lse):")
    rows = check_kernels(fa, 8, 6, 2048, 128, True, timed=True)
    check_kernels(fa, 2, 6, 1000, 128, True, timed=False)
    check_kernels(fa, 2, 4, 512, 64, False, timed=False)

    # 4. parity of the model on the kernels
    parity(tfm, fa)

    # 5. main path
    hvd.init()
    if hvd.size() != 1 or hvd.get_topology().backend != "nccl":
        raise AssertionError(f"expected NCCL at world size 1, got "
                             f"{hvd.get_topology()}")
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
    b, s = 8, 2048
    tok = torch.randint(0, cfg.vocab, (b, s + 1),
                        generator=torch.Generator().manual_seed(1))
    tokens, targets = tok[:, :-1].cuda(), tok[:, 1:].cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = fa.launch_counts()
    per_step = cfg.n_layers * STEPS
    log(f"main path: {n_params} params, losses {losses}")
    log(f"  step seconds {times}")
    steady = statistics.median(times[1:])
    log(f"  {b * s / steady:.1f} tok/s (median of steps 2-{STEPS}, "
        f"{steady * 1e3:.2f} ms/step) on {smi}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  model FLOPs 6*N*tokens = {6 * n_params * b * s / 1e12:.3f} "
        f"TFLOP/step: {6 * n_params * b * s / steady / 1e12:.1f} TFLOP/s, "
        f"{6 * n_params * b * s / steady / PEAK_BF16_FLOPS:.2%} of the "
        "bf16 peak (attention not counted)")
    log(f"  launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, n in launches.items():
        if n != per_step:
            raise AssertionError(
                f"{name} launched {n} times in {STEPS} steps, "
                f"expected {per_step}")
    if args.profile:
        profile_steps(step, model, opt, tokens, targets, args.profile)
    hvd.shutdown()

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in rows.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
