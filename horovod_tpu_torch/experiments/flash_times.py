"""K1-K3 and PyTorch's fused attention at the flagship, timed two ways.

    python -m horovod_tpu_torch.experiments.flash_times

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per kernel: ``single_ms`` (median of single calls, each between two
CUDA events, so it carries one launch gap: ``experiments.single_ms``)
and ``b2b_ms`` (mean over back-to-back launches between two events,
``experiments.time_ms``).
The kernels are the flash forward (K1), dK/dV (K2) and dQ (K3) of
``ops.flash_attention``; the yardsticks are
``scaled_dot_product_attention`` forward and its backward (one call for
dQ, dK and dV), which the port never calls. Inputs are seeded N(0, 1)
bf16 ``[B*H, S, D]`` tensors at the flagship LM's attention (B=8, H=6,
S=2048, D=128, causal); lse and delta come from the plain forward. The
script only launches the package's public kernel wrappers,
so it times whichever tree's package it imports.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import flash_attention as fa
from . import device_line, require_cuda, single_ms, time_ms

B, H, S, D, CAUSAL = 8, 6, 2048, 128, True


def calls(q, k, v, do, b, h, causal):
    """{name: thunk} for K1-K3 and the two SDPA yardsticks."""
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    s, d = q.shape[1:]
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (q4, k4, v4))
    out = sdpa(qg, kg, vg, is_causal=causal)
    return {
        "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, causal),
        "flash_dkv": lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta,
                                               scale, causal),
        "flash_dq": lambda: fa.flash_dq_cuda(q, k, v, do, lse, delta, scale,
                                             causal),
        "sdpa_fwd": lambda: sdpa(q4, k4, v4, is_causal=causal),
        "sdpa_bwd": lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                retain_graph=True),
    }


def run():
    """{name: {"single_ms", "b2b_ms"}} at the flagship."""
    gen = torch.Generator(device="cuda").manual_seed(1234 + S + D)
    q, k, v, do = (torch.randn(B * H, S, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    return {name: {"single_ms": single_ms(fn), "b2b_ms": time_ms(fn)}
            for name, fn in calls(q, k, v, do, B, H, CAUSAL).items()}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("flash_times")
    print(device_line(), flush=True)
    for name, r in run().items():
        print(json.dumps({"name": name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
