"""The fp32 flash kernels' error by shape, against fp64.

    python -m horovod_tpu_torch.experiments.fp32_flash_errors

K1 on fp32 operands (``flash_fwd_cuda`` with float32 ``[3, S, D]``
inputs, seeded N(0, 1)) at head dims 4-640 and at the shapes of the
smoke's sweeps plus S = 2048 causal and not, each held to the plain
version in fp64. Prints the card's ``nvidia-smi`` line, then the 25
worst shapes as (max |kernel - plain fp32| / max |plain fp32|, max
|kernel - fp64| / max |fp64|, the same of the plain fp32 version, the
mean signed error along the sign of the fp64 output over max |fp64|
(below 0: the kernel leans toward zero), lse's max error over max |fp64
lse|, D, causal, sq, sk). Then K2 and K3 (``flash_dkv_cuda``,
``flash_dq_cuda``) at S = 2048 not causal, D = 128 and 512: dq, dk, dv
against fp64 (lse and delta from the fp64 forward), beside the plain
fp32 version's. Needs one card.
"""

from __future__ import annotations

import torch

from . import device_line, require_cuda
from ..ops import _build, flash_attention as fa

DIMS = (4, 16, 48, 128, 160, 256, 264, 384, 512, 640)
SHAPES = ((True, 200, 200), (False, 130, 250), (True, 257, 70),
          (True, 64, 64), (False, 1, 33), (True, 129, 129),
          (False, 300, 64), (False, 2048, 2048), (True, 2048, 2048))
BWD_DIMS = (128, 512)
SHOWN = 25


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def forward_errors():
    rows = []
    for d in DIMS:
        for causal, sq, sk in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
            q = torch.randn(3, sq, d, generator=g, device="cuda")
            k, v = (torch.randn(3, sk, d, generator=g, device="cuda")
                    for _ in range(2))
            scale = d ** -0.5
            o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
            o64, lse64 = fa.flash_fwd_reference(
                q.double(), k.double(), v.double(), scale, causal)
            o32, _ = fa.flash_fwd_reference(q, k, v, scale, causal)
            lean = float(((o.double() - o64) * o64.sign()).mean()
                         / o64.abs().max())
            rows.append((_rel(o, o32), _rel(o, o64), _rel(o32, o64), lean,
                         _rel(lse, lse64), d, causal, sq, sk))
    return sorted(rows, reverse=True)


def backward_errors(d: int):
    g = torch.Generator(device="cuda").manual_seed(99 + d)
    q, k, v, do = (torch.randn(3, 2048, d, generator=g, device="cuda")
                   for _ in range(4))
    scale = d ** -0.5
    o64, lse64 = fa.flash_fwd_reference(q.double(), k.double(), v.double(),
                                        scale, False)
    delta64 = (do.double() * o64).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q.double(), k.double(), v.double(),
                                  do.double(), lse64, delta64, scale, False)
    lse, delta = lse64.float(), delta64.float()
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, scale, False)
    dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, scale, False)
    plain = fa.flash_bwd_reference(q, k, v, do, lse, delta, scale, False)
    return ([_rel(a, w) for a, w in zip((dq, dk, dv), want)],
            [_rel(a, w) for a, w in zip(plain, want)])


def main() -> int:
    require_cuda("fp32_flash_errors")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_line(), flush=True)
    _build.library()
    print("(vs plain fp32, vs fp64, plain fp32 vs fp64, lean toward |o|, "
          "lse vs fp64, D, causal, sq, sk)")
    for row in forward_errors()[:SHOWN]:
        print(tuple(round(x, 10) if isinstance(x, float) else x
                    for x in row), flush=True)
    print("K2/K3 at S=2048 not causal, of max |fp64|: kernels (dq, dk, dv); "
          "plain fp32")
    for d in BWD_DIMS:
        print(d, *backward_errors(d), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
