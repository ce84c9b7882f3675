"""K3's loop order: the dQ product left running under the next tile's
S and dP batch, against waiting for it every tile, each with the ring
two and three tiles ahead.

    python -m horovod_tpu_torch.experiments.flash_dq_order

Builds ``ops/csrc/flash_attention.cu`` once per variant of the bodies
in ``flash_attention.cuh`` (in a temporary directory, with the build's
nvcc flags), holds each variant's dQ to the
plain version at the flagship LM's attention (BH=48, S=2048, D=128,
causal; 2e-2 of max |plain|), then times K3 back-to-back there in
rounds, the variants in turn and in reverse turn:

- ``overlap``: the source as it is (four-stage ring, two tiles ahead;
  tile j's dQ product retired by the wait on tile j+1's S and dP);
- ``overlap_lead3``: the same order on a five-stage ring, three tiles
  ahead (a stage may be refilled only after its dQ product retired);
- ``wait_each_tile``: a wait right after each dQ product, on a
  four-stage ring three tiles ahead (K1's and K2's ring and order);
- ``wait_lead2``: a wait right after each dQ product, two tiles ahead.

Prints the card's ``nvidia-smi`` line, then one JSON line per variant
with its ms in each turn, its error against the plain version and
ptxas's registers. Each variant must find its
pieces in the source exactly once, or the script stops: a change to
K3's loop brings ``VARIANTS`` along.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import tempfile
from pathlib import Path

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from . import device_line, require_cuda, time_ms
from .flash_fwd_split import (cut_source, nvcc_shared, registers,
                              variant_source)

STAGES_4 = "constexpr int kDqStages = 4;"
LEAD_2 = "constexpr int kDqLead = 2;"
LEAD_3 = "constexpr int kDqLead = 3;"
DQ_COMMIT = """        wgmma_rs<D, InT>(dqa, dsa[c], desc_mnmajor<kDqCols>(sK, c));
      }
      wgmma_commit();
    }"""
DQ_WAIT = """        wgmma_rs<D, InT>(dqa, dsa[c], desc_mnmajor<kDqCols>(sK, c));
      }
      wgmma_commit();
      wgmma_wait<0>();
    }"""
VARIANTS = {
    "overlap": [],
    "overlap_lead3": [(STAGES_4, "constexpr int kDqStages = 5;"),
                      (LEAD_2, LEAD_3)],
    "wait_each_tile": [(LEAD_2, LEAD_3), (DQ_COMMIT, DQ_WAIT)],
    "wait_lead2": [(DQ_COMMIT, DQ_WAIT)],
}
BH, S, D = 48, 2048, 128
REL_TOL = 2e-2


def run(tmp: Path, rounds=2):
    """{variant: {"ms": [per turn], "registers": n, "rel_err": x}}."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (_build.CSRC / "flash_attention.cuh").read_text()
    pairs = [(variant_source(tmp, name, cut_source(text, name, VARIANTS)),
              tmp / f"{name}.so") for name in VARIANTS]
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(BH, S, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_reference(q, k, v, do, lse, delta, scale, True)[0]
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    calls, out = {}, {}
    for name, (_, so), report in zip(VARIANTS, pairs, nvcc_shared(pairs)):
        lib = ctypes.CDLL(str(so))
        lib.hvd_flash_dq.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, F,
                                     I, P]

        def call(lib=lib, name=name):
            err = lib.hvd_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dq.data_ptr(), BH, S, S,
                                   D, fa._qscale(scale), scale, 1, stream)
            if err:
                raise RuntimeError(f"flash_dq ({name}): CUDA error {err}")
        call()
        torch.cuda.synchronize()
        rel = float((dq.float() - want.float()).abs().max()
                    / want.float().abs().max())
        if not rel <= REL_TOL:
            raise AssertionError(f"{name}: dQ off its plain version by "
                                 f"{rel} > {REL_TOL}")
        calls[name] = call
        out[name] = {"ms": [], "registers": registers(report,
                                                      "flash_dq_kernel"),
                     "rel_err": rel}
    for turn in range(2 * rounds):
        order = list(calls) if turn % 2 == 0 else list(calls)[::-1]
        for name in order:
            out[name]["ms"].append(time_ms(calls[name]))
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("flash_dq_order")
    print(device_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, r in run(Path(tmp)).items():
            print(json.dumps({"variant": name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
