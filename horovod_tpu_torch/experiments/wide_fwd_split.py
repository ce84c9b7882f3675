"""Where the 16-bit ``_wide`` forward's time goes: its body with one part
cut out.

    python -m horovod_tpu_torch.experiments.wide_fwd_split [--rounds 2]
        [--cuts CUT ...] [--shape B,H,SQ,SK,D,CAUSAL]

Builds ``ops/csrc/flash_attention.cu`` (the bf16 forms) once as it is
and once per cut of ``flash_fwd_wide_body`` in ``flash_attention.cuh``
(in a temporary directory, with the build's nvcc flags, all at once)
and times the bf16 ``_wide`` forward back-to-back at B=8, H=3, S=2048,
D=512, causal (or at ``--shape``), in rounds:

- ``no_s``: the S = Qs K^T batches left out (S keeps what it held);
- ``no_pv``: the O += P V batches left out;
- ``no_exchange``: the stores and loads of the two partial S left out
  (the barriers stay);
- ``no_exp2``: exp2f replaced by its argument;
- ``half_loads``: every TMA copy moves one of a chunk's two 64-column
  blocks, so half the bytes come through L2 (the other half of each slot
  keeps what it held);
- ``loads_only``: all of ``no_s``, ``no_pv``, ``no_exchange`` and
  ``no_exp2``: the rings, their waits and the barriers alone;
- ``loads_only_half``: ``loads_only`` with ``half_loads``: whether the
  rings wait on the bytes (half the time) or on the copies' latency
  (the same time);
- ``loads_only_nobar``: ``loads_only`` without the named barriers that
  couple the two warpgroups each tile: the rings alone;
- ``head_major``: block x runs a head's q tiles first (heaviest first),
  then the heads, so that the CTAs in flight share ~4 heads' K and V in
  L2, instead of the heads fastest.

A cut variant computes nothing useful and is only timed. ptxas's
registers of the kernel are printed beside each. Each cut must find its
piece in the source exactly once, or the script stops: a change to the
body has to bring ``CUTS`` along. Prints the card's ``nvidia-smi`` line,
then one JSON line per cut. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import tempfile
from pathlib import Path

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from . import device_line, require_cuda, time_ms
from .flash_fwd_split import cut_source, nvcc_shared, variant_source

S_BATCH = """        wgmma_ss<kFwdWideKeys, InT>(s, desc_kmajor<64>(qa, 0, kk),
                                    desc_kmajor<64>(ka, 0, kk), i | kk);"""
PV_BATCH = """        wgmma_rs<kWide, InT>(acc[i], pa[cc], desc_mnmajor<kFwdWideKeys>(va[i], cc));"""
X_STORE = """      x[(w * 8 + j) * 128 + tid] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);"""
X_LOAD = """      const float4 y = x[((1 - w) * 8 + j) * 128 + tid];
      s[j][0] += y.x;
      s[j][1] += y.y;
      s[j][2] += y.z;
      s[j][3] += y.w;"""
EXP2 = """        float p = exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
        if (edge && !valid_pair(row[e >> 1], k0 + j * 8 + t * 2 + (e & 1),
                                sq, sk, causal)) {
          p = 0.f;
        }
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    uint32_t pa[kFwdWideKeys / 16][4];"""
BOX = "const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 2, 1};"
EXPECT_K = """    const uint32_t full = k_full + 8 * s, dst = k_slots + s * kChunkTile;
    mbar_expect_tx(full, kChunkTile);"""
EXPECT_V = """    const uint32_t full = v_full + 8 * s;
    mbar_expect_tx(full, kChunkTile);"""
EXPECT_Q = """      mbar_expect_tx(bars, L.nq * kChunkTile);"""
BAR_RD_SYNC = """    if (kt > 0) bar_sync(2 + w, 256);
"""
BAR_X = """    bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < kFwdWideKeys / 8; ++j) {
"""
BAR_RD_ARRIVE = """    if (kt + 1 < n_kt) bar_arrive(3 - w, 256);
"""
ORDER = """  const int bh = blk % n_bh;
  blk /= n_bh;
  const int q0 = (n_qt - 1 - blk % n_qt) * kFwdWideRows;
  const int c0 = blk / n_qt * kFwdWideGroup;"""
HEAD_MAJOR = """  const int q0 = (n_qt - 1 - blk % n_qt) * kFwdWideRows;
  blk /= n_qt;
  const int bh = blk % n_bh, c0 = blk / n_bh * kFwdWideGroup;"""

COMPUTE = {
    "no_s": [(S_BATCH, "")],
    "no_pv": [(PV_BATCH, "")],
    "no_exchange": [(X_STORE, ""), (X_LOAD, "")],
    "no_exp2": [(EXP2, EXP2.replace(
        "exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]))",
        "fmaf(s[j][e], kLog2e, -mb[e >> 1])"))],
}
HALF = [(BOX, BOX.replace("2, 1}", "1, 1}")),
        *((old, old.replace("kChunkTile);", "kChunkTile / 2);"))
          for old in (EXPECT_K, EXPECT_V, EXPECT_Q))]
LOADS_ONLY = [piece for cut in COMPUTE.values() for piece in cut]
CUTS = {
    "base": [],
    **COMPUTE,
    "half_loads": HALF,
    "loads_only": LOADS_ONLY,
    "loads_only_half": LOADS_ONLY + HALF,
    "loads_only_nobar": LOADS_ONLY + [
        (BAR_RD_SYNC, ""), (BAR_RD_ARRIVE, ""),
        (BAR_X, BAR_X.replace("    bar_sync(1, 256);\n", ""))],
    "head_major": [(ORDER, HEAD_MAJOR)],
}
SHAPE = (8, 3, 2048, 2048, 512, 1)   # B, H, SQ, SK, D, causal


def registers(report: str, kernel: str = "flash_fwd_wide_kernel") -> int:
    """ptxas's registers of the bf16 form of ``kernel``."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    return int(m.group(1))
    raise ValueError(f"no register count for {kernel}")


def split(tmp: Path, rounds: int, cuts=tuple(CUTS), shape=SHAPE) -> dict:
    """{cut: {"ms": [per round], "registers": n}} of the named cuts."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (_build.CSRC / "flash_attention.cuh").read_text()
    pairs = [(variant_source(tmp, cut, cut_source(text, cut, CUTS)),
              tmp / f"{cut}.so") for cut in cuts]
    libs, out = {}, {}
    for cut, (_, so), report in zip(cuts, pairs, nvcc_shared(pairs)):
        lib = ctypes.CDLL(str(so))
        lib.hvd_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, F, I, P]
        libs[cut] = lib
        out[cut] = {"ms": [], "registers": registers(report)}
    b, h, sq, sk, d, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(b * h, n, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for n in (sq, sk, sk))
    o = torch.empty_like(q)
    lse = torch.empty(b * h, sq, 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    qscale = fa._qscale(d ** -0.5)
    for _ in range(rounds):
        for cut, lib in libs.items():
            def call(lib=lib, cut=cut):
                err = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(),
                                        lse.data_ptr(), b * h, sq, sk, d,
                                        qscale, causal, stream)
                if err:
                    raise RuntimeError(f"flash_fwd ({cut}): CUDA error {err}")
            out[cut]["ms"].append(time_ms(call))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cuts", nargs="+", choices=list(CUTS),
                    default=list(CUTS), help="the cuts to build and time")
    ap.add_argument("--shape", type=lambda t: tuple(map(int, t.split(","))),
                    default=SHAPE, help="B,H,SQ,SK,D,CAUSAL")
    args = ap.parse_args(argv)
    require_cuda("wide_fwd_split")
    print(device_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for cut, r in split(Path(tmp), args.rounds, args.cuts,
                            args.shape).items():
            print(json.dumps({"cut": cut, "shape": list(args.shape), **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
