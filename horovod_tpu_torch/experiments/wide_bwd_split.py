"""Where the 16-bit ``_wide`` backward's time goes: K2 and K3 with one part
cut out.

    python -m horovod_tpu_torch.experiments.wide_bwd_split [--rounds 2]
        [--cuts CUT ...] [--shape B,H,SQ,SK,D,CAUSAL]

Builds ``ops/csrc/flash_attention.cu`` (the bf16 forms) once as it is
and once per cut of ``flash_bwd_wide_body`` in ``flash_attention.cuh``
(in a temporary directory, with the build's nvcc flags, all at once)
and times the bf16 ``_wide`` K2 (dK, dV) and K3 (dQ) back-to-back at
B=8, H=3, S=2048, D=512, causal (or at ``--shape``), in rounds. The cuts
change ``flash_bwd_wide_body``, which K2 runs at D = 512 only (at other
head dims the launcher takes K2's one-chunk form, which no cut touches):

- ``no_s``: the S (K2: S^T) partial batches left out (S keeps what it
  held);
- ``no_dp``: the dP (dP^T) partial batches left out;
- ``no_rs``: the RS products left out (K3 dQ += dS K; K2 dV += P^T dO
  and dK += dS^T Qs);
- ``no_exchange``: the stores and loads of the partials left out (the
  barriers stay);
- ``no_exp2``: exp2f replaced by its argument;
- ``half_loads``: every TMA copy moves one of a chunk's two 64-column
  blocks, so half the bytes come through L2;
- ``loads_only``: all of ``no_s``, ``no_dp``, ``no_rs``, ``no_exchange``
  and ``no_exp2``: the rings, their waits, the q-scale passes and the
  barriers alone;
- ``loads_only_half``: ``loads_only`` with ``half_loads``: whether the
  rings wait on the bytes or on the copies' latency;
- ``no_copies``: ``loads_only`` with no ring copy issued and no wait
  for one (the resident operands still land once): the loop's barriers,
  mbarrier round trips, wgmma commits and q-scale passes alone;
- ``no_scale``: K2's q-scale pass over each streamed Qs chunk left out;
- ``head_major``: block x runs a head's row tiles first, then the heads
  (instead of the heads fastest);
- ``k2_wide_everywhere``: the launcher takes this body for K2 at every
  head dim it serves, those up to 512 (its operands resident; above 512
  it has no K2 path), not only at 512 (the launcher's refusal of K2 at
  other head dims is lifted to match): against ``base`` at ``--shape``
  ...,384,... it times the body against K2's one-chunk form there.

A cut variant computes nothing useful and is only timed. ptxas's
registers of both kernels are printed beside each, and whether ptxas
serialized a kernel's wgmma pipeline (its note C7515). Each cut must find
its piece in the source exactly once, or the script stops: a change to
the body has to bring ``CUTS`` along. Prints the card's ``nvidia-smi``
line, then one JSON line per cut. Needs one card.
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
from .flash_fwd_split import cut_source, nvcc_shared, variant_source
from .wide_fwd_split import registers

SS_BATCH = """      wgmma_ss<kT, InT>(a, desc_kmajor<64>(xa, 0, kk),
                        desc_kmajor<kT>(ya, 0, kk), i | kk);"""
DQ_BATCH = """        wgmma_rs<kWide, InT>(acc[i], fa[cc],
                             desc_mnmajor<kT>(i ? ya1 : ya0, cc));"""
DV_BATCH = """        wgmma_rs<kWide, InT>(acc[1], fa[cc], desc_mnmajor<kT>(yb, cc));"""
DK_BATCH = """        wgmma_rs<kWide, InT>(acc[0], fb[cc], desc_mnmajor<kT>(ya0, cc));"""
X_STORE = """      x[((w * 2) * 4 + j) * 128 + tid] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      x[((w * 2 + 1) * 4 + j) * 128 + tid] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);"""
X_LOAD = """      const float4 y = x[(((1 - w) * 2) * 4 + j) * 128 + tid];
      s[j][0] += y.x;
      s[j][1] += y.y;
      s[j][2] += y.z;
      s[j][3] += y.w;
      const float4 z = x[(((1 - w) * 2 + 1) * 4 + j) * 128 + tid];
      dp[j][0] += z.x;
      dp[j][1] += z.y;
      dp[j][2] += z.z;
      dp[j][3] += z.w;"""
EXP2_DQ = """      const bool edge = k0 + kT > sk || (causal && k0 + kT - 1 > r0);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], kLog2e, -lse2[e >> 1]));"""
EXP2_DKV = """          float p = exp2f(fmaf(s[j][e], kLog2e, -st[qc]));"""
BOX = "const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 2, 1};"
EXPECT_X = """      mbar_expect_tx(full, kChunkTile);
      load(dst, R.j ? tx2 : tx1, chunk(p / 2), r0, full);"""
EXPECT_Y = """      mbar_expect_tx(full, kBwdHalfTile);"""
EXPECT_RES = """      mbar_expect_tx(bars, 2 * L.nr * kChunkTile);"""
ACQUIRE_WAIT = """    mbar_wait(R.full + 8 * R.rd, R.ph);"""
LOAD_Y = """      load(dst, R.j ? ty2 : ty1, c, tile * kT, full);"""
SCALE = """    scale_words<InT>(smem + (a - base), bytes / 16, tid, 128, qscale);
    fence_proxy_async();
    bar_sync(4 + w, 128);"""
ORDER = """  const int bh = blk % n_bh;
  blk /= n_bh;
  const int r0 = (DKV ? blk % n_rt : n_rt - 1 - blk % n_rt) * kBwdWideRows;
  const int c0 = blk / n_rt * kG;"""
HEAD_MAJOR = """  const int r0 = (DKV ? blk % n_rt : n_rt - 1 - blk % n_rt) * kBwdWideRows;
  blk /= n_rt;
  const int bh = blk % n_bh, c0 = blk / n_bh * kG;"""
DISPATCH = """  if (d != 4 * kWide) {  // one chunk a CTA, grid z the chunks"""
REFUSAL = """  if (DKV && d != 4 * kWide) return cudaErrorInvalidValue;"""


def _drop_exp2(piece: str) -> str:
    return piece.replace("exp2f(fmaf(", "(fmaf(")


COMPUTE = {
    "no_s": [(SS_BATCH, "      if (R.j) " + SS_BATCH.lstrip())],
    "no_dp": [(SS_BATCH, "      if (!R.j) " + SS_BATCH.lstrip())],
    "no_rs": [(DQ_BATCH, ""), (DV_BATCH, ""), (DK_BATCH, "")],
    "no_exchange": [(X_STORE, ""), (X_LOAD, "")],
    "no_exp2": [(EXP2_DQ, _drop_exp2(EXP2_DQ)),
                (EXP2_DKV, _drop_exp2(EXP2_DKV))],
}
HALF = [(BOX, BOX.replace("2, 1}", "1, 1}")),
        (EXPECT_X, EXPECT_X.replace("kChunkTile);", "kChunkTile / 2);")),
        (EXPECT_Y, EXPECT_Y.replace("kBwdHalfTile);", "kBwdHalfTile / 2);")),
        (EXPECT_RES, EXPECT_RES.replace("2 * L.nr", "L.nr"))]
LOADS_ONLY = [(SS_BATCH, "")] + [piece for cut in ("no_rs", "no_exchange",
                                                   "no_exp2")
                                 for piece in COMPUTE[cut]]
CUTS = {
    "base": [],
    **COMPUTE,
    "half_loads": HALF,
    "loads_only": LOADS_ONLY,
    "loads_only_half": LOADS_ONLY + HALF,
    "no_copies": LOADS_ONLY + [(EXPECT_X, ""), (EXPECT_Y, ""), (LOAD_Y, ""),
                               (ACQUIRE_WAIT, "")],
    "no_scale": [(SCALE, "")],
    "head_major": [(ORDER, HEAD_MAJOR)],
    "k2_wide_everywhere": [(piece, piece.replace("d != 4 * kWide",
                                                  "d > 4 * kWide"))
                           for piece in (DISPATCH, REFUSAL)],
}
SHAPE = (8, 3, 2048, 2048, 512, 1)   # B, H, SQ, SK, D, causal


def serialized(report: str, kernel: str) -> bool:
    """Whether ptxas serialized the wgmma pipeline of ``kernel``."""
    return any("C7515" in line and kernel in line
               for line in report.splitlines())


def split(tmp: Path, rounds: int, cuts=tuple(CUTS), shape=SHAPE) -> dict:
    """{cut: {"dkv_ms": [per round], "dq_ms": [...], "registers": {...}}}
    of the named cuts."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (_build.CSRC / "flash_attention.cuh").read_text()
    pairs = [(variant_source(tmp, cut, cut_source(text, cut, CUTS)),
              tmp / f"{cut}.so") for cut in cuts]
    libs, out = {}, {}
    for cut, (_, so), report in zip(cuts, pairs, nvcc_shared(pairs)):
        lib = ctypes.CDLL(str(so))
        lib.hvd_flash_dkv.argtypes = [P] * 8 + [I] * 4 + [F, I, P]
        lib.hvd_flash_dq.argtypes = [P] * 7 + [I] * 4 + [F, F, I, P]
        libs[cut] = lib
        out[cut] = {"dkv_ms": [], "dq_ms": [], "registers": {
            k: registers(report, f"flash_{k}_wide_kernel")
            for k in ("dkv", "dq")}, "serialized": {
            k: serialized(report, f"flash_{k}_wide_kernel")
            for k in ("dkv", "dq")}}
    b, h, sq, sk, d, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, do = (torch.randn(b * h, sq, d, generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b * h, sk, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_fwd_reference(q, k, v, d ** -0.5, bool(causal))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    del o
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    qscale = fa._qscale(d ** -0.5)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
    for _ in range(rounds):
        for cut, lib in libs.items():
            def dkv(lib=lib, cut=cut):
                err = lib.hvd_flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                        b * h, sq, sk, d, qscale, causal,
                                        stream)
                if err:
                    raise RuntimeError(f"flash_dkv ({cut}): CUDA error {err}")

            def dq_(lib=lib, cut=cut):
                err = lib.hvd_flash_dq(*ptrs, dq.data_ptr(), b * h, sq, sk, d,
                                       qscale, d ** -0.5, causal, stream)
                if err:
                    raise RuntimeError(f"flash_dq ({cut}): CUDA error {err}")
            out[cut]["dkv_ms"].append(time_ms(dkv))
            out[cut]["dq_ms"].append(time_ms(dq_))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cuts", nargs="+", choices=list(CUTS),
                    default=list(CUTS), help="the cuts to build and time")
    ap.add_argument("--shape", type=lambda t: tuple(map(int, t.split(","))),
                    default=SHAPE, help="B,H,SQ,SK,D,CAUSAL")
    args = ap.parse_args(argv)
    require_cuda("wide_bwd_split")
    print(device_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for cut, r in split(Path(tmp), args.rounds, args.cuts,
                            args.shape).items():
            print(json.dumps({"cut": cut, "shape": list(args.shape), **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
