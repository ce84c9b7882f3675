"""Where K1's time goes: its loop body with one part cut out, and the
rate of each wgmma form alone.

    python -m horovod_tpu_torch.experiments.flash_fwd_split

Part 1 builds ``ops/csrc/flash_attention.cu`` once as it is and once
per cut (in a temporary directory, with the build's nvcc flags) and
times K1 back-to-back at the flagship LM's attention (BH=48, S=2048,
D=128, causal), in two rounds:

- ``no_qk``: the S = Qs K^T product left out (S stays 0);
- ``no_pv``: the O += P V product left out;
- ``no_exp2``: exp2f replaced by its argument;
- ``no_ring_wait``: the ring's cp.async wait and proxy fence left out
  (the barrier stays; tiles are read whether or not they have landed).

A cut variant computes nothing useful and is only timed. ptxas's
register count is printed beside each, since a cut that frees registers
can let two CTAs share an SM. Each cut must find its piece in the
source exactly once, or the script stops: a change to K1's loop has to
bring ``CUTS`` along. Part 2 times each wgmma form of
``hopper_tile.cuh`` alone (``ops/csrc/wgmma_rate.cu``, built with the
package's kernels): one CTA of two warpgroups per SM, each looping over
a 64-deep product (4 k-steps of m64n128k16, or 8 of m64n64k16 at D=128)
from fixed tiles, waiting after each batch; TFLOP/s against the 989 of
the bf16 peak.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from . import PEAK_BF16_FLOPS, device_line, require_cuda, time_ms

S_PRODUCT = """    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kFwdCols>(s, desc_kmajor<kFwdRows>(sQ, wg * 64, kk),
                         desc_kmajor<kFwdCols>(sK, 0, kk), kk);
    }"""
PV_PRODUCT = """    for (int c = 0; c < kFwdCols / 16; ++c) {
      wgmma_rs<D>(acc, pa[c], desc_mnmajor<kFwdCols>(sV, c));
    }"""
EXP2 = "float p = exp2f(fmaf(s[j][e], kLog2e, -mb[e >> 1]));"
RING_WAIT = """    cp_async_wait<kFwdStages - 2>();
    fence_proxy_async();
    __syncthreads();"""
CUTS = {
    "base": [],
    "no_qk": [(S_PRODUCT, "    {}")],
    "no_pv": [(PV_PRODUCT, "    {}")],
    "no_exp2": [(EXP2, "float p = fmaf(s[j][e], kLog2e, -mb[e >> 1]);")],
    "no_ring_wait": [(RING_WAIT, "    __syncthreads();")],
}

RATE_MODES = ("RS m64n128k16, B MN-major (P V)",
              "RS m64n128k16, B K-major",
              "SS m64n64k16, B K-major (Qs K^T)",
              "SS m64n128k16, B K-major")


def cut_source(text: str, cut: str, cuts=CUTS) -> str:
    """flash_attention.cu with one of ``cuts`` applied; each piece it
    cuts must occur exactly once."""
    for old, new in cuts[cut]:
        if text.count(old) != 1:
            raise ValueError(f"{cut}: the piece to cut is not in the source "
                             "exactly once")
        text = text.replace(old, new)
    return text


def nvcc_shared(pairs):
    """Build each (source, library) pair as a shared library, all at
    once; returns ptxas's report of each."""
    procs = [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-I", str(_build.CSRC), "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, lib in pairs]
    reports = []
    for (src, _), proc in zip(pairs, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{err}")
        reports.append(err)
    return reports


def registers(report: str, kernel: str = "flash_fwd_kernel") -> int:
    """ptxas's registers of ``kernel``<128>."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if ("Function properties for" in line
                and f"{kernel}ILi128" in line):
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    return int(m.group(1))
    raise ValueError(f"no register count for {kernel}<128>")


def split(tmp: Path, rounds=2):
    """{cut: {"ms": [per round], "registers": n}}."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (_build.CSRC / "flash_attention.cu").read_text()
    pairs = []
    for cut in CUTS:
        (tmp / f"{cut}.cu").write_text(cut_source(text, cut))
        pairs.append((tmp / f"{cut}.cu", tmp / f"{cut}.so"))
    libs, out = {}, {}
    for cut, (_, so), report in zip(CUTS, pairs, nvcc_shared(pairs)):
        lib = ctypes.CDLL(str(so))
        lib.hvd_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, F, I, P]
        libs[cut] = lib
        out[cut] = {"ms": [], "registers": registers(report)}
    bh, s, d = 48, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    qscale = fa._qscale(d ** -0.5)
    for _ in range(rounds):
        for cut, lib in libs.items():
            def call(lib=lib):
                err = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(),
                                        lse.data_ptr(), bh, s, s, d, qscale,
                                        1, stream)
                if err:
                    raise RuntimeError(f"flash_fwd ({cut}): CUDA error {err}")
            out[cut]["ms"].append(time_ms(call))
    return out


def rates(iters=2000):
    """{form: TFLOP/s} of each wgmma form alone (``ops/csrc/wgmma_rate.cu``),
    one CTA per SM."""
    lib = _build.library()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flops = blocks * 2 * iters * 2 * 64 * 128 * 64   # 2 warpgroups per CTA
    result = {}
    for mode, name in enumerate(RATE_MODES):
        for n in (10, iters):   # a short warm-up launch, then the timed one
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.hvd_wgmma_rate(mode, out.data_ptr(), n, blocks, stream)
            b.record()
            b.synchronize()
            if err:
                raise RuntimeError(f"wgmma rate ({name}): CUDA error {err}")
        result[name] = flops / a.elapsed_time(b) / 1e9
    return result


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("flash_fwd_split")
    print(device_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for cut, r in split(Path(tmp)).items():
            print(json.dumps({"cut": cut, **r}), flush=True)
    for name, tflops in rates().items():
        print(json.dumps({"wgmma": name, "tflops": tflops,
                          "of_peak": tflops * 1e12 / PEAK_BF16_FLOPS}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
