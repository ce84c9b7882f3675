"""Where the probe map kernel's time goes: its ring with one part cut out,
other ring shapes, other work partitions, and the register-path design
beside it.

    python -m horovod_tpu_torch.experiments.probe_split [--rounds 2]
        [--cuts CUT ...]

Builds ``ops/csrc/probes.cu`` once as it is and once per cut (in a
temporary directory, with the build's nvcc flags, all at once) and
times the copy and the +1 map back-to-back (``experiments.time_ms``)
over every case of P1's and P2's map sweeps (14 geometries), beside
``y.copy_(x)`` and ``torch.add(x, 1)``, in rounds. The cuts:

- ``loads_only``: the bulk stores left out (the ring fills, nothing is
  written back); ``stores_only``: the bulk loads left out (each slot's
  barrier is arrived at at once; the stores write what the slot held);
- ``no_hint``: the copies without the L2 evict_first policy;
- ``lag_2``: a slot refilled once the store two groups back has read it;
- ``ring_6x16k`` (two CTAs an SM), ``ring_4x16k_3`` (three),
  ``ring_24x4k`` (two), ``ring_3x64k`` (one): other ring depths and
  stage sizes;
- ``per_tile_cta``: one CTA a tile, not persistent (the ring inside a
  tile), also with the rings ``_6x16k``, ``_4x16k_3`` and ``_8x16k``;
- ``flat``: a diagnostic that drops the tile geometry: the same ring, CTA
  b taking the 16 KB stages b, b + grid, ... of the whole matrix;
  ``flat_per_cta``: one CTA a 16 KB stage (both only timed);
- ``store_threads``: TMA loads into the ring, but the CTA's 256 threads
  store each stage from shared memory (``st.global.cs``, +1 on the way)
  and the slot is refilled as soon as they have read it;
- ``registers``: the register-path alternative instead of the ring: the
  parent's flat walk made persistent (min(tiles, k * SMs) CTAs of 256
  threads, k as many as an SM holds), eight 16-byte loads in flight a
  thread, ``ld.global.L1::no_allocate`` with an L2 evict_first policy,
  ``st.global.cs``; ``registers_per_cta``: the same walk with one CTA a
  tile; ``registers_flat`` and ``registers_flat_per_cta``: both over 16
  KB pieces of the whole matrix, without the tile geometry (only timed).

A cut that drops loads or stores or the tile geometry is only timed;
every other variant is first held to the plain versions (copy bit for
bit, +1 to the plain bits, NaN for NaN) on special values. ptxas's
registers of each variant's map kernels are printed beside it. Each cut
must find its piece in the source exactly once, or the script stops: a
change to the kernel has to bring ``CUTS`` along. Prints the card's
``nvidia-smi`` line, then one JSON line per cut. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import tempfile
from pathlib import Path

import torch

from ..ops import _build, probes
from . import (addone_matches, copy_matches, device_line, require_cuda,
               special_bf16, time_ms)
from .flash_fwd_split import cut_source, nvcc_shared
from .kernel_sass import ptxas_info
from .mem_probe import C as P2_C, COPY_BMS, M as P2_M, MAP_BMS
from .shape_probe import CASES as SHAPE_CASES, TOTAL

LOAD = """  mbar_expect_tx(bar, s.len());
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n" ::"r"(slot),
      "l"(x + s.at()), "r"(s.len()), "r"(bar), "l"(policy)
      : "memory");"""
STORE = """  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\\n" ::"l"(y + s.at()), "r"(slot), "r"(s.len()),
      "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");"""
STAGE_BYTES = "constexpr int kStageBytes = 16384;"
STAGES = "constexpr int kStages = 12;"
LAG = "constexpr int kStoreLag = 1;"
PER_SM = "constexpr int kMaxCtasPerSm = 2;"
TID = "  const int tid = threadIdx.x;\n"
GRID = "  cudaError_t err = map_grid(addone != 0, tiles, &grid);"
MOST = "  *grid = (int)(tiles < most ? tiles : most);"
REG_GRID = "  const int grid = (int)(tiles < most ? tiles : most);"
REG_TILES = "tiles = m / bm, tile_vecs = (int64_t)bm * c / 8;"
LAUNCH = """  const int64_t tiles = m / bm, tile_bytes = (int64_t)bm * c * 2;
  int grid = 0;
  cudaError_t err = map_grid(addone != 0, tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  if (addone) {
    probe_map_kernel<true><<<grid, kAddThreads, kRingBytes, s>>>(
        (const char*)x, (char*)y, tiles, tile_bytes);
  } else {
    probe_map_kernel<false><<<grid, kCopyThreads, kRingBytes, s>>>(
        (const char*)x, (char*)y, tiles, tile_bytes);
  }"""
BAD_ARGS = "bool bad_args(int m, int c, int bm) {"

# The register-path alternative, put in before bad_args.
REG_KERNEL = r"""constexpr int kRegThreads = 256;
constexpr int kRegUnroll = 8;   // 16-byte loads in flight per thread

__device__ __forceinline__ uint4 ld_stream(const uint4* p, uint64_t policy) {
  uint4 u;
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3},"
      " [%4], %5;\n"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p), "l"(policy));
  return u;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 u) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}

template <bool ADDONE>
__global__ void __launch_bounds__(kRegThreads)
probe_map_regs_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                      int64_t tiles, int64_t tile_vecs) {
  const uint64_t policy = evict_first_policy();
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint4* xt = x + t * tile_vecs;
    uint4* yt = y + t * tile_vecs;
    for (int64_t i0 = threadIdx.x; i0 < tile_vecs;
         i0 += (int64_t)kRegUnroll * kRegThreads) {
      uint4 u[kRegUnroll];
#pragma unroll
      for (int j = 0; j < kRegUnroll; ++j) {
        const int64_t i = i0 + (int64_t)j * kRegThreads;
        if (i < tile_vecs) u[j] = ld_stream(xt + i, policy);
      }
#pragma unroll
      for (int j = 0; j < kRegUnroll; ++j) {
        const int64_t i = i0 + (int64_t)j * kRegThreads;
        if (i < tile_vecs) st_stream(yt + i, ADDONE ? add_one(u[j]) : u[j]);
      }
    }
  }
}

"""
REG_LAUNCH = """  const int64_t tiles = m / bm, tile_vecs = (int64_t)bm * c / 8;
  const void* fn = addone ? (const void*)probe_map_regs_kernel<true>
                          : (const void*)probe_map_regs_kernel<false>;
  int dev = 0, sms = 0, k = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, fn, kRegThreads, 0);
  const int64_t most = (int64_t)sms * k;
  const int grid = (int)(tiles < most ? tiles : most);
  if (addone) {
    probe_map_regs_kernel<true><<<grid, kRegThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, tiles, tile_vecs);
  } else {
    probe_map_regs_kernel<false><<<grid, kRegThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, tiles, tile_vecs);
  }"""

# store_threads: TMA loads into the ring as before, but every thread of a
# 256-thread CTA stores the stage from shared memory (st.global.cs, +1
# applied on the way), and the slot is refilled R stages ahead once they
# all have read it.
LOOP = """  if (ADDONE) __syncthreads();
  for (int64_t i = 0; i < n; ++i, st.next()) {
    const int slot = (int)(i % kStages);
    const uint32_t buf = slots + slot * kStageBytes;
    if (ADDONE || tid == 0) mbar_wait(bars + 8 * slot, (i / kStages) & 1);
    if (ADDONE) {
      uint4* w = reinterpret_cast<uint4*>(ring + slot * kStageBytes);
      for (int v = tid; v < (int)(st.len() / 16); v += kAddThreads) {
        w[v] = add_one(w[v]);
      }
      fence_proxy_async();
      __syncthreads();
    }
    if (tid == 0) {
      store_stage(y, buf, st, policy);
      // ld is at stage i + kStages - kStoreLag, whose slot the store of
      // stage i - kStoreLag read last.
      if (i + kStages - kStoreLag < n) {
        asm volatile("cp.async.bulk.wait_group.read %0;\\n" ::"n"(kStoreLag)
                     : "memory");
        const int refill = (int)((i + kStages - kStoreLag) % kStages);
        load_stage(slots + refill * kStageBytes, bars + 8 * refill, x, ld,
                   policy);
        ld.next();
      }
    }
  }"""
THREAD_LOOP = """  __syncthreads();
  for (int64_t i = 0; i < n; ++i, st.next()) {
    const int slot = (int)(i % kStages);
    mbar_wait(bars + 8 * slot, (i / kStages) & 1);
    const uint4* w = reinterpret_cast<const uint4*>(ring + slot * kStageBytes);
    uint4* out = reinterpret_cast<uint4*>(y + st.at());
    for (int v = tid; v < (int)(st.len() / 16); v += (int)blockDim.x) {
      const uint4 u = w[v];
      asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\\n" ::"l"(
                       out + v), "r"(ADDONE ? add_one(u).x : u.x),
                   "r"(ADDONE ? add_one(u).y : u.y),
                   "r"(ADDONE ? add_one(u).z : u.z),
                   "r"(ADDONE ? add_one(u).w : u.w)
                   : "memory");
    }
    __syncthreads();
    if (tid == 0 && i + kStages < n) {
      load_stage(slots + slot * kStageBytes, bars + 8 * slot, x, ld, policy);
      ld.next();
    }
  }"""
COPY_THREADS = "constexpr int kCopyThreads = 32; "
STORE_THREADS = [(LOOP, THREAD_LOOP), (LAG, LAG.replace("1", "0")),
                 (COPY_THREADS, COPY_THREADS.replace("32", "256"))]

def ring(stages: int, stage_kb: int, per_sm: int = 2):
    """A ring of ``stages`` slots of ``stage_kb`` KB, at most ``per_sm``
    CTAs an SM."""
    return [(STAGES, f"constexpr int kStages = {stages};"),
            (STAGE_BYTES, f"constexpr int kStageBytes = {stage_kb * 1024};"),
            *([(PER_SM, f"constexpr int kMaxCtasPerSm = {per_sm};")]
              if per_sm != 2 else [])]


FLAT = [(TID, TID + "  tiles = tiles * tile_bytes / kStageBytes;\n"
                    "  tile_bytes = kStageBytes;\n"),
        (GRID, GRID.replace("tiles, &grid",
                            "tiles * tile_bytes / kStageBytes, &grid"))]
PER_CTA = [(MOST, "  *grid = (int)tiles;")]
REGISTERS = [(BAD_ARGS, REG_KERNEL + BAD_ARGS), (LAUNCH, REG_LAUNCH)]
REG_PER_CTA = [(REG_GRID, "  const int grid = (int)tiles;")]
REG_FLAT = [(REG_TILES, "tiles = (int64_t)m * c / 8192, tile_vecs = 1024;")]
CUTS = {
    "base": [],
    "loads_only": [(STORE, "")],
    "stores_only": [(LOAD, "  mbar_arrive(bar);")],
    "no_hint": [
        (LOAD, LOAD.replace('.L2::cache_hint [%0], [%1], %2, [%3], %4;',
                            ' [%0], [%1], %2, [%3];')
         .replace('"r"(bar), "l"(policy)', '"r"(bar)')),
        (STORE, STORE.replace('.bulk_group.L2::cache_hint"',
                              '.bulk_group"')
         .replace(' [%0], [%1], %2, %3;', ' [%0], [%1], %2;')
         .replace('"r"(s.len()),\n      "l"(policy)', '"r"(s.len())'))],
    "lag_2": [(LAG, LAG.replace("1", "2"))],
    "ring_6x16k": ring(6, 16),
    "ring_4x16k_3": ring(4, 16, 3),
    "ring_24x4k": ring(24, 4),
    "ring_3x64k": ring(3, 64),
    "per_tile_cta": PER_CTA,
    "per_tile_cta_6x16k": PER_CTA + ring(6, 16),
    "per_tile_cta_4x16k_3": PER_CTA + ring(4, 16, 3),
    "per_tile_cta_8x16k": PER_CTA + ring(8, 16),
    "flat": FLAT,
    "flat_per_cta": FLAT + PER_CTA,
    "store_threads": STORE_THREADS,
    "registers": REGISTERS,
    "registers_per_cta": REGISTERS + REG_PER_CTA,
    "registers_flat": REGISTERS + REG_FLAT,
    "registers_flat_per_cta": REGISTERS + REG_PER_CTA + REG_FLAT,
}
TIMED_ONLY = ("loads_only", "stores_only", "flat", "flat_per_cta",
              "registers_flat", "registers_flat_per_cta")
# (name, rows, columns, bm, addone): every case of P1's and P2's map
# sweeps, each geometry once (P2's copy at bm 512 and 1024 is P1's c2 =
# 256 case).
CASES = (*((f"copy c2={c2} bm={bm}", TOTAL // c2, c2, bm, False)
           for c2, bm in SHAPE_CASES),
         *((f"copy c2={P2_C} bm={bm}", P2_M, P2_C, bm, False)
           for bm in COPY_BMS if (P2_C, bm) not in SHAPE_CASES),
         *((f"addone bm={bm}", P2_M, P2_C, bm, True) for bm in MAP_BMS))


def map_registers(report: str) -> dict:
    """{kernel name: registers} of the map kernels in a ptxas report."""
    return {name: info["registers"]
            for name, info in ptxas_info(report).items()
            if "probe_map" in name and "registers" in info}


def build(tmp: Path, cuts) -> dict:
    """{cut: (loaded library, ptxas report)}, built all at once."""
    text = (_build.CSRC / "probes.cu").read_text()
    pairs = []
    for cut in cuts:
        d = tmp / cut
        d.mkdir()
        (d / "probes.cu").write_text(cut_source(text, cut, CUTS))
        pairs.append((d / "probes.cu", tmp / f"{cut}.so"))
    out = {}
    for cut, (_, so), report in zip(cuts, pairs, nvcc_shared(pairs)):
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hvd_probe_map.argtypes = [P, P, I, I, I, I, P]
        out[cut] = (lib, report)
    return out


def _call(lib, cut, x, y, bm, addone):
    m, c = x.shape
    err = lib.hvd_probe_map(x.data_ptr(), y.data_ptr(), m, c, bm,
                            int(addone),
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe map ({cut}): CUDA error {err}")


def check(lib, cut) -> None:
    """Hold a variant to the plain versions on special values."""
    for m, c, bm in ((4096, 256, 512), (96, 8, 32), (3120, 2048, 1040)):
        x = special_bf16(m, c, seed=m, device="cuda")
        for addone in (False, True):
            y = torch.empty_like(x)
            _call(lib, cut, x, y, bm, addone)
            ok = (addone_matches(y, probes.addone_reference(x), x) if addone
                  else copy_matches(y, x))
            if not ok:
                raise AssertionError(f"probe split {cut}: {(m, c, bm)} "
                                     f"addone={addone} differs from plain")


def split(tmp: Path, rounds: int, cuts=tuple(CUTS)) -> dict:
    """{cut: {"ms": {case: [per round]}, "registers": {kernel: n}}}, and
    the yardsticks under "library"."""
    libs = build(tmp, cuts)
    out = {cut: {"ms": {name: [] for name, *_ in CASES},
                 "registers": map_registers(report)}
           for cut, (_, report) in libs.items()}
    for cut, (lib, _) in libs.items():
        if cut not in TIMED_ONLY:
            check(lib, cut)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(TOTAL, generator=gen, device="cuda", dtype=torch.bfloat16)
    y = torch.empty_like(x)
    lib_ms = {"y.copy_(x)": [], "torch.add(x, 1)": []}
    for _ in range(rounds):
        lib_ms["y.copy_(x)"].append(time_ms(lambda: y.copy_(x)))
        lib_ms["torch.add(x, 1)"].append(time_ms(lambda: torch.add(x, 1)))
        for cut, (lib, _) in libs.items():
            for name, m, c, bm, addone in CASES:
                x2, y2 = x.view(m, c), y.view(m, c)
                out[cut]["ms"][name].append(time_ms(
                    lambda: _call(lib, cut, x2, y2, bm, addone)))
    out["library"] = {"ms": lib_ms}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cuts", nargs="+", choices=list(CUTS),
                    default=list(CUTS), help="the variants to build and time")
    args = ap.parse_args(argv)
    require_cuda("probe_split")
    print(device_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for cut, r in split(Path(tmp), args.rounds, args.cuts).items():
            print(json.dumps({"cut": cut, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
