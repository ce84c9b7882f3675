"""P3: split the mma.sync flash forward body's time into loading, matrix
products and row max by ablating it, with K1 timed beside.

    python -m horovod_tpu_torch.experiments.flash_ablate_probe

Counterpart of ``experiments/flash_ablate_probe.py``. At D = 128, for
(B, H, S) in the probe's (8, 16, 2048), (8, 16, 8192), (16, 16, 2048)
and the flagship LM's (8, 6, 2048), causal and not, it times the
ablation kernel's variants at square tiles of 64 (the mma.sync
body's CTA, 4 warps) and 128 (8 warps):

- ``stream``: the kernel's tile loads, acc += (q + k) + v, no product;
- ``matmul``: acc += bf16(q k^T) v;
- ``nosoft``: the products plus a per-tile row max and a 0.5 decay;
- ``full``: the flash forward kernel K1 itself (tile 64 only), a
  different design (128-row CTA, wgmma, cp.async ring).

The three ablations keep the mma.sync body that K1 had before its
redesign (synchronous loads, V transposed into shared memory), so they
split that body:
``stream`` is its load time, ``matmul - stream`` its products' and
``nosoft - matmul`` its row max's; they sum to ``nosoft``. K1 no longer
shares that body, so ``full - nosoft`` is no part of it: ``split``
prints K1 beside the sum as its own row. Yardsticks:
``scaled_dot_product_attention`` beside ``full`` and, non-causal, the
chain ``bmm(bmm(q, k^T), v)`` beside ``matmul`` (the same function up to
the fp32 summation order). Each row's bound counts the tile pairs the
kernel processes (causal skips whole tiles): 4*D flops per pair at 989
TFLOP/s against 4*BH*S*D*2 bytes at 3.35 TB/s; ``stream`` does 3 fp32
adds per element of each processed tile. q, k and v are distinct seeded
tensors (the Pallas probe passes one tensor three times, which flatters
reuse in a 50 MB L2).
"""

from __future__ import annotations

import argparse

import torch

from ..ops import flash_attention as fa
from ..ops import probes
from . import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound_ms, check_ablate,
               device_line, require_cuda, time_ms)

D = 128
FLAGSHIP = (8, 6, 2048)
SHAPES = ((8, 16, 2048), (8, 16, 8192), (16, 16, 2048), FLAGSHIP)
TILES = (64, 128)
VARIANTS = probes.MODES + ("full",)


def tiles_processed(s: int, tile: int, causal: bool) -> int:
    """Key tiles processed per head over all q tiles."""
    n = s // tile
    return n * (n + 1) // 2 if causal else n * n


def work(mode, bh, s, d, tile, causal):
    """(operations, bytes, peak operations/s) of one call."""
    tiles = bh * tiles_processed(s, tile, causal)
    nbytes = 4 * bh * s * d * 2
    if mode == "stream":
        return 3 * tiles * tile * d, nbytes, PEAK_FP32_FLOPS
    return 4 * d * tiles * tile * tile, nbytes, PEAK_BF16_FLOPS


def inputs(bh, s, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]


def variant(mode, q, k, v, causal, tile):
    """The variant's launch as a thunk."""
    if mode == "full":
        return lambda: fa.flash_fwd_cuda(q, k, v, q.shape[-1] ** -0.5,
                                         causal)
    return lambda: probes.ablate_cuda(q, k, v, mode, causal, tile, tile)


def run(shapes=SHAPES, causals=(True, False), tiles=TILES, check=True):
    """One row per (shape, causal, tile, variant): B, H, S, causal, tile,
    mode, ms, bound_ms, bound_by, tflops, library_ms, max_abs_err (None
    where unchecked; the flash forward is checked by its own tests)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, h, s in shapes:
        bh = b * h
        q, k, v = inputs(bh, s, D, seed=s + bh)
        q4, k4, v4 = (x.view(b, h, s, D) for x in (q, k, v))
        for causal in causals:
            library = {"full": time_ms(
                lambda: sdpa(q4, k4, v4, is_causal=causal))}
            if not causal:
                library["matmul"] = time_ms(lambda: torch.bmm(
                    torch.bmm(q, k.transpose(1, 2)), v))
            for tile in tiles:
                for mode in VARIANTS:
                    if mode == "full" and tile != 64:
                        continue
                    fn = variant(mode, q, k, v, causal, tile)
                    err = None
                    if check and mode != "full":
                        err = check_ablate(q, k, v, mode, causal, tile)[0]
                    ms = time_ms(fn)
                    ops, nbytes, peak = work(mode, bh, s, D, tile, causal)
                    b_ms, b_by = bound_ms(ops, nbytes, peak)
                    rows.append(dict(B=b, H=h, S=s, causal=causal, tile=tile,
                                     mode=mode, ms=ms, bound_ms=b_ms,
                                     bound_by=b_by, tflops=ops / ms / 1e9,
                                     library_ms=library.get(mode),
                                     max_abs_err=err))
    return rows


def split(rows):
    """Per (shape, causal, tile) with all four variants, in ms: the
    mma.sync body's load, products and row max, their sum (= nosoft),
    and K1."""
    out = {}
    for r in rows:
        key = (r["B"], r["H"], r["S"], r["causal"], r["tile"])
        out.setdefault(key, {})[r["mode"]] = r["ms"]
    return {key: {"load": t["stream"], "products": t["matmul"] - t["stream"],
                  "row_max": t["nosoft"] - t["matmul"], "sum": t["nosoft"],
                  "k1": t["full"]}
            for key, t in out.items() if set(t) == set(VARIANTS)}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_cuda("flash_ablate_probe")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_line(), flush=True)
    rows = run()
    for r in rows:
        lib = (f", library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        err = (f", max abs err {r['max_abs_err']}"
               if r["max_abs_err"] is not None else "")
        print(f"B{r['B']} H{r['H']} S{r['S']} causal={int(r['causal'])} "
              f"tile={r['tile']} {r['mode']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.1%} of it, {r['tflops']:.1f} "
              f"TFLOP/s{lib}{err}", flush=True)
    for (b, h, s, causal, tile), t in split(rows).items():
        print(f"split B{b} H{h} S{s} causal={int(causal)} tile={tile}: "
              f"mma.sync body: load {t['load']:.4f} + products "
              f"{t['products']:.4f} + row max {t['row_max']:.4f} = "
              f"{t['sum']:.4f} ms; K1 {t['k1']:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
