"""The port's probe entry points against the Pallas probes under
``experiments/``.

Each JAX probe kernel is built as its script builds it, with
``interpret=True`` (the scripts are loaded from their files:
``experiments/`` is not a package), and held against the port on the
same numpy-seeded inputs; on CPU tensors the port runs the kernels'
plain versions. Tolerances: copy and addone exact; stats-like within
1e-4 of sum |terms| per channel (fp32 sums in another order); the flash
ablation's stream within 1 bf16 ulp (the same fp32 adds in the same
order), matmul and nosoft within 1e-2 of max |reference| (bf16 rounding
of scores that differ in their last fp32 bits).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from horovod_tpu_torch.experiments import bf16_ulp
from horovod_tpu_torch.ops import _build, probes

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


shape_probe = _load("pallas_shape_probe")
mem_probe = _load("pallas_mem_probe")
ablate_probe = _load("flash_ablate_probe")


def _bf16(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- P1

def _jax_copy(x, c2, bm):
    """pallas_shape_probe.make_copy at a small size, interpreted."""
    m2 = x.size // c2
    f = pl.pallas_call(
        shape_probe.copy_kernel, grid=(m2 // bm,),
        in_specs=[pl.BlockSpec((bm, c2), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((bm, c2), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m2, c2), jnp.bfloat16),
        interpret=True)
    return f(jnp.asarray(x, jnp.bfloat16).reshape(m2, c2))


@pytest.mark.parametrize("c2,bm", [(256, 64), (2048, 8), (512, 32)])
def test_p1_copy_matches_jax(c2, bm):
    x = _randn(1, 1 << 16)
    want = _bf16(_jax_copy(x, c2, bm))
    x2 = torch.from_numpy(x).to(torch.bfloat16).view(-1, c2)
    assert torch.equal(probes.tile_copy(x2, bm), want)


# ---------------------------------------------------------------- P2

def _jax_map(kernel, x, bm, reduce=False):
    """pallas_mem_probe.make_pallas_map's pallas_call, interpreted."""
    m, c = x.shape
    if reduce:
        out_specs = pl.BlockSpec((1, c), lambda i: (0, 0))
        out_shape = jax.ShapeDtypeStruct((1, c), jnp.float32)
    else:
        out_specs = pl.BlockSpec((bm, c), lambda i: (i, 0))
        out_shape = jax.ShapeDtypeStruct((m, c), jnp.bfloat16)
    f = pl.pallas_call(
        kernel, grid=(m // bm,),
        in_specs=[pl.BlockSpec((bm, c), lambda i: (i, 0))],
        out_specs=out_specs, out_shape=out_shape, interpret=True)
    return f(jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("name", ["copy", "addone"])
@pytest.mark.parametrize("bm", [16, 64])
def test_p2_map_matches_jax(name, bm):
    x = _randn(2, 256, 256) * 4
    kernel = {"copy": mem_probe.copy_kernel,
              "addone": mem_probe.addone_kernel}[name]
    port = {"copy": probes.tile_copy, "addone": probes.tile_addone}[name]
    want = _bf16(_jax_map(kernel, x, bm))
    got = port(torch.from_numpy(x).to(torch.bfloat16), bm)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("bm", [16, 64])
def test_p2_stats_like_matches_jax(bm):
    x = _randn(3, 512, 256) + 0.5
    want = torch.from_numpy(np.array(
        _jax_map(mem_probe.stats_like_kernel, x, bm, reduce=True)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = probes.stats_like(xt, bm)
    assert got.shape == (1, 256) and got.dtype == torch.float32
    xf = xt.float()
    mag = (xf.abs() + xf * xf).sum(0, keepdim=True)
    assert float(((got - want).abs() / mag).max()) <= 1e-4


# ---------------------------------------------------------------- P3

def _jax_ablate(q, k, v, mode, causal, bq, bk):
    """flash_ablate_probe.run_variant's pallas_call, interpreted."""
    bh, s, d = q.shape
    kern = functools.partial(ablate_probe.variant_kernel, mode=mode,
                             causal=causal, block_q=bq, block_k=bk,
                             n_k=s // bk)
    call = pl.pallas_call(
        kern, grid=(bh, s // bq, s // bk),
        in_specs=[pl.BlockSpec((1, bq, d), lambda b, i, j: (b, i, 0)),
                  pl.BlockSpec((1, bk, d), lambda b, i, j: (b, j, 0)),
                  pl.BlockSpec((1, bk, d), lambda b, i, j: (b, j, 0))],
        out_specs=pl.BlockSpec((1, bq, d), lambda b, i, j: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, s, d), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((bq, d), jnp.float32)],
        interpret=True)
    return call(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", probes.MODES)
def test_p3_ablate_matches_jax(mode, causal, d, tile):
    bh, s = 2, 256
    q, k, v = (_randn(seed, bh, s, d) for seed in (10 + d, 11 + d, 12 + d))
    want = _bf16(_jax_ablate(q, k, v, mode, causal, tile, tile)).float()
    got = probes.flash_ablate(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        mode, causal, tile, tile)
    assert got.shape == (bh, s, d) and got.dtype == torch.bfloat16
    diff = (got.float() - want).abs()
    if mode == "stream":
        assert bool((diff <= bf16_ulp(want)).all())
    else:
        assert float(diff.max()) <= 1e-2 * float(want.abs().max())


def test_p3_causal_skips_whole_tiles_only():
    """Block-granular causality: the first q tile sees its whole diagonal
    tile (nothing masked inside) and no later tile; the last sees all."""
    bh, s, d, t = 1, 128, 64, 64
    q, k, v = (torch.from_numpy(_randn(seed, bh, s, d)).to(torch.bfloat16)
               for seed in (1, 2, 3))
    got = probes.flash_ablate(q, k, v, "matmul", True, t, t).float()
    first = (q[:, :t].float() @ k[:, :t].float().transpose(1, 2)).to(
        torch.bfloat16).float() @ v[:, :t].float()
    full = probes.flash_ablate(q, k, v, "matmul", False, t, t).float()
    assert torch.allclose(got[:, :t], first.to(torch.bfloat16).float(),
                          rtol=1e-2, atol=1e-2 * float(first.abs().max()))
    assert torch.equal(got[:, t:], full[:, t:])


def test_p3_nosoft_decays_only_processed_tiles():
    """nosoft halves the accumulator once per processed tile: with one
    tile of keys the first q tile is one product, not a halved one."""
    bh, s, d, t = 1, 128, 64, 64
    q, k, v = (torch.from_numpy(_randn(seed, bh, s, d)).to(torch.bfloat16)
               for seed in (4, 5, 6))
    causal = probes.ablate_reference(q, k, v, "nosoft", True, t, t)
    sc = q[:, :t].float() @ k[:, :t].float().transpose(1, 2)
    p = (sc - sc.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    assert torch.equal(causal[:, :t], (p @ v[:, :t].float()).to(
        torch.bfloat16))


# ------------------------------------------------- dispatch and refusals

def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(probes, "library", no_library)
    probes.reset_launch_counts()
    x = torch.from_numpy(_randn(7, 64, 64)).to(torch.bfloat16)
    assert torch.equal(probes.tile_copy(x, 16), x)
    assert torch.equal(probes.tile_addone(x, 16), probes.addone_reference(x))
    assert torch.equal(probes.stats_like(x, 16),
                       probes.stats_like_reference(x, 16))
    q = x.view(1, 64, 64)
    assert torch.equal(probes.flash_ablate(q, q, q, "nosoft", True, 32, 32),
                       probes.ablate_reference(q, q, q, "nosoft", True, 32,
                                               32))
    assert sum(probes.launch_counts().values()) == 0


def test_entry_points_refuse_what_the_probes_never_run():
    q = torch.zeros(2, 100, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ragged"):
        probes.flash_ablate(q, q, q, "matmul", True, 64, 64)
    q = torch.zeros(2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q == block_k"):
        probes.flash_ablate(q, q, q, "stream", True, 64, 32)
    with pytest.raises(ValueError, match="mode"):
        probes.flash_ablate(q, q, q, "full", True, 64, 64)
    x = torch.zeros(100, 64, dtype=torch.bfloat16)
    for fn in (probes.tile_copy, probes.tile_addone, probes.stats_like):
        with pytest.raises(ValueError, match="ragged"):
            fn(x, 64)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    q = x.view(1, 64, 64)
    for call in (lambda: probes.copy_cuda(x, 16),
                 lambda: probes.addone_cuda(x, 16),
                 lambda: probes.stats_like_cuda(x, 16),
                 lambda: probes.ablate_cuda(q, q, q, "matmul", True, 64, 64)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_every_c_entry_point_is_declared():
    """Each ``extern "C"`` function of csrc/ gets argtypes of its arity and
    an int restype in _build._declare."""
    import re

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("Fn", (), {})())

    lib = Lib()
    _build._declare(lib)
    found = 0
    for src in _build.sources():
        text = src.read_text()
        body = text[text.index('extern "C"'):]
        for name, params in re.findall(r"int (hvd_\w+)\(([^)]*)\)", body):
            found += 1
            fn = lib.fns[name]
            assert len(fn.argtypes) == len(params.split(",")), name
            assert fn.restype is not None, name
    assert found >= 10


# ------------------------------------------------------- probe scripts

@pytest.mark.parametrize("name", ["shape_probe", "mem_probe",
                                  "flash_ablate_probe", "flash_times",
                                  "flash_fwd_split"])
def test_probe_scripts_refuse_to_run_without_a_card(monkeypatch, name):
    import importlib
    script = importlib.import_module(f"horovod_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        script.main([])


def test_p3_bound_counts_the_tiles_the_kernel_processes():
    from horovod_tpu_torch.experiments import flash_ablate_probe as p3
    assert p3.tiles_processed(2048, 64, True) == 32 * 33 // 2
    assert p3.tiles_processed(2048, 128, False) == 16 * 16
    flops, nbytes, _ = p3.work("matmul", 48, 2048, 128, 64, True)
    assert flops == 4 * 128 * 48 * 528 * 64 * 64      # 53.2 GFLOP
    assert nbytes == 4 * 48 * 2048 * 128 * 2
    ops, _, peak = p3.work("stream", 48, 2048, 128, 64, True)
    assert ops == 3 * 48 * 528 * 64 * 128 and peak == p3.PEAK_FP32_FLOPS
    rows = [dict(B=8, H=6, S=2048, causal=True, tile=64, mode=m, ms=t)
            for m, t in (("stream", 0.25), ("matmul", 0.5),
                         ("nosoft", 0.625), ("full", 1.0))]
    assert p3.split(rows) == {(8, 6, 2048, True, 64): {
        "load": 0.25, "products": 0.25, "row_max": 0.125, "sum": 0.625,
        "k1": 1.0}}


_NS = "51_GLOBAL__N__fd5382a6_18_flash_attention_cu_6c7cf8a4"
_FWD = f"_ZN{_NS}16flash_fwd_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi"


def test_kernel_sass_reads_the_ptxas_report():
    from horovod_tpu_torch.experiments import kernel_sass
    loss = ("wgmma.mma_async instructions are serialized due to non wgmma "
            "instructions defining accumulator registers of a wgmma "
            "between start and end of the pipeline stage")
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{_FWD}' for 'sm_90a'",
        f"ptxas info    : (C7515) Potential Performance Loss: {loss} in the "
        f"function '{_FWD}'",
        f"ptxas info    : Function properties for {_FWD}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 173 registers, used 1 barriers",
    ])
    key = "_ZN16flash_fwd_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi"
    assert kernel_sass.ptxas_info(report) == {key: {
        "stack": 0, "spill_stores": 8, "spill_loads": 4, "registers": 173,
        "perf_notes": [loss]}}


def test_kernel_sass_keys_kernels_without_the_file_namespace():
    """The anonymous namespace is named after the file and differs from
    one build to another; bodies are compared without it."""
    from horovod_tpu_torch.experiments import kernel_sass
    other = _FWD.replace("fd5382a6", "0badf00d").replace("6c7cf8a4",
                                                         "12345678")
    sass = (f"\t\tFunction : {_FWD}\n"
            "        /*0000*/                   HGMMA.64x64x16.F32.BF16 ... ;\n"
            "        /*0010*/                   EXIT ;\n"
            f"\t\tFunction : {other}\n"
            "        /*0000*/                   EXIT ;\n")
    bodies = kernel_sass.sass_bodies(sass)
    assert len(bodies) == 1
    (body,) = bodies.values()
    assert body == ["/*0000*/ EXIT ;"]


@pytest.mark.parametrize("cut", ["no_qk", "no_pv", "no_exp2",
                                 "no_ring_wait"])
def test_k1_split_cut_applies_once_or_refuses(cut):
    """A cut of the K1 split replaces its piece where the piece occurs
    exactly once, and refuses a source where it does not (so a split of
    a changed kernel stops instead of timing the uncut loop)."""
    from horovod_tpu_torch.experiments import flash_fwd_split
    ((old, new),) = flash_fwd_split.CUTS[cut]
    text = f"head\n{old}\ntail\n"
    assert flash_fwd_split.cut_source(text, cut) == f"head\n{new}\ntail\n"
    assert flash_fwd_split.cut_source(text, "base") == text
    for drifted in ("head\ntail\n", text + old):
        with pytest.raises(ValueError, match="exactly once"):
            flash_fwd_split.cut_source(drifted, cut)


@pytest.mark.parametrize("variant", ["overlap", "overlap_lead3",
                                     "wait_each_tile", "wait_lead2"])
def test_k3_order_variants_apply_to_the_source(variant):
    """Each K3 loop-order variant finds its pieces in the committed
    source exactly once and changes only what it names."""
    from horovod_tpu_torch.experiments import flash_dq_order as order
    from horovod_tpu_torch.ops import _build
    text = (_build.CSRC / "flash_attention.cu").read_text()
    out = order.cut_source(text, variant, order.VARIANTS)
    stages = "5" if variant == "overlap_lead3" else "4"
    assert f"constexpr int kDqStages = {stages};" in out
    lead = "3" if variant in ("overlap_lead3", "wait_each_tile") else "2"
    assert f"constexpr int kDqLead = {lead};" in out
    waits = variant.startswith("wait")
    assert (order.DQ_WAIT in out) == waits
    assert (order.DQ_COMMIT in out) == (not waits)


def test_ptxas_registers_of_a_named_kernel():
    from horovod_tpu_torch.experiments import flash_fwd_split
    dq = _FWD.replace("16flash_fwd_kernel", "15flash_dq_kernel")
    report = "\n".join([
        f"ptxas info    : Function properties for {_FWD}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 173 registers, used 1 barriers",
        f"ptxas info    : Function properties for {dq}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 201 registers, used 1 barriers",
    ])
    assert flash_fwd_split.registers(report) == 173
    assert flash_fwd_split.registers(report, "flash_dq_kernel") == 201
    with pytest.raises(ValueError, match="flash_dkv_kernel"):
        flash_fwd_split.registers(report, "flash_dkv_kernel")


def test_p1_p2_cases_and_bytes():
    from horovod_tpu_torch.experiments import mem_probe, shape_probe
    assert all((shape_probe.TOTAL // c2) % bm == 0
               for c2, bm in shape_probe.CASES)
    assert mem_probe.work("copy") == (0, 4 * 802816 * 256)
    assert mem_probe.work("stats_like") == (3 * 802816 * 256,
                                            2 * 802816 * 256 + 4 * 256)
