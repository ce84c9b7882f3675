"""The probe map kernel's work partition, through its Python mirror.

``ops/probes.py``'s ``map_grid`` and ``map_schedule`` say which
persistent CTA takes which row tile and what each ring stage moves, as
``ops/csrc/probes.cu`` does (its constants are read from the source).
Every sweep case of P1 and P2, the card tests' shapes and random shapes
must be covered byte for byte exactly once, in stages that never cross a
tile, each CTA taking its tiles whole and in order. Also: the split
experiment's cuts apply to the committed source exactly once, and the
new probe scripts refuse to run without a card.
"""

import re

import pytest
import torch
from hypothesis import given, settings, strategies as st

from horovod_tpu_torch.experiments import mem_probe, shape_probe
from horovod_tpu_torch.ops import _build, probes

SMS = 132          # an H100 SXM's SMs
CARD_SHAPES = [(4096, 256, 512), (1024, 2048, 8), (2048, 64, 2048),
               (96, 8, 32), (512, 256, 512), (12000, 264, 40),
               (6400, 512, 64), (65536, 64, 8), (3120, 2048, 1040)]
SWEEP = ([(shape_probe.TOTAL // c2, c2, bm) for c2, bm in shape_probe.CASES]
         + [(mem_probe.M, mem_probe.C, bm)
            for bm in sorted(set(mem_probe.COPY_BMS + mem_probe.MAP_BMS))])


def check_schedule(m, c, bm, grid):
    tiles, tile_bytes = m // bm, bm * c * 2
    sched = probes.map_schedule(m, c, bm, grid)
    assert len(sched) == grid
    pieces = []
    for b, stages in enumerate(sched):
        # Tiles whole and in order: b, b + grid, ..., each a run of
        # stages from its first byte to its last.
        taken = [t for i, (t, _, _) in enumerate(stages)
                 if i == 0 or stages[i - 1][0] != t]
        assert taken == list(range(b, tiles, grid))
        for i, (tile, off, n) in enumerate(stages):
            lo, hi = tile * tile_bytes, (tile + 1) * tile_bytes
            assert lo <= off and off + n <= hi       # inside one tile
            assert 0 < n <= probes.STAGE_BYTES and n % 16 == 0
            first = i == 0 or stages[i - 1][0] != tile
            last = i + 1 == len(stages) or stages[i + 1][0] != tile
            assert off == (lo if first else sum(stages[i - 1][1:]))
            assert not last or off + n == hi
            pieces.append((off, n))
    # Every byte of [0, M*C*2) exactly once.
    pieces.sort()
    end = 0
    for off, n in pieces:
        assert off == end
        end += n
    assert end == m * c * 2


def test_ring_constants_are_the_kernels():
    text = (_build.CSRC / "probes.cu").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", text)
        return int(v)

    assert const("kStageBytes") == probes.STAGE_BYTES
    assert const("kMaxCtasPerSm") == probes.MAX_CTAS_PER_SM
    assert probes.STAGE_BYTES % 16 == 0


@pytest.mark.parametrize("m,c,bm", SWEEP + CARD_SHAPES)
def test_schedule_covers_every_byte_once(m, c, bm):
    # One CTA an SM holds the kernel's 192 KB ring; two, a smaller ring.
    for per_sm in (1, 2):
        check_schedule(m, c, bm, probes.map_grid(m // bm, SMS, per_sm))


@settings(max_examples=300, derandomize=True, deadline=None)
@given(tiles=st.integers(1, 300), bm=st.integers(1, 40),
       c8=st.integers(1, 300), sms=st.integers(1, 200),
       per_sm=st.integers(1, 4))
def test_schedule_of_random_shapes(tiles, bm, c8, sms, per_sm):
    grid = probes.map_grid(tiles, sms, per_sm)
    assert 1 <= grid <= min(tiles, sms * probes.MAX_CTAS_PER_SM)
    check_schedule(tiles * bm, 8 * c8, bm, grid)


def test_grid_of_the_sweep_geometries():
    assert probes.map_grid(1568, SMS, 2) == 264
    assert probes.map_grid(196, SMS, 2) == 196
    assert probes.map_grid(98, SMS, 3) == 98
    assert probes.map_grid(1568, SMS, 1) == SMS
    # 196 tiles on one CTA an SM: 64 CTAs take a second tile.
    sched = probes.map_schedule(802816, 256, 4096, probes.map_grid(
        196, SMS, 1))
    assert sorted({len({t for t, _, _ in st}) for st in sched}) == [1, 2]
    assert sum(len({t for t, _, _ in st}) == 2 for st in sched) == 64
    # One stage a tile below STAGE_BYTES; a short last stage above it.
    (stages,) = probes.map_schedule(96, 8, 32, 1)
    assert [n for _, _, n in stages] == [512, 512, 512]
    (stages,) = probes.map_schedule(40, 264, 40, 1)
    assert [n for _, _, n in stages] == [probes.STAGE_BYTES,
                                         40 * 264 * 2 - probes.STAGE_BYTES]


@pytest.mark.parametrize("cut", ["base", "loads_only", "stores_only",
                                 "no_hint", "lag_2", "ring_6x16k",
                                 "ring_4x16k_3", "ring_24x4k", "ring_3x64k",
                                 "per_tile_cta", "per_tile_cta_6x16k",
                                 "per_tile_cta_4x16k_3", "per_tile_cta_8x16k",
                                 "flat", "flat_per_cta",
                                 "store_threads", "registers",
                                 "registers_per_cta", "registers_flat",
                                 "registers_flat_per_cta"])
def test_probe_split_cut_applies_once(cut):
    """Each cut of the split finds its pieces in the committed probes.cu
    exactly once and leaves the stats kernels alone; a source where a
    piece is missing or doubled is refused."""
    from horovod_tpu_torch.experiments import probe_split
    from horovod_tpu_torch.experiments.flash_fwd_split import cut_source
    text = (_build.CSRC / "probes.cu").read_text()
    out = cut_source(text, cut, probe_split.CUTS)
    stats = text[text.index("// part[g, c] = sum(x)"):
                 text.index("bool bad_args(")]
    assert stats in out
    step = text     # the pieces apply in order, each to the text so far
    for old, new in probe_split.CUTS[cut]:
        assert step.count(old) == 1
        step = step.replace(old, new)
        if old in text:
            with pytest.raises(ValueError, match="exactly once"):
                cut_source(text.replace(old, ""), cut, probe_split.CUTS)
            with pytest.raises(ValueError, match="exactly once"):
                cut_source(text + old, cut, probe_split.CUTS)
    assert step == out
    assert (out == text) == (cut == "base")
    if cut == "registers":
        assert "probe_map_regs_kernel<true><<<" in out
        assert "probe_map_kernel<true><<<" not in out


def test_split_cases_are_the_sweeps_geometries():
    from horovod_tpu_torch.experiments import probe_split
    from horovod_tpu_torch.experiments.flash_fwd_split import cut_source
    assert sorted(probe_split.CUTS) == sorted(
        test_probe_split_cut_applies_once.pytestmark[0].args[1])
    cases = {(m, c, bm, add) for _, m, c, bm, add in probe_split.CASES}
    assert len(cases) == len(probe_split.CASES) == 14
    sweep = ({(shape_probe.TOTAL // c2, c2, bm, False)
              for c2, bm in shape_probe.CASES}
             | {(mem_probe.M, mem_probe.C, bm, False)
                for bm in mem_probe.COPY_BMS}
             | {(mem_probe.M, mem_probe.C, bm, True)
                for bm in mem_probe.MAP_BMS})
    assert cases == sweep
    assert sorted(m // bm for m, _, bm, add in cases if not add) == [
        98, 98, 196, 196, 196, 196, 392, 784, 784, 1568, 3136]
    text = (_build.CSRC / "probes.cu").read_text()
    for name, stages, stage, per_sm in (("ring_6x16k", 6, 16384, 2),
                                        ("ring_4x16k_3", 4, 16384, 3)):
        out = cut_source(text, name, probe_split.CUTS)
        assert f"constexpr int kStages = {stages};" in out
        assert f"constexpr int kStageBytes = {stage};" in out
        assert f"constexpr int kMaxCtasPerSm = {per_sm};" in out


def test_map_registers_reads_the_ptxas_report():
    from horovod_tpu_torch.experiments import probe_split
    ns = "51_GLOBAL__N__fd5382a6_9_probes_cu_6c7cf8a4"
    copy = f"_ZN{ns}16probe_map_kernelILb0EEEvPKcPcll"
    stats = f"_ZN{ns}18probe_stats_kernelEPK13__nv_bfloat16Pfii"
    report = "\n".join([
        f"ptxas info    : Function properties for {copy}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, used 0 barriers",
        f"ptxas info    : Function properties for {stats}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
    ])
    assert probe_split.map_registers(report) == {
        "_ZN16probe_map_kernelILb0EEEvPKcPcll": 30}


@pytest.mark.parametrize("name,argv", [("probe_turns", ["--other", "."]),
                                       ("probe_split", [])])
def test_new_probe_scripts_refuse_to_run_without_a_card(monkeypatch, name,
                                                        argv):
    import importlib
    script = importlib.import_module(f"horovod_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        script.main(argv)
