"""A CPU rehearsal of ``chip_smoke.py`` phase 22 (the fleet driven
through ``python -m horovod_tpu_torch.serving --fleet 2`` by the port's
loadgen, replica 1 crashing mid-load) at a small width and a short
load: the phase's own checks pass on the CPU, and what it logs names
the crash, the restart and the drain."""

import importlib.util
import types
from pathlib import Path

import torch

from horovod_tpu_torch.checkpoint import checkpoint_hook
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.serving import transformer_extra

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab=512, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=256, dtype=torch.float32, remat=False)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_phase_rehearsal(tmp_path, monkeypatch, capsys):
    # One thread a replica, and a supervisor that tolerates probes a
    # loaded CPU answers late: the suite runs several files at once, and
    # a replica killed for a slow /healthz would be a second restart.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("HOROVOD_TPU_FLEET_PROBE_FAILURES", "40")
    cs = _load_smoke()
    for name, value in dict(SERVE_SLOTS=4, SERVE_BLOCK=4, SERVE_KV_BLOCKS=160,
                            SERVE_NEW=8, FLEET_RATE=6.0, FLEET_DURATION_S=3.0,
                            FLEET_PROMPT=(8, 48), FLEET_CRASH_TICK=8,
                            FLEET_TIMEOUT_S=120).items():
        monkeypatch.setattr(cs, name, value)
    cfg = tfm.TransformerConfig(**SMALL)
    model = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    checkpoint_hook(str(tmp_path), model=types.SimpleNamespace(
        state_dict=model.params_tree), every=1,
        extra=transformer_extra(cfg))(0, block=True)
    cs.fleet_phase(tfm, "cpu rehearsal", str(tmp_path), 0.0, device="cpu")
    out = capsys.readouterr().out
    assert "0 failed" in out and "back in rotation at generation 1" in out
    assert "SIGTERM drained, exit 0" in out
    assert "replica 1 crashed at its decode tick 8" in out
    assert "not measured" in out       # no nvidia-smi here
