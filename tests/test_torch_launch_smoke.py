"""A CPU rehearsal of ``chip_smoke.py`` phase 23 (``run_elastic`` over
``experiments/elastic_lm.py``'s worker, generation 0 SIGKILLed after
step 3, against a clean ``run(fn, np=1)``; then 23b, the runner's
``--serve``) at a small width: the phase's own checks pass on the CPU —
the restart resumes at the commit and ends bit for bit the clean run,
the runner's server gives the in-process engine's tokens and drains."""

import importlib.util
import types
from pathlib import Path

import torch

from horovod_tpu_torch.checkpoint import checkpoint_hook
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.serving import transformer_extra

ROOT = Path(__file__).resolve().parent.parent
WIDTH = dict(vocab=64, d_model=32, n_layers=2, d_ff=64, max_seq=32)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launch_phase_rehearsal(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cs = _load_smoke()
    for name, value in dict(SERVE_LENS=(3, 5, 9, 17, 4, 6, 8, 10),
                            SERVE_NEW=4, SERVE_SLOTS=4, SERVE_BLOCK=4,
                            SERVE_KV_BLOCKS=80, SERVE_TIMEOUT_S=120,
                            LAUNCH_TIMEOUT_S=120).items():
        monkeypatch.setattr(cs, name, value)
    cfg = tfm.TransformerConfig(dtype=torch.float32, remat=False, **WIDTH)
    model = tfm.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    checkpoint_hook(str(tmp_path), model=types.SimpleNamespace(
        state_dict=model.params_tree), every=1,
        extra=transformer_extra(cfg))(0, block=True)
    toks = cs.serve_engine(model, cs.serve_prompts(cfg.vocab))[0]
    cs.launch_phase("cpu rehearsal", str(tmp_path), toks, device="cpu",
                    width=WIDTH, dtype=torch.float32)
    out = capsys.readouterr().out
    assert "2 generations, generation 1 restored step 2" in out
    assert "bit for bit the clean run's" in out
    assert "tokens identical to phase 21's" in out
    assert "exit 0" in out
