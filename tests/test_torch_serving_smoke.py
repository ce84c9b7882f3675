"""A CPU rehearsal of ``chip_smoke.py`` phase 21 (the flagship served
over HTTP) at a small width, with the card's flash policy emulated: the
reference forward takes ``flash_attention`` from ``FLASH_MIN_SEQ``
attended tokens, and each of its calls counts one K1 launch, as the
card's wrapper counts them.

The speculative run's tokens are given a near-tie divergence on the
1024-token prompt. The phase must log it as a finding and pass: the
full forward that judges a divergence launches K1 on the card, so the
phase reads the serve path's launches before any such forward, and
(c)'s K1 count after its own forwards only.
"""

import importlib.util
from pathlib import Path

import torch

from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import fused_bn as fbn

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab=512, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=2048, dtype=torch.float32, remat=False)
LENS = (8, 16, 24, 32, 1024)   # prompts[3] is (f)'s shared prompt
LONG = 4                       # the request given the divergence


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CardFlash:
    """``ops.flash_attention``'s launch counters as the card keeps them:
    one ``flash_fwd`` for each call of the forward kernel."""

    def __init__(self):
        self.n = 0

    def launch_counts(self):
        return {"flash_fwd": self.n}

    def reset_launch_counts(self):
        self.n = 0


def test_long_prompt_divergence_is_a_finding_not_a_launch(monkeypatch,
                                                           capsys):
    # One thread a process, the server's too: the phase's tensors are
    # small, and the suite runs several files at once.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _rehearse(monkeypatch, capsys)
    finally:
        torch.set_num_threads(threads)


def _rehearse(monkeypatch, capsys):
    cs = _load_smoke()
    monkeypatch.setattr(cs, "SERVE_LENS", LENS)
    monkeypatch.setattr(cs, "SERVE_NEW", 8)
    monkeypatch.setattr(cs, "SERVE_PROFILED_STEPS", 2)
    monkeypatch.setattr(cs, "SERVE_TIMEOUT_S", 120)

    card = _CardFlash()
    real_flash = tfm.flash_attention

    def counted_flash(*a, **k):
        card.n += 1
        return real_flash(*a, **k)

    monkeypatch.setattr(tfm, "flash_attention", counted_flash)
    monkeypatch.setattr(tfm, "_use_flash",
                        lambda cfg, x, s: s >= tfm.FLASH_MIN_SEQ)

    # Each odd token's embedding row is its even neighbour's times
    # (1 - 1e-3): through the tied projection, wherever an even token
    # leads, its twin is the runner-up, 1e-3 of the leading logit below.
    real_init = tfm.init_params

    def twinned_init(cfg, generator):
        params = real_init(cfg, generator)
        emb = params["embed"]
        emb[1::2] = emb[0::2] * (1 - 1e-3)
        return params

    monkeypatch.setattr(tfm, "init_params", twinned_init)

    real_serve = cs.serve_engine
    diverged = {}

    def serve_with_divergence(model, prompts, drafter=None, **kw):
        toks, reqs, wall, cap = real_serve(model, prompts, drafter=drafter,
                                           **kw)
        if drafter is None:
            return toks, reqs, wall, cap
        # The speculative run's tokens of the long request take the
        # runner-up where the full forward's top-2 margin is least.
        # This forward is the test's own: it leaves the counts as they were.
        seq, n = prompts[LONG] + toks[LONG], card.n
        with torch.inference_mode():
            rows = model.apply(torch.tensor([seq]))[0].float()
        card.n = n
        rows = rows[len(prompts[LONG]) - 1:len(seq) - 1]
        top = torch.topk(rows, 2, dim=-1)
        scale = rows.abs().amax(-1)
        margin = (top.values[:, 0] - top.values[:, 1]) / scale
        p = int(margin.argmin())
        assert int(top.indices[p, 0]) == toks[LONG][p]
        diverged.update(p=p, margin=float(margin[p]))
        toks = [list(t) for t in toks]
        toks[LONG][p] = int(top.indices[p, 1])
        return toks, reqs, wall, cap

    monkeypatch.setattr(cs, "serve_engine", serve_with_divergence)
    card.reset_launch_counts()
    cs.serving_phase(tfm, card, fbn, "cpu rehearsal",
                     cfg=tfm.TransformerConfig(**SMALL), device="cpu")
    out = capsys.readouterr().out
    assert diverged["margin"] < cs.SERVE_TOL, diverged
    assert ("(e) speculative against (a): request 4 (prompt 1024) "
            f"diverges at generated token {diverged['p']}") in out
    # (c)'s forwards: the 1024-token request at 1024 + 7 tokens, 2 layers.
    assert "K1 launched 2 times there" in out
    assert "the serve path launched 0 hand-written kernels" in out
