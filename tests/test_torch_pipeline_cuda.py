"""The pipelined flagship on the flash kernels against the plain path, on
the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a card they skip.
On a machine with one (the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py

A 4-layer bf16 LM (vocab 512, d_model 256, 2 heads of 128, d_ff 512,
seq 1024, no remat), m = 4 microbatches of 1, on 2 virtual stages in one
process: one step of each schedule (gpipe, 1f1b, zb-h1, interleaved at
V = 2) with ``use_flash=True`` (K1-K3) against the same step with
``use_flash=False`` (full attention) on the same weights and tokens, as
``chip_smoke.py``'s parity holds the flash LM to the plain one: the
loss within 1e-2, every gradient within 5e-2 of its max |value| (bf16
outputs, fp32 sums in another order). K1, K2 and K3 launch per step
(1, 1, 1) x m x layers, (2, 1, 1) for gpipe (its backward sweep
recomputes the forward) and (1, 2, 2) for zb-h1 (W walks the
activation-gradient chain again); the fp32 forms never.
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

CFG = dict(vocab=512, d_model=256, n_heads=2, n_layers=4, d_ff=512,
           max_seq=1024, dtype=torch.bfloat16, remat=False)
M, N = 4, 2
PER_MB_LAYER = {"gpipe": (2, 1, 1), "1f1b": (1, 1, 1),
                "zb-h1": (1, 2, 2), "interleaved": (1, 1, 1)}


@pytest.fixture
def cuda_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from horovod_tpu_torch.ops import _build
    _build.library()


def _step(schedule, flash):
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch.parallel import train as ttrain
    cfg = TransformerConfig(use_flash=flash, **CFG)
    v = 2 if schedule == "interleaved" else 1
    step = ttrain._virtual_pipeline_train_step(
        cfg, N, lambda p: torch.optim.SGD(p, lr=0.0), schedule=schedule,
        num_virtual=v, device="cuda")
    tree = ttrain.to_pipeline_params(
        cfg, init_params(cfg, torch.Generator().manual_seed(0)), N, v)
    models = [step.make_model(params=step.shard_params(tree, r))
              for r in range(N)]
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, CFG["vocab"], (M, 1, CFG["max_seq"] + 1),
                        generator=gen)
    fa.reset_launch_counts()
    loss = step(models, [step.make_optimizer(m) for m in models],
                tok[..., :-1].cuda(), tok[..., 1:].cuda())
    torch.cuda.synchronize()
    grads = {f"{r}.{k}": p.grad.float()
             for r, m in enumerate(models) for k, p in m.named_parameters()}
    return float(loss), grads, fa.launch_counts()


@pytest.mark.parametrize("schedule", sorted(PER_MB_LAYER))
def test_flash_pipeline_matches_plain(cuda_kernels, schedule):
    loss_f, grads_f, launches = _step(schedule, True)
    loss_p, grads_p, plain = _step(schedule, False)
    assert abs(loss_f - loss_p) <= 1e-2 * abs(loss_p)
    for k, g in grads_p.items():
        err = float((grads_f[k] - g).abs().max()
                    / g.abs().max().clamp_min(1e-30))
        assert err <= 5e-2, f"{schedule} {k}: {err}"
    k1, k2, k3 = (c * M * CFG["n_layers"] for c in PER_MB_LAYER[schedule])
    assert launches == {"flash_fwd": k1, "flash_dkv": k2, "flash_dq": k3,
                        "flash_fwd_f32": 0, "flash_dkv_f32": 0,
                        "flash_dq_f32": 0}
    assert not any(plain.values())
