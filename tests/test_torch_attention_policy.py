"""The transformer's auto attention policy (``use_flash=None``).

On CUDA from S = 1024 in bf16 the policy picks the flash kernels at any
head dim, as the JAX policy does; the kernels are built for the head
dims in ``flash_attention.HEAD_DIMS`` (96 among them, stored 128 wide
with its last 32 columns zero). The first test checks the policy itself
on the CPU; the second trains a head_dim-96 model on the card and needs
an NVIDIA GPU and ``nvcc`` (``cuda`` marker; it skips without a card):

    python -m pytest --noconftest -m cuda tests/test_torch_attention_policy.py
"""

from types import SimpleNamespace

import pytest
import torch

from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("d_model,n_heads,dtype,flash", [
    (768, 6, torch.bfloat16, True), (768, 12, torch.bfloat16, True),
    (768, 8, torch.bfloat16, True), (768, 6, torch.float32, False)])
def test_auto_flash_policy_takes_the_kernels_head_dims(d_model, n_heads,
                                                       dtype, flash):
    cfg = tfm.TransformerConfig(d_model=d_model, n_heads=n_heads,
                                dtype=dtype)
    on_card = SimpleNamespace(is_cuda=True)
    assert tfm._use_flash(cfg, on_card, 1024) is flash
    assert tfm._use_flash(cfg, on_card, 1023) is False
    if flash:
        assert d_model // n_heads in fa.HEAD_DIMS


@pytest.mark.cuda
def test_auto_policy_runs_head_dim_96_on_the_kernels():
    """d_model 768 with 8 heads in bf16 at S = 1024: one launch of each
    flash kernel, and the loss and gradients of the same weights on full
    attention (``use_flash=False``) within 1e-2 and 5e-2 of max |plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(vocab=128, d_model=768, n_heads=8, n_layers=1, d_ff=1024,
              max_seq=1024, dtype=torch.bfloat16, remat=False)
    params = tfm.init_params(tfm.TransformerConfig(**kw),
                             torch.Generator().manual_seed(0))
    tok = torch.randint(0, 128, (1, 1025),
                        generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    for use_flash in (None, False):
        model = tfm.Transformer(tfm.TransformerConfig(use_flash=use_flash,
                                                      **kw),
                                params=params, device="cuda")
        fa.reset_launch_counts()
        loss = model.loss_fn(tok[:, :-1], tok[:, 1:])
        loss.backward()
        out[use_flash] = (float(loss), fa.launch_counts(),
                          {n: p.grad.float()
                           for n, p in model.named_parameters()})
    (lf, counts, gf), (lp, plain_counts, gp) = out[None], out[False]
    assert counts == {"flash_fwd": 1, "flash_dkv": 1, "flash_dq": 1,
                      "flash_fwd_f32": 0, "flash_dkv_f32": 0,
                      "flash_dq_f32": 0}
    assert sum(plain_counts.values()) == 0
    assert abs(lf - lp) <= 1e-2 * abs(lp)
    for n in gp:
        err = (gf[n] - gp[n]).abs().max() / gp[n].abs().max()
        assert float(err) <= 5e-2, n
