"""The decode path and the serving engine on the card: the clamping cases
and the in-place pool, as ``tests/test_torch_decode.py`` holds them on
the CPU.

These need an NVIDIA GPU; without one they skip. On a machine with one
(the repo's conftest imports JAX, so leave it out):

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

An out-of-range index is a device-side assert on CUDA, so a missing
clamp fails here where the CPU would raise an IndexError. Each case
runs the same calls on the card and on the CPU (fp32, TF32 off) and
holds the card's logits within 1e-4 of the CPU's largest |logit|, the
pools' payload exactly (int8) or within 1e-4 (fp32), and the pools'
``data_ptr()``s unchanged by every call.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as ttfm

pytestmark = pytest.mark.cuda

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=64, dtype=torch.float32, remat=False)
BS, N_BLOCKS = 4, 40


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _calls():
    rng = np.random.RandomState(7)
    long = rng.randint(0, 64, size=(1, 64))
    table = np.arange(1, 17)[None]
    return {
        # 20 tokens from 56, padded to a 32-bucket: positions 56-87.
        "padded_prefill": [(long[:, :56], 0, True, table),
                           (np.concatenate([long[:, 56:], rng.randint(
                               0, 64, size=(1, 24))], 1), 56, True, table)],
        # a speculative verify chunk of 4 at positions 62-65
        "spec_verify": [(long[:, :62], 0, True, table),
                        (long[:, 58:62], 62, False, table)],
    }


def _run(model, calls, kv, dev):
    cache = model.init_cache(N_BLOCKS, BS, kv)
    ptrs = [t.data_ptr() for layer in cache for t in layer.values()]
    out = []
    with torch.inference_mode():
        for tok, start, exact, table in calls:
            lg, _ = model.apply_decode(
                torch.as_tensor(tok, device=dev),
                torch.tensor([start], device=dev),
                torch.as_tensor(table, device=dev), cache, kv_quant=kv,
                exact_chunk=exact)
            out.append(lg.float().cpu().numpy())
    assert [t.data_ptr() for layer in cache for t in layer.values()] == ptrs
    return out, cache


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("case", ["padded_prefill", "spec_verify"])
def test_clamped_decode_on_the_card(card, case, kv):
    gen = torch.Generator().manual_seed(0)
    params = ttfm.init_params(ttfm.TransformerConfig(**CFG), gen)
    cpu = ttfm.Transformer(ttfm.TransformerConfig(**CFG), params=params,
                           device="cpu")
    gpu = ttfm.Transformer(ttfm.TransformerConfig(**CFG), params=params,
                           device=card)
    calls = _calls()[case]
    want, want_cache = _run(cpu, calls, kv, "cpu")
    got, got_cache = _run(gpu, calls, kv, card)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w))
    for layer, ref in zip(got_cache, want_cache):
        k, r = layer["k"][1:].cpu(), ref["k"][1:]
        if kv is None:
            assert torch.max(torch.abs(k - r)) <= 1e-4 * torch.max(r.abs())
        else:
            assert torch.mean((k != r).float()) <= 1e-3


def test_engine_serves_on_the_card(card):
    from horovod_tpu_torch.serving import InferenceEngine, ServingConfig
    model = ttfm.Transformer(ttfm.TransformerConfig(**CFG), device=card)
    cpu = ttfm.Transformer(ttfm.TransformerConfig(**CFG), device="cpu",
                           params=model.params_tree())
    cfg = ServingConfig(block_size=BS, kv_blocks=N_BLOCKS, max_batch_slots=4,
                        max_new_tokens=8, min_prefill_bucket=8)
    prompts = [[1, 2, 3], [5] * 11, [7] * 60]
    outs = []
    for m in (model, cpu):
        eng = InferenceEngine(m, cfg, device=m.device)
        ptrs = [t.data_ptr() for layer in eng._cache for t in layer.values()]
        reqs = [eng.submit(p, max_new_tokens=min(8, 64 - len(p)))
                for p in prompts]
        eng.run_until_idle()
        assert [t.data_ptr() for layer in eng._cache
                for t in layer.values()] == ptrs
        outs.append([r.result(timeout=60) for r in reqs])
    assert outs[0] == outs[1]
