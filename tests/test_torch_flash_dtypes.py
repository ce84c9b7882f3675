"""The flash attention of the port in fp16 and fp32 and at head dims up
to 256, against the JAX package's ``horovod_tpu/ops/flash_attention.py``.

On the CPU the kernels' plain versions run (the kernels themselves are
held to them on the card: ``tests/test_torch_flash_cuda.py`` and
``chip_smoke.py`` phase 3). Inputs are drawn with numpy from fixed
seeds and handed to both packages.

- The plain versions in fp32 and fp16, forward and gradients through
  ``flash_attention``, against JAX's ``flash_attention(...,
  interpret=True)`` at head dims {8, 16, 48, 80, 160, 256}, causal and
  not. Tolerances (of max |JAX|): fp32 2e-5 (gradients 1e-4), fp16 1e-3
  (gradients 2e-3): the two packages round the fp16 P and dS at the same
  points, and differ by the order of their fp32 sums and by the
  occasional one-ulp fp16 rounding that order flips (measured: fp16
  2.2e-4 and 5.1e-4 at most over the cases, fp32 8.1e-7 and 1.1e-6).
- The head-dim padding (``fwd_padded`` / ``bwd_padded``, the wrappers'
  path for a head dim that is not a multiple of 16) on the plain
  versions: padded then cut is bit for bit the unpadded result, in
  bf16, fp16 and fp32. Past 256 the kernels get the head dim padded to
  a multiple of 128 (the _wide kernels' chunks), and only a head dim
  <= 0 raises.
- ``_qscale``: the scale rounded to each operand dtype as JAX's
  weak-typed ``q * scale`` rounds it.
- The model of JAX's ``tests/test_flash_attention.py``
  (``TestTransformerFlash``: fp32, head dim 8, ``use_flash=True``) on
  the port through ``interop``: loss within 1e-5, gradients 1e-4.
- The automatic flash choice: JAX's rule (from 1024 attended tokens on
  the compiled backend) at every dtype.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import flash_attention as tfa

HEAD_DIMS = (8, 16, 48, 80, 160, 256)
TOL = {"float32": (2e-5, 1e-4), "float16": (1e-3, 2e-3)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_plain_versions_match_jax(dtype, d, causal):
    tdt, jdt = DTYPES[dtype]
    q, k, v, g = _inputs((1, 40, 2, d), seed=d + 7 * causal)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, None, None, True)
        return (o.astype(jnp.float32) * g).sum(), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal)
    (to.float() * torch.tensor(g)).sum().backward()
    assert to.dtype == tdt
    out_tol, grad_tol = TOL[dtype]
    assert _rel(to.detach().float(), jo.astype(jnp.float32)) <= out_tol
    for t, j in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == tdt
        assert _rel(t.grad.float(), j.astype(jnp.float32)) <= grad_tol


@pytest.mark.parametrize("d", [8, 24, 40, 100, 250])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dim_padding_is_exact(dtype, d):
    tdt = DTYPES[dtype][0]
    assert tfa.padded_head_dim(d) == -(-d // 16) * 16
    q, k, v, do = (torch.tensor(x).to(tdt)
                   for x in _inputs((3, 33, d), seed=d))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd_reference(q, k, v, scale, True)
    po, plse = tfa.fwd_padded(tfa.flash_fwd_reference, q, k, v, scale, True)
    assert po.shape == o.shape and po.is_contiguous()
    assert torch.equal(po, o) and torch.equal(plse, lse)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa.flash_bwd_reference(q, k, v, do, lse, delta, scale, True)
    got = tfa.bwd_padded(tfa.flash_bwd_reference, q, k, v, do, lse, delta,
                         scale, True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_head_dims_past_256_raise():
    """Head dims past 256 no longer raise (they pad to the _wide
    kernels' 128-column chunks); only a head dim <= 0 does."""
    assert tfa.HEAD_DIMS == tuple(range(16, 257, 16))
    assert tfa.padded_head_dim(256) == 256
    assert tfa.padded_head_dim(257) == 384
    for d in (0, -16):
        with pytest.raises(ValueError, match="positive"):
            tfa.padded_head_dim(d)


@pytest.mark.parametrize("d", [257, 272, 300, 320, 384, 400, 512, 1000])
def test_wide_head_dims_launch_at_whole_chunks(d):
    """Above 256 the wrappers hand the kernels the head dim zero-padded
    to a multiple of ``WIDE_CHUNK`` (the _wide kernels' 128-column
    chunks) and cut every output back to ``d``."""
    width = -(-d // tfa.WIDE_CHUNK) * tfa.WIDE_CHUNK
    assert tfa.padded_head_dim(d) == width
    q, k, v, do = (torch.randn(2, 5, d) for _ in range(4))
    seen = []

    def fwd(*args):
        seen.append(tuple(a.shape for a in args[:3]))
        return torch.zeros(2, 5, width), torch.zeros(2, 5, 1)

    def bwd(*args):
        seen.append(tuple(a.shape for a in args[:4]))
        return tuple(torch.zeros(2, 5, width) for _ in range(3))

    o, _ = tfa.fwd_padded(fwd, q, k, v, 0.1, True)
    grads = tfa.bwd_padded(bwd, q, k, v, do, None, None, 0.1, True)
    assert seen == [((2, 5, width),) * 3, ((2, 5, width),) * 4]
    assert o.shape == (2, 5, d) and o.is_contiguous()
    assert all(g.shape == (2, 5, d) and g.is_contiguous() for g in grads)


@pytest.mark.parametrize("d,key", [(256, "flash_fwd_f16"),
                                   (384, "flash_fwd_f16_wide"),
                                   (512, "flash_fwd_f16_wide")])
def test_wide_launches_count_under_their_own_keys(monkeypatch, d, key):
    """One entry point serves both kernel families; a launch above
    ``HEAD_DIMS[-1]`` is counted under the form's ``_wide`` key."""
    lib = SimpleNamespace(hvd_flash_fwd_f16=lambda *args: 0)
    monkeypatch.setattr(tfa, "library", lambda: lib)
    tfa.reset_launch_counts()
    tfa._launch("flash_fwd_f16", d)
    counts = tfa.launch_counts()
    tfa.reset_launch_counts()
    assert counts == {**{n: 0 for n in counts}, key: 1}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_qscale_rounds_to_the_operand_dtype_as_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    for d in (8, 48, 80, 96, 128, 160, 256):
        scale = d ** -0.5
        want = float((jnp.ones((), jdt) * scale).astype(jnp.float32))
        assert tfa._qscale(scale, tdt) == want, d


def test_head_dim_8_fp32_model_matches_jax():
    """JAX's ``TestTransformerFlash.test_use_flash_train_step`` model on
    the port: the same parameters, tokens and loss."""
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=32, use_flash=True, remat=False)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **kw)
    rng = jax.random.PRNGKey(0)
    tree = jax.device_get(jtfm.init_params(jcfg, rng))
    tokens = np.asarray(jax.random.randint(rng, (2, 32), 0, 64))

    def jloss(p):
        logits = jtfm.apply(p, jnp.asarray(tokens), jcfg)
        oh = jax.nn.one_hot(jnp.roll(tokens, -1, axis=1), 64)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * oh, axis=-1))

    want_loss, want_g = jax.value_and_grad(jloss)(tree)
    model = ttfm.Transformer(ttfm.TransformerConfig(dtype=torch.float32,
                                                    **kw), device="cpu")
    model.load_state_dict(interop.params_from_jax(tree))
    ttok = torch.tensor(tokens).long()
    logits = model.apply(ttok)
    tgt = torch.roll(ttok, -1, dims=1)
    loss = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None]).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want_sd = interop.params_from_jax(jax.device_get(want_g))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * float(
                                       want_sd[name].abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_auto_flash_choice_is_jax_rule_at_every_dtype(dtype):
    """JAX picks its compiled kernels from 1024 attended tokens whatever
    the dtype (``horovod_tpu/models/transformer.py``: ``not flash_interp
    and attended_s >= 1024``); the port's counterpart of a compiled
    backend is a CUDA tensor."""
    cfg = ttfm.TransformerConfig(d_model=768, n_heads=6,
                                 dtype=DTYPES[dtype][0])
    on_card = SimpleNamespace(is_cuda=True)
    on_cpu = SimpleNamespace(is_cuda=False)
    for s in (512, 1023, 1024, 2048):
        assert ttfm._use_flash(cfg, on_card, s) is (s >= 1024)
        assert ttfm._use_flash(cfg, on_cpu, s) is False
