"""The port's flagship transformer against the JAX package's: parameters
drawn by the JAX ``init_params``, carried over with
``interop.params_from_jax``, then ``apply`` logits, ``loss_fn`` and the
loss gradients compared on the same tokens.

Tolerances: fp32 rtol 1e-5 on logits and loss (1e-4 with atol 1e-6 on
gradients: backprop through softmax and layernorm sums in another
order); bf16 2e-2 relative to the largest logit (activations round to
bf16 at different points in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as ttfm

SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=32)


def _configs(jdtype=jnp.float32, tdtype=torch.float32, **over):
    kw = dict(SMALL, remat=False)
    kw.update(over)
    return (jtfm.TransformerConfig(dtype=jdtype, **kw),
            ttfm.TransformerConfig(dtype=tdtype, **kw))


def _params(jcfg, seed=0):
    return jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(seed)))


def _model(tcfg, tree):
    model = ttfm.Transformer(tcfg, device="cpu")
    model.load_state_dict(interop.params_from_jax(tree))
    return model


def _tokens(b=2, s=32, vocab=64, seed=3):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, size=(b, s + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


FP32_CASES = {
    "full_attention": dict(use_flash=False),
    "flash": dict(use_flash=True),
    "loss_chunk": dict(use_flash=False, loss_chunk=8),
    "remat": dict(use_flash=False, remat=True),
    "remat_flash_chunk": dict(use_flash=True, remat=True, loss_chunk=16),
}


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_fp32_matches_jax(case):
    jcfg, tcfg = _configs(**FP32_CASES[case])
    tree = _params(jcfg)
    tok, tgt = _tokens()
    model = _model(tcfg, tree)
    ttok, ttgt = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()

    want_logits = np.asarray(jtfm.apply(tree, jnp.asarray(tok), jcfg))
    got_logits = model.apply(ttok).detach().numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5,
                               atol=1e-5)

    want_loss, want_g = jax.value_and_grad(jtfm.loss_fn)(
        tree, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    loss = model.loss_fn(ttok, ttgt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_sd = interop.params_from_jax(jax.device_get(want_g))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_flash", [False, True])
def test_bf16_matches_jax(use_flash):
    jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16, use_flash=use_flash)
    tree = _params(jcfg, seed=1)
    tok, tgt = _tokens(seed=4)
    model = _model(tcfg, tree)
    want = np.asarray(jtfm.apply(tree, jnp.asarray(tok), jcfg))
    got = model.apply(torch.from_numpy(tok).long()).detach().numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= 2e-2 * np.max(np.abs(want))
    want_loss = float(jtfm.loss_fn(tree, jnp.asarray(tok), jnp.asarray(tgt),
                                   jcfg))
    got_loss = float(model.loss_fn(torch.from_numpy(tok).long(),
                                   torch.from_numpy(tgt).long()).detach())
    assert abs(got_loss - want_loss) <= 2e-2 * abs(want_loss)


def test_interop_round_trip():
    jcfg, tcfg = _configs()
    tree = _params(jcfg, seed=2)
    sd = interop.params_from_jax(tree)
    model = ttfm.Transformer(tcfg, device="cpu")
    assert sorted(sd) == sorted(model.state_dict())
    back = interop.params_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # Same layout, no transpose: wq is [d, d] as x @ W, wi is [d, f].
    assert tuple(sd["layers.0.wi"].shape) == (32, 64)
    assert tuple(sd["embed"].shape) == (64, 32)


@pytest.mark.parametrize("d_model", [64, 128, 256, 448, 768, 1024])
def test_head_count_derivation_matches_jax(d_model):
    assert (ttfm.TransformerConfig(d_model=d_model).n_heads
            == jtfm.TransformerConfig(d_model=d_model).n_heads)


def test_param_shapes_match_jax_init():
    jcfg, tcfg = _configs()
    tree = _params(jcfg)
    ours = ttfm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ({k: tuple(v.shape) for k, v in
             interop.params_from_jax(tree).items()}
            == {k: tuple(v.shape) for k, v in
                ttfm.Transformer(tcfg, params=ours,
                                 device="cpu").state_dict().items()})


# Expert parallelism is ported now: its options make a config, and the
# model refuses them without a mesh that holds their axes.
@pytest.mark.parametrize("over", [dict(ep_axis="ep"),
                                  dict(ep_axis="ep", num_experts=4),
                                  dict(ep_axis="ep", tp_axis="tp",
                                       sp_axis="sp")])
def test_unported_options_raise(over):
    cfg = ttfm.TransformerConfig(**over)
    with pytest.raises(ValueError, match="mesh"):
        ttfm.Transformer(cfg, device="cpu")
