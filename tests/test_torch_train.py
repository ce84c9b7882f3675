"""Three data-parallel train steps of the port against the JAX package's
``build_train_step`` on a one-device mesh, from the same parameters and
tokens, with SGD and Adam and every hyperparameter set on both sides.

Tolerances: per-step loss rtol 1e-5; final parameters rtol 1e-4 with
atol 1e-6 (fp32 throughout; gradients sum in another order, and Adam's
normalised step magnifies that where a gradient is near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import create_mesh
from horovod_tpu.parallel.train import build_train_step as jax_build
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.parallel.train import build_train_step

CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq=32, remat=False)
LR = 0.05
BETAS = (0.9, 0.999)
EPS = 1e-8

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(LR),
            lambda p: torch.optim.SGD(p, lr=LR, momentum=0.0)),
    "adam": (lambda: optax.adam(LR * 0.1, b1=BETAS[0], b2=BETAS[1],
                                eps=EPS),
             lambda p: torch.optim.Adam(p, lr=LR * 0.1, betas=BETAS,
                                        eps=EPS, weight_decay=0.0)),
}


@pytest.fixture(autouse=True)
def _port_initialized():
    thvd.init(device="cpu")
    yield


def _batch(seed=5, b=4, s=32):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, CFG["vocab"], size=(b, s + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("use_flash", [False, True])
def test_three_steps_match_jax(opt_name, use_flash):
    make_jax_opt, torch_factory = OPTIMIZERS[opt_name]
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, use_flash=use_flash,
                                  **CFG)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, use_flash=use_flash,
                                  **CFG)
    tree = jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(11)))
    tok, tgt = _batch()

    mesh = create_mesh(dp=1, devices=jax.devices()[:1])
    opt = make_jax_opt()
    make, shard_p, shard_b = jax_build(jcfg, mesh, opt)
    state = opt.init(tree)
    jstep, _ = make(tree, state)
    params = shard_p(tree)
    jlosses = []
    for _ in range(3):
        params, state, loss = jstep(params, state, shard_b(jnp.asarray(tok)),
                                    shard_b(jnp.asarray(tgt)))
        jlosses.append(float(loss))

    step = build_train_step(tcfg, torch_factory, device="cpu")
    model = step.make_model()
    model.load_state_dict(interop.params_from_jax(tree))
    topt = step.make_optimizer(model)
    ttok = torch.from_numpy(tok).long()
    ttgt = torch.from_numpy(tgt).long()
    tlosses = [float(step(model, topt, ttok, ttgt)) for _ in range(3)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = interop.params_from_jax(jax.device_get(params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_step_needs_a_distributed_optimizer():
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    step = build_train_step(tcfg, lambda p: torch.optim.SGD(p, lr=0.1),
                            device="cpu")
    model = step.make_model()
    tok, tgt = _batch()
    with pytest.raises(TypeError):
        step(model, torch.optim.SGD(model.parameters(), lr=0.1),
             torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())


@pytest.mark.parametrize("bucket_mb", ["0.02", "0"])
def test_three_steps_match_jax_through_small_buckets(monkeypatch, bucket_mb):
    """The same three SGD steps with the gradients in several buckets
    fired from the hooks, and with one request per gradient."""
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUCKET_MB", bucket_mb)
    make_jax_opt, torch_factory = OPTIMIZERS["sgd"]
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    tree = jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(11)))
    tok, tgt = _batch()
    mesh = create_mesh(dp=1, devices=jax.devices()[:1])
    opt = make_jax_opt()
    make, shard_p, shard_b = jax_build(jcfg, mesh, opt)
    state = opt.init(tree)
    jstep, _ = make(tree, state)
    params = shard_p(tree)
    jlosses = []
    for _ in range(3):
        params, state, loss = jstep(params, state, shard_b(jnp.asarray(tok)),
                                    shard_b(jnp.asarray(tgt)))
        jlosses.append(float(loss))

    step = build_train_step(tcfg, torch_factory, device="cpu")
    model = step.make_model()
    model.load_state_dict(interop.params_from_jax(tree))
    topt = step.make_optimizer(model)
    assert len(topt._buckets) == (0 if bucket_mb == "0" else 4)
    ttok = torch.from_numpy(tok).long()
    ttgt = torch.from_numpy(tgt).long()
    tlosses = [float(step(model, topt, ttok, ttgt)) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    if bucket_mb != "0":
        assert topt.bucket_fires == {"hook": 12, "flush": 0}
    want = interop.params_from_jax(jax.device_get(params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("model_kind", ["lm", "resnet"])
def test_int8_blockwise_steps_are_finite_and_fall(model_kind):
    """Both train steps on the block-quantized wire with per-bucket error
    feedback: five steps, losses finite and falling."""
    from functools import partial
    from horovod_tpu_torch.models import resnet as tres
    from horovod_tpu_torch.parallel.train import build_image_train_step
    int8 = thvd.Compression.int8_blockwise
    if model_kind == "lm":
        tcfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
        step = build_train_step(tcfg, OPTIMIZERS["adam"][1], device="cpu")
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        tok, tgt = _batch()
        batch = (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    else:
        step = build_image_train_step(
            partial(tres.ResNet, stage_sizes=[1, 1], num_classes=10,
                    num_filters=8, dtype=torch.float32, bn_impl="pallas"),
            lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
            device="cpu")
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        rng = np.random.RandomState(3)
        batch = (torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32)),
                 torch.from_numpy(rng.randint(0, 10, 4)).long())
    opt = thvd.DistributedOptimizer(
        step.optimizer_factory(model.parameters()),
        named_parameters=model.named_parameters(), compression=int8,
        bucket_cap_mb=0.02)
    losses = [float(step(model, opt, *batch)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert len(opt._bucket_residuals) == len(opt._buckets) > 1
