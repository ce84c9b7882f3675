"""The port's ResNet and image train step against the JAX package's.

Weights are the JAX model's, carried by ``interop.resnet_variables_from_
jax`` with every BN scale drawn uniform in [0.5, 1.5] and every BN bias
from N(0, 0.1) (at initialisation bn3's scale is 0, and every gradient
inside a block except bn3's would be 0). Images and labels come from
numpy seeds. The JAX side of the fused path runs ``bn_impl="jnp"`` (the
same arithmetic as its Pallas kernels); the port runs ``"pallas"``,
which on CPU tensors is the kernels' plain versions.

Tolerance: max |port - jax| <= 1e-4 * max |jax| per tensor, fp32
throughout (convolutions and sums run in another order).
"""

import importlib.util
import socket
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F
from flax import linen as fnn

import horovod_tpu_torch as thvd
from horovod_tpu.models.resnet import ResNet as JResNet
from horovod_tpu.models.resnet import ResNet50 as JResNet50
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.parallel.train import build_image_train_step

TOL = 1e-4
SMALL = dict(stage_sizes=[1, 1], num_classes=10, num_filters=8)
# The port's bn_impl and the JAX one it is held against.
IMPLS = {"flax": "flax", "pallas": "jnp"}
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_initialized():
    thvd.init(device="cpu")
    yield


def _batch(n=4, size=32, seed=0, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def _randomised(params, seed=1):
    """Every BN scale uniform in [0.5, 1.5], every BN bias N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias" and "scale" in tree:
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out
    return walk(params)


def _jax_variables(jimpl, x, seed=0):
    jmodel = JResNet(dtype=jnp.float32, bn_impl=jimpl, **SMALL)
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=True)
    return jmodel, _randomised(jax.device_get(v["params"])), \
        jax.device_get(v["batch_stats"])


def _jax_loss_and_grads(jmodel, params, batch_stats, x, y):
    def loss_fn(p, batch_stats, x, y):
        logits, new = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                   x, train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, new["batch_stats"])

    (loss, (logits, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch_stats, x, y)
    return (float(loss), np.asarray(logits), jax.device_get(grads),
            jax.device_get(new_bs))


def _port_model(timpl, params, batch_stats, **kw):
    model = tres.ResNet(dtype=torch.float32, bn_impl=timpl, device="cpu",
                        **{**SMALL, **kw})
    model.load_state_dict(interop.resnet_variables_from_jax(params,
                                                            batch_stats))
    return model


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k], np.float32)


def _assert_trees_close(got, want, tol=TOL):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        err = np.max(np.abs(g[name] - w[name]))
        scale = max(np.max(np.abs(w[name])), 1e-30)
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("timpl", sorted(IMPLS))
def test_small_resnet_matches_jax(timpl):
    x, y = _batch()
    jmodel, params, bs = _jax_variables(IMPLS[timpl], x)
    loss, logits, grads, new_bs = _jax_loss_and_grads(jmodel, params, bs, x,
                                                      y)

    model = _port_model(timpl, params, bs)
    model.train()
    tlogits = model(torch.from_numpy(x))
    tloss = F.cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    assert tlogits.dtype == torch.float32

    err = np.max(np.abs(tlogits.detach().numpy() - logits))
    assert err <= TOL * np.max(np.abs(logits))
    assert abs(float(tloss.detach()) - loss) <= TOL * abs(loss)
    tgrads, _ = interop.resnet_variables_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(tgrads, grads)
    _, tbs = interop.resnet_variables_to_jax(model.state_dict())
    _assert_trees_close(tbs, new_bs)


def test_eval_mode_matches_jax():
    x, _ = _batch(seed=4)
    jmodel, params, bs = _jax_variables("jnp", x)
    rng = np.random.RandomState(5)
    bs = jax.tree_util.tree_map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)), bs)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": bs},
                                   jnp.asarray(x), train=False))
    model = _port_model("pallas", params, bs)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k,stride", [(3, 2), (1, 2), (3, 1)])
def test_same_padding_matches_flax(size, k, stride):
    """flax pads a 3x3 stride-2 conv on an even input (0, 1), not (1, 1)."""
    assert tres.same_pads(size, k, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0])
    if (size, k, stride) == (8, 3, 2):
        assert tres.same_pads(size, k, stride) == (0, 1)
    rng = np.random.RandomState(size + k)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    conv = fnn.Conv(6, (k, k), (stride, stride), use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    tconv = tres.Conv(4, 6, k, stride, dtype=torch.float32)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_resnet50_tree_matches_jax():
    """Names and shapes of every parameter and BN buffer against
    ``jax.eval_shape`` of the JAX ResNet50 (no forward pass)."""
    shapes = jax.eval_shape(
        lambda: JResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    want = {}
    for tree in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes[tree])[0]:
            want[".".join(p.key for p in path)] = tuple(leaf.shape)
    model = tres.ResNet50(num_classes=1000, device="cpu")
    got = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(".weight"):
            name = name[:-len("weight")] + "kernel"
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 \
                else shape[::-1]
        got[name] = shape
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 25_557_032
    bns = [m for m in model.modules() if isinstance(m, tres._Norm)]
    assert len(bns) == 53 and all(isinstance(m, tres.BatchNorm) for m in bns)
    fused = tres.ResNet50(num_classes=1000, bn_impl="pallas", device="cpu")
    assert list(fused.state_dict()) == list(model.state_dict())
    assert sum(isinstance(m, tres.FusedBNAct) for m in fused.modules()) == 53


def test_resnet_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        tres.ResNet([1], bn_axis_name="dp", device="cpu")
    with pytest.raises(ValueError):
        tres.ResNet([1], bn_impl="palas", device="cpu")


def _bench_build_step():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.build_step


@pytest.mark.parametrize("timpl", sorted(IMPLS))
def test_three_train_steps_match_bench_step(timpl):
    lr, steps = 0.1, 3
    x, y = _batch(n=4, seed=6)
    jmodel, params, bs = _jax_variables(IMPLS[timpl], x)
    opt = optax.sgd(lr, momentum=0.9)
    train_k = _bench_build_step()(jmodel, opt)
    jp, jbs, _ = train_k(jax.tree_util.tree_map(jnp.asarray, params),
                         jax.tree_util.tree_map(jnp.asarray, bs),
                         opt.init(params), jnp.asarray(x), jnp.asarray(y),
                         steps)

    step = build_image_train_step(
        partial(tres.ResNet, dtype=torch.float32, bn_impl=timpl, **SMALL),
        lambda p: torch.optim.SGD(p, lr=lr * thvd.size(), momentum=0.9),
        device="cpu")
    model = step.make_model()
    model.load_state_dict(interop.resnet_variables_from_jax(params, bs))
    topt = step.make_optimizer(model)
    losses = [float(step(model, topt, torch.from_numpy(x),
                         torch.from_numpy(y).long())) for _ in range(steps)]
    assert losses[-1] < losses[0]
    tp, tbs = interop.resnet_variables_to_jax(model.state_dict())
    _assert_trees_close(tp, jax.device_get(jp))
    _assert_trees_close(tbs, jax.device_get(jbs))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_worker(rank, port, x, y, params, bs, want):
    thvd.shutdown()
    thvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
              world_size=2)
    step = build_image_train_step(
        partial(tres.ResNet, dtype=torch.float32, bn_impl="pallas", **SMALL),
        lambda p: torch.optim.SGD(p, lr=0.01 * thvd.size(), momentum=0.9),
        device="cpu")
    model = step.make_model(generator=torch.Generator().manual_seed(rank))
    if rank == 0:
        model.load_state_dict(interop.resnet_variables_from_jax(params, bs))
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = step.make_optimizer(model)
    half = slice(2 * rank, 2 * rank + 2)
    loss = step(model, opt, torch.from_numpy(x[half]),
                torch.from_numpy(y[half]).long())
    assert abs(float(loss) - want["loss"]) <= TOL * abs(want["loss"])
    # After step() each p.grad holds the gradient averaged over the ranks.
    grads, _ = interop.resnet_variables_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    _assert_trees_close(grads, want["grads"])
    _, tbs = interop.resnet_variables_to_jax(model.state_dict())
    _assert_trees_close(tbs, want["batch_stats"][rank])
    thvd.shutdown()


def test_two_ranks_average_gradients_and_keep_their_own_bn_stats():
    """Each rank normalises with its own half-batch statistics, as the JAX
    dp step does without ``bn_axis_name``."""
    x, y = _batch(n=4, seed=8)
    jmodel, params, bs = _jax_variables("jnp", x)
    halves = [_jax_loss_and_grads(jmodel, params, bs, x[s], y[s])
              for s in (slice(0, 2), slice(2, 4))]
    want = {
        "loss": (halves[0][0] + halves[1][0]) / 2,
        "grads": jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                        halves[0][2], halves[1][2]),
        "batch_stats": [h[3] for h in halves],
    }
    mp.spawn(_two_rank_worker, args=(_free_port(), x, y, params, bs, want),
             nprocs=2, join=True)
