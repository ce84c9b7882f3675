"""The port's conv zoo (``horovod_tpu_torch/models``: VGG, Inception V3,
the MNIST net, ResNet with distributed BN) against the JAX package's
flax models, on weights carried by ``interop.image_variables_from_jax``.

- Logits and every parameter gradient (of ``sum(logits * g)``, ``g``
  drawn with numpy) in train mode, and logits in eval mode, on the
  port's initial weights carried to JAX (``image_variables_to_jax``):
  fp32 within 1e-4 of max |JAX| (the same products summed in another
  order). A conv bias under a train-mode BN has a zero gradient in exact
  arithmetic: it is held to zero, within 1e-4 of the model's largest
  gradient. Train mode takes flax's dropout masks: the JAX forward's
  ``Dropout`` outputs come out of ``capture_intermediates`` (kept where
  nonzero; a zero there is a zero whichever the mask) and the
  ``dropout_masks`` fixture hands them to ``layers.Dropout``.
  Models and shapes: VGG16 at 2 x 32 x 32 x 3 with and without BN,
  Inception V3 at 1 x 75 x 75 x 3 (its minimum), the MNIST net at
  4 x 28 x 28 x 1, a two-stage VGG (``cfg=((1, 16), (1, 32))``, no BN)
  at 2 x 32 x 32 x 3. A max-pool picks its maximum by rounding where two
  values of a window are closer than the frameworks' rounding of the
  BN sums: on the VGG16-with-BN input of numpy seed 1 the first pool has
  two values 1.8e-6 (relative) apart, their order flips between the
  frameworks, and the first stage's gradients move 2-7% (the port's fp32
  stays within 2e-5 of the same model in float64 there). The VGG16
  inputs come from seed 7, whose smallest gap, 4.8e-5, the test asserts
  above 1e-5 before it compares.
- bf16, against JAX's bf16 run on the same weights and masks, within
  3e-2 of max |JAX|: eval and train logits of every model, and every
  parameter gradient of the models without BN whose depth keeps the
  two frameworks' bf16 roundings apart from ReLU decisions (the MNIST
  net: measured 1e-6; the two-stage VGG: 1.8e-2). The other bf16
  gradients are not compared: a ReLU input within one bf16 rounding of
  zero switches its unit between the frameworks, and so does the
  cancellation in a train-mode BN's backward, each moving a whole row
  of the next weight gradient. Measured port against JAX bf16 (of max):
  VGG16 0.1-0.23 without BN and 0.2-0.86 with it, the small ResNet up
  to 0.11, single Inception blocks 0.15-0.52; JAX's own bf16 lies as
  far from its fp32 (VGG16 0.2-0.95). The fp32 comparison holds their
  gradient arithmetic.
- Inception V3 in train mode at 1 x 75 x 75 x 3 is degenerate: the last
  feature map is 1 x 1, so its BN normalises one value per channel to
  zero, the train logits are the head bias and every other gradient is
  zero. At sizes where it is not (2 x 107 x 107, 1 x 171 x 171) JAX's
  own fp32 gradients move 0.2-0.5 of max under a 1e-6 perturbation of
  the input (pool near-ties, BN over 4-9 values), so no tolerance can
  hold the port there. Train mode is held block by block instead:
  ``InceptionA`` to ``InceptionE`` on flax's initial weights, input
  2 x S x S x 16, output, input gradient and parameter gradients within
  1e-4 in fp32 (measured 2.3e-6), the output within 3e-2 of JAX's in
  bf16.
- ``ResNet(bn_axis_name="dp")`` on 2 gloo ranks, each holding half of
  ``tests/test_data.py::TestModelAdoption``'s batch (``stage_sizes=[1]``,
  ``num_filters=8``, 4 classes, fp32, 8 x 16 x 16 x 3): logits within
  1e-4 (TestModelAdoption's rtol) of the JAX ResNet on the concatenated
  batch, and parameter gradients, summed over the ranks, within 1e-4.
- The parameter trees: VGG16's count at 1000 classes equals JAX's (on
  the ``meta`` device: nothing allocated), the state_dict keys equal
  flax's names, and ``interop`` round-trips them.
- flax's padding where it could differ: SAME on 1x7/7x1 kernels and on
  stride 2, the 3x3 SAME average pool counting its padding.
- ``build_image_train_step``'s dropout: masks differ from step to step,
  repeat when the steps are replayed with the same seed, and differ
  under another seed.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from horovod_tpu import models as jzoo
from horovod_tpu.models import inception as jinc
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import vgg as tvgg

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
JOB_TIMEOUT_S = 120


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture
def dropout_masks(monkeypatch):
    """Masks the port's ``Dropout`` layers take, in call order."""
    masks = []

    def keep_mask(self, x):
        return masks.pop(0).to(x.device)

    monkeypatch.setattr(layers.Dropout, "keep_mask", keep_mask)
    return masks


def _jax_run(model, variables, x, g, seed=0):
    """JAX's (eval logits, train logits, train gradients, dropout keep
    masks in call order) on ``variables``, jitted."""
    stats = variables.get("batch_stats", {})
    drop = {"dropout": jax.random.PRNGKey(seed + 2)}

    def loss(p):
        out, state = model.apply(
            {"params": p, "batch_stats": stats}, x, train=True, rngs=drop,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: type(mdl).__name__ ==
            "Dropout")
        return jnp.sum(out.astype(jnp.float32) * g), (out, state)

    (_, (logits, state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    inter = state.get("intermediates", {})
    masks = [np.asarray(inter[k]["__call__"][0]) != 0
             for k in sorted(inter) if k.startswith("Dropout_")]
    eval_logits = jax.jit(lambda v: model.apply(v, x, train=False))(
        variables)
    return (np.asarray(eval_logits, np.float32),
            np.asarray(logits, np.float32), jax.device_get(grads), masks)


def _under_bn(tmodel):
    """Conv biases that a train-mode BN follows: their gradient is zero
    in exact arithmetic (the BN takes the mean out), and both frameworks
    give rounding noise."""
    if not getattr(tmodel, "use_bn", False):
        return set()
    return {f"conv{n}.bias" for n in tmodel.layer_names if n != "pool"}


def _errors(tmodel, x, g, jrun, dropout_masks):
    """The port's {output: max |port - JAX| / scale} against one JAX run;
    a gradient's scale is its max |JAX|, floored at 1e-3 of the model's
    largest. A gradient that is zero in exact arithmetic (``_under_bn``)
    is held to zero instead: its max |port| over the model's largest."""
    jeval, jtrain, jgrads, masks = jrun
    xt = torch.tensor(x)
    tmodel.eval()
    with torch.no_grad():
        errs = {"eval logits": _rel(tmodel(xt), jeval)}
    tmodel.train()
    tmodel.zero_grad()
    dropout_masks.extend(torch.tensor(m) for m in masks)
    logits = tmodel(xt)
    assert not dropout_masks   # every captured mask was taken
    assert logits.dtype == torch.float32
    errs["train logits"] = _rel(logits.detach(), jtrain)
    (logits * torch.tensor(g)).sum().backward()
    want = interop.image_variables_from_jax(jgrads)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    zero = _under_bn(tmodel)
    for name, p in tmodel.named_parameters():
        w = 0.0 * want[name].numpy() if name in zero else want[name].numpy()
        scale = 1e3 * floor if name in zero else max(np.abs(w).max(), floor)
        errs[name] = float(np.abs(p.grad.float().numpy() - w).max() / scale)
    return errs


def _check(make_t, make_j, x, dtype, dropout_masks, seed=0,
           bf16_grads=False):
    """The port's model ``make_t(dtype)`` against flax's ``make_j(dtype)``
    on the port's initial weights carried to JAX, in the same dtype:
    every logit and gradient within ``TOL[dtype]``, except that in bf16
    only the logits are compared unless ``bf16_grads`` (see the module
    docstring)."""
    tmodel = make_t(DTYPES[dtype][0])
    params, stats = interop.image_variables_to_jax(tmodel.state_dict())
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    g = np.random.RandomState(seed + 5).randn(
        x.shape[0], tmodel_classes(tmodel)).astype(np.float32)
    jrun = _jax_run(make_j(DTYPES[dtype][1]), variables, jnp.asarray(x), g,
                    seed)
    errs = _errors(tmodel, x, g, jrun, dropout_masks)
    if dtype == "bfloat16" and not bf16_grads:
        errs = {k: errs[k] for k in ("eval logits", "train logits")}
    bad = {k: e for k, e in errs.items() if not e <= TOL[dtype]}
    assert not bad, bad


def _pool_gaps(model, x):
    """The smallest relative gap between the two largest values of a
    positive max-pool window, at each of a VGG's pools (train mode)."""
    gaps = []
    with torch.no_grad():
        h = torch.tensor(x).permute(0, 3, 1, 2)
        for name in model.train().layer_names:
            if name == "pool":
                n, c, hh, ww = h.shape
                win = h.reshape(n, c, hh // 2, 2, ww // 2, 2).permute(
                    0, 1, 2, 4, 3, 5).reshape(n, c, hh // 2, ww // 2, 4)
                top = win.topk(2, -1).values
                pos = top[..., 0] > 0
                gaps.append(float(((top[..., 0] - top[..., 1])
                                   / top[..., 0])[pos].min()))
                h = torch.nn.functional.max_pool2d(h, 2, 2)
                continue
            h = getattr(model, f"conv{name}")(h)
            if model.use_bn:
                h = getattr(model, f"bn{name}")(h)
            h = torch.relu(h)
    return gaps


def tmodel_classes(m):
    return m.head.out_features if hasattr(m, "head") else \
        m.fc2.out_features


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_vgg16_matches_jax(dtype, use_bn, dropout_masks):
    x = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    if use_bn:
        # A max-pool window whose two largest values lie within the
        # frameworks' rounding of the BN sums (~1e-6 relative) picks its
        # maximum by rounding and routes a gradient to another pixel.
        model = tvgg.VGG16(num_classes=10, use_bn=True,
                           dtype=torch.float32, image_size=32, device="cpu")
        assert min(_pool_gaps(model, x)) > 1e-5
    _check(lambda dt: tvgg.VGG16(num_classes=10, use_bn=use_bn, dtype=dt,
                                 image_size=32, device="cpu"),
           lambda dt: jzoo.VGG16(num_classes=10, use_bn=use_bn, dtype=dt),
           x, dtype, dropout_masks)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_inception_v3_matches_jax(dtype, dropout_masks):
    x = np.random.RandomState(2).rand(1, 75, 75, 3).astype(np.float32)
    _check(lambda dt: tinc.InceptionV3(num_classes=10, dtype=dt,
                                       device="cpu"),
           lambda dt: jzoo.InceptionV3(num_classes=10, dtype=dt),
           x, dtype, dropout_masks, seed=3)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_mnist_convnet_matches_jax(dtype, dropout_masks):
    x = np.random.RandomState(3).rand(4, 28, 28, 1).astype(np.float32)
    _check(lambda dt: tmnist.MnistConvNet(dtype=dt, device="cpu"),
           lambda dt: jzoo.MnistConvNet(dtype=dt), x, dtype, dropout_masks,
           seed=4, bf16_grads=True)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_two_stage_vgg_matches_jax(dtype, dropout_masks):
    """VGG's code (bf16 convs and fc layers, NHWC flatten, dropout, fp32
    head) at a depth where its bf16 gradients can be compared."""
    cfg = ((1, 16), (1, 32))
    x = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    _check(lambda dt: tvgg.VGG(cfg=cfg, num_classes=10, dtype=dt,
                               image_size=32, device="cpu"),
           lambda dt: jzoo.VGG(cfg=cfg, num_classes=10, dtype=dt),
           x, dtype, dropout_masks, bf16_grads=True)


INCEPTION_CIN = 16
INCEPTION_BLOCKS = {   # port block, flax block, input size
    "A": (lambda dt: tinc.InceptionA(INCEPTION_CIN, 32, dt),
          lambda dt: jinc.InceptionA(pool_features=32, dtype=dt), 9),
    "B": (lambda dt: tinc.InceptionB(INCEPTION_CIN, dt),
          lambda dt: jinc.InceptionB(dtype=dt), 9),
    "C": (lambda dt: tinc.InceptionC(INCEPTION_CIN, 16, dt),
          lambda dt: jinc.InceptionC(channels_7x7=16, dtype=dt), 9),
    "D": (lambda dt: tinc.InceptionD(INCEPTION_CIN, dt),
          lambda dt: jinc.InceptionD(dtype=dt), 11),
    "E": (lambda dt: tinc.InceptionE(INCEPTION_CIN, dt),
          lambda dt: jinc.InceptionE(dtype=dt), 5)}


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("block", sorted(INCEPTION_BLOCKS))
def test_inception_blocks_match_jax_in_train_mode(block, dtype):
    make_t, make_j, size = INCEPTION_BLOCKS[block]
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(ord(block))
    x = rs.randn(2, size, size, INCEPTION_CIN).astype(np.float32)
    jm = make_j(jdt)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x), train=False))

    def fwd(p, xx):
        return jm.apply({"params": p,
                         "batch_stats": variables["batch_stats"]}, xx,
                        train=True, mutable=["batch_stats"])[0]

    shape = jax.eval_shape(fwd, variables["params"], jnp.asarray(x)).shape
    g = rs.randn(*shape).astype(np.float32)

    def loss(p, xx):
        y = fwd(p, xx)
        return jnp.sum(y.astype(jnp.float32) * g), y
    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    tm = make_t(tdt)
    tm.load_state_dict(interop.image_variables_from_jax(
        variables["params"], variables["batch_stats"]))
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    y = tm.train()(xt).permute(0, 2, 3, 1)
    errs = {"out": _rel(y.detach().float(), jy)}
    if dtype == "float32":
        (y * torch.tensor(g)).sum().backward()
        errs["x"] = _rel(xt.grad.permute(0, 2, 3, 1), jgx)
        want = interop.image_variables_from_jax(jgp)
        errs.update({n: _rel(p.grad, want[n])
                     for n, p in tm.named_parameters()})
        assert len(errs) == 2 + len(want)
    bad = {k: e for k, e in errs.items() if not e <= TOL[dtype]}
    assert not bad, bad


def test_vgg16_parameter_count_matches_jax():
    jm = jzoo.VGG16(num_classes=1000)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    tm = tvgg.VGG16(num_classes=1000, device="meta")
    assert all(p.device.type == "meta" for p in tm.parameters())
    assert sum(p.numel() for p in tm.parameters()) == want == 138357544


@pytest.mark.parametrize("model", ["vgg_bn", "inception", "mnist"])
def test_state_dict_names_are_flax_names_and_round_trip(model):
    make = {
        "vgg_bn": (lambda: tvgg.VGG(cfg=((1, 4), (1, 8)), num_classes=4,
                                    use_bn=True, image_size=8,
                                    dtype=torch.float32, device="cpu"),
                   lambda: jzoo.VGG(cfg=((1, 4), (1, 8)), num_classes=4,
                                    use_bn=True, dtype=jnp.float32),
                   (2, 8, 8, 3)),
        "inception": (lambda: tinc.InceptionV3(num_classes=4, device="cpu"),
                      lambda: jzoo.InceptionV3(num_classes=4),
                      (1, 75, 75, 3)),
        "mnist": (lambda: tmnist.MnistConvNet(device="cpu"),
                  lambda: jzoo.MnistConvNet(), (1, 28, 28, 1))}
    tfn, jfn, shape = make[model]
    want = jax.eval_shape(lambda: jfn().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros(shape), train=False))
    sd = tfn().state_dict()
    params, stats = interop.image_variables_to_jax(sd)
    for got, tree in ((params, want["params"]),
                      (stats, want.get("batch_stats", {}))):
        lg = jax.tree_util.tree_flatten_with_path(got)[0]
        lw = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in lg] == [p for p, _ in lw]
        assert [a.shape for _, a in lg] == [a.shape for _, a in lw]
    back = interop.image_variables_from_jax(params, stats)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("kernel,size,stride,padding", [
    ((1, 7), 9, 1, "SAME"), ((7, 1), 9, 1, "SAME"), ((3, 3), 8, 2, "SAME"),
    ((3, 3), 9, 2, "VALID"), ((5, 5), 28, 1, "SAME"), ((1, 3), 3, 1, "SAME")])
def test_conv_padding_is_flax(kernel, size, stride, padding):
    import flax.linen as nn
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    conv = nn.Conv(5, kernel, (stride, stride), padding=padding)
    variables = jax.device_get(conv.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    want = conv.apply(variables, jnp.asarray(x))
    tc = layers.Conv(3, 5, kernel, stride, padding, torch.float32, bias=True)
    sd = interop.image_variables_from_jax(variables["params"])
    tc.load_state_dict(sd)
    got = tc(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel(got.detach(), want) <= 1e-5


def test_avgpool_same_counts_the_padding():
    import flax.linen as nn
    x = np.random.RandomState(0).rand(2, 5, 5, 3).astype(np.float32)
    want = nn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                       padding="SAME")
    got = tinc._avgpool_same(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-7)


def test_dropout_is_flax_in_distribution_and_identity_in_eval():
    d = layers.Dropout(0.5)
    x = torch.ones(400, 50)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert abs(float(kept.float().mean()) - 0.5) < 0.02
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)


def test_image_train_step_seeds_dropout_from_seed_and_step(monkeypatch):
    """Two steps of the MNIST net through ``build_image_train_step``
    draw different masks; the same steps replayed (the same seed, the
    step count back at 0, the same weights) draw the same ones; another
    seed draws others."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.parallel.train import build_image_train_step
    thvd.init(device="cpu")
    drawn = []
    keep_mask = layers.Dropout.keep_mask

    def record(self, x):
        drawn.append(keep_mask(self, x))
        return drawn[-1]

    monkeypatch.setattr(layers.Dropout, "keep_mask", record)
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.rand(4, 28, 28, 1).astype(np.float32))
    y = torch.tensor(rs.randint(0, 10, 4))

    def masks(seed):
        step = build_image_train_step(
            tmnist.MnistConvNet, lambda p: torch.optim.SGD(p, lr=0.1),
            device="cpu", seed=seed)
        model = step.make_model(generator=torch.Generator().manual_seed(1))
        assert model.dropout.generator is step._dropout
        opt = step.make_optimizer(model)
        drawn.clear()
        for _ in range(2):
            step(model, opt, x, y)
        assert step.steps == 2
        return list(drawn)

    first, second = masks(seed=0)
    assert first.shape == (4, 1024) and not torch.equal(first, second)
    replay = masks(seed=0)
    assert torch.equal(replay[0], first) and torch.equal(replay[1], second)
    other = masks(seed=1)
    assert not torch.equal(other[0], first)


# ---------------------------------------------------------------------------
# ResNet with distributed BN on 2 gloo ranks
# ---------------------------------------------------------------------------

WORLD = 2
RESNET = dict(stage_sizes=[1], num_classes=4, num_filters=8)


def _adoption_batch():
    return np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resnet_worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    mesh = create_mesh(dp=WORLD)
    model = ResNet(bn_axis_name="dp", mesh=mesh, dtype=torch.float32,
                   device="cpu", **RESNET)
    model.load_state_dict(torch.load(os.path.join(outdir, "sd.pt")))
    n = 8 // WORLD
    x = torch.tensor(_adoption_batch()[rank * n:(rank + 1) * n])
    g = torch.tensor(np.random.RandomState(7).randn(8, 4)
                     .astype(np.float32)[rank * n:(rank + 1) * n])
    model.train()
    logits = model(x)
    (logits * g).sum().backward()
    out = {"logits": logits.detach(),
           "grads": {k: p.grad for k, p in model.named_parameters()},
           "mean": model.bn_init.mean.clone()}
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def resnet_ref():
    jm = jzoo.ResNet(dtype=jnp.float32, **RESNET)
    x = jnp.asarray(_adoption_batch())
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), x[:2],
                                       train=False))
    g = np.random.RandomState(7).randn(8, 4).astype(np.float32)

    def loss(p):
        y, _ = jm.apply({"params": p,
                         "batch_stats": variables["batch_stats"]}, x,
                        train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), y

    (_, y), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    _, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    return variables, np.asarray(y), jax.device_get(grads), \
        jax.device_get(upd["batch_stats"])


@pytest.fixture(scope="module")
def resnet_ranks(resnet_ref, tmp_path_factory):
    variables = resnet_ref[0]
    d = tmp_path_factory.mktemp("resnet_sync_bn")
    torch.save(interop.image_variables_from_jax(variables["params"],
                                                variables["batch_stats"]),
               d / "sd.pt")
    ctx = mp.spawn(_resnet_worker, args=(_free_port(), str(d)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


def test_sync_bn_resnet_logits_match_concatenated_batch(resnet_ranks,
                                                         resnet_ref):
    _, y_ref, _, stats = resnet_ref
    got = torch.cat([r["logits"] for r in resnet_ranks]).numpy()
    np.testing.assert_allclose(got, y_ref, rtol=1e-4, atol=1e-4)
    for r in resnet_ranks:
        np.testing.assert_allclose(r["mean"].numpy(),
                                   stats["bn_init"]["mean"], rtol=1e-4,
                                   atol=1e-6)


def test_sync_bn_resnet_gradients_match_concatenated_batch(resnet_ranks,
                                                            resnet_ref):
    want = interop.image_variables_from_jax(resnet_ref[2])
    for name in want:
        got = sum(r["grads"][name] for r in resnet_ranks)
        err = _rel(got, want[name])
        assert err <= 1e-4, f"{name}: {err}"
