"""The port's distributed batch norm (``horovod_tpu_torch/data/sync_bn.py``)
against the JAX package's: the contract of ``tests/test_data.py::
TestSyncBatchNorm`` (B=16, C=6, NHWC ``[16, 5, 5, 6]``) on a 4-rank gloo
job, each rank holding a quarter of the batch.

- Forward, running statistics, and parameter and input gradients within
  rtol 1e-5 of flax ``nn.BatchNorm`` on the concatenated batch and of
  JAX's ``SyncBatchNorm`` under ``shard_map`` over 4 virtual CPU devices.
  The loss is the sum of ``sin(y)`` over the concatenated batch: JAX's
  test forms it as a psum of each shard's sum. In the port psum's
  backward is a psum of the cotangents (JAX's transpose under
  ``check_vma=False``), so a psum'd loss would scale every gradient by
  the world size; each rank's backward starts from its own shard's sum,
  the stats all-reduce's backward carries the cross-rank terms, and the
  parameter gradients are summed over the ranks, as the optimizer's
  all-reduce does.
- Exactly one all-reduce per training call, of the concatenated fp32
  ``[2C]`` buffer (``dist.all_reduce`` counted), and none in eval mode,
  which normalizes with the running statistics; ``allreduce_count``
  counts the one.
- In this process: local mode (``axis_name=None``) against flax's
  ``nn.BatchNorm``; ``ResNet(bn_impl="pallas", bn_axis_name="dp")``
  raises JAX's ``ValueError``; a sync-BN ResNet keeps the local
  ResNet's state_dict keys.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 120
WORLD = 4
B, C = 16, 6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _params():
    rng = np.random.RandomState(0)
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    return scale, bias


def _x():
    return np.random.RandomState(1).randn(B, 5, 5, C).astype(np.float32)


def _worker(rank, port, outdir):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import sync_bn
    from horovod_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    mesh = create_mesh(dp=WORLD)
    n = B // WORLD
    x = torch.tensor(_x()[rank * n:(rank + 1) * n], requires_grad=True)
    scale, bias = _params()
    bn = sync_bn.SyncBatchNorm(C, axis_name="dp", mesh=mesh, device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))

    calls = []
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append((tuple(t.shape), t.dtype))
        return real(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        sync_bn.reset_allreduce_count()
        y = bn(x)
        fwd_calls = list(calls)
        counted_fwd = sync_bn.allreduce_count()
        local = torch.sin(y).sum()
        calls.clear()
        local.backward()
        bwd_calls = list(calls)
        calls.clear()
        bn.eval()
        y_eval = bn(x.detach())
        eval_calls = list(calls)
    finally:
        dist.all_reduce = real
    total = local.detach().clone()
    dist.all_reduce(total)
    out = {"y": y.detach(), "gx": x.grad, "gscale": bn.scale.grad,
           "gbias": bn.bias.grad, "mean": bn.mean.clone(),
           "var": bn.var.clone(), "loss": float(total),
           "fwd_calls": fwd_calls, "bwd_calls": bwd_calls,
           "eval_calls": eval_calls, "counted": counted_fwd,
           "y_eval": y_eval}
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync_bn")
    ctx = mp.spawn(_worker, args=(_free_port(), str(d)), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]


def _variables():
    import jax.numpy as jnp
    scale, bias = _params()
    return {"params": {"scale": jnp.asarray(scale),
                       "bias": jnp.asarray(bias)},
            "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}


@pytest.fixture(scope="module")
def flax_ref():
    """flax ``nn.BatchNorm`` on the concatenated batch: (y, running
    stats, d scale, d bias, dx, loss)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    x, variables = jnp.asarray(_x()), _variables()
    ref = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    y, upd = ref.apply(variables, x, mutable=["batch_stats"])

    def loss(params, xs):
        out, _ = ref.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, xs,
                           mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out))

    g, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    return {"y": y, "mean": upd["batch_stats"]["mean"],
            "var": upd["batch_stats"]["var"], "gscale": g["scale"],
            "gbias": g["bias"], "gx": gx,
            "loss": loss(variables["params"], x)}


@pytest.fixture(scope="module")
def jax_sync_ref():
    """JAX's ``SyncBatchNorm`` under ``shard_map`` over 4 virtual CPU
    devices, TestSyncBatchNorm's setup."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.data.sync_bn import SyncBatchNorm
    from horovod_tpu.parallel import collectives as coll
    x, variables = jnp.asarray(_x()), _variables()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    sbn = SyncBatchNorm(use_running_average=False, axis_name="dp")
    y, upd = jax.jit(jax.shard_map(
        lambda xs: sbn.apply(variables, xs, mutable=["batch_stats"]),
        mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P())))(x)
    stats = variables["batch_stats"]

    def loss(params, xs):
        def shard(xx):
            out, _ = sbn.apply({"params": params, "batch_stats": stats},
                               xx, mutable=["batch_stats"])
            return coll.psum(jnp.sum(jnp.sin(out)), "dp")
        return jax.shard_map(shard, mesh=mesh, in_specs=P("dp"),
                             out_specs=P())(xs)

    g, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    return {"y": y, "mean": upd["batch_stats"]["mean"],
            "var": upd["batch_stats"]["var"], "gscale": g["scale"],
            "gbias": g["bias"], "gx": gx}


def _gathered(ranks):
    return {"y": torch.cat([r["y"] for r in ranks]).numpy(),
            "gx": torch.cat([r["gx"] for r in ranks]).numpy(),
            "gscale": sum(r["gscale"] for r in ranks).numpy(),
            "gbias": sum(r["gbias"] for r in ranks).numpy(),
            "mean": ranks[0]["mean"].numpy(), "var": ranks[0]["var"].numpy()}


@pytest.mark.parametrize("ref", ["flax_ref", "jax_sync_ref"])
def test_forward_and_running_stats_match(ranks, ref, request):
    want = request.getfixturevalue(ref)
    got = _gathered(ranks)
    np.testing.assert_allclose(got["y"], np.asarray(want["y"]), rtol=1e-5,
                               atol=1e-6)
    for k in ("mean", "var"):
        for r in ranks:   # every rank folds the same global moments
            np.testing.assert_allclose(r[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5)


@pytest.mark.parametrize("ref", ["flax_ref", "jax_sync_ref"])
def test_gradients_match(ranks, ref, request):
    want = request.getfixturevalue(ref)
    got = _gathered(ranks)
    for k in ("gscale", "gbias"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["gx"], np.asarray(want["gx"]), rtol=1e-5,
                               atol=1e-6)


def test_loss_is_the_concatenated_batch_sum(ranks, flax_ref):
    for r in ranks:
        assert abs(r["loss"] - float(flax_ref["loss"])) <= 1e-5 * abs(
            float(flax_ref["loss"]))


def test_one_2c_allreduce_per_call_none_in_eval(ranks):
    for r in ranks:
        assert r["fwd_calls"] == [((2 * C,), torch.float32)]
        assert r["counted"] == 1
        assert r["bwd_calls"] == [((2 * C,), torch.float32)]
        assert r["eval_calls"] == []


def test_eval_uses_running_stats(ranks):
    from horovod_tpu_torch.data.sync_bn import SyncBatchNorm
    n = B // WORLD
    for rank, r in enumerate(ranks):
        bn = SyncBatchNorm(C, axis_name="dp", mesh=object(),
                           device="cpu").eval()
        scale, bias = _params()
        with torch.no_grad():
            bn.scale.copy_(torch.tensor(scale))
            bn.bias.copy_(torch.tensor(bias))
            bn.mean.copy_(r["mean"])
            bn.var.copy_(r["var"])
            x = torch.tensor(_x()[rank * n:(rank + 1) * n])
            assert torch.equal(bn(x), r["y_eval"])


def test_local_mode_without_axis():
    import flax.linen as nn
    import jax.numpy as jnp

    from horovod_tpu_torch.data import sync_bn
    x, variables = _x(), _variables()
    y_ref, upd = nn.BatchNorm(use_running_average=False, momentum=0.9,
                              epsilon=1e-5, dtype=jnp.float32).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = sync_bn.SyncBatchNorm(C, axis_name=None, device="cpu")
    scale, bias = _params()
    with torch.no_grad():
        bn.scale.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    sync_bn.reset_allreduce_count()
    y = bn(torch.tensor(x))
    assert sync_bn.allreduce_count() == 0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5)


def test_functional_moments_and_norm_match_jax_locally():
    import jax.numpy as jnp

    from horovod_tpu.data import sync_bn as jsbn
    from horovod_tpu_torch.data import sync_bn
    x = _x() * 3.0 + 1.0
    scale, bias = _params()
    y, mean, var = sync_bn.sync_batch_norm(
        torch.tensor(x), torch.tensor(scale), torch.tensor(bias),
        axis_name=None, epsilon=1e-3, dtype=torch.float32)
    jy, jmean, jvar = jsbn.sync_batch_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        axis_name=None, epsilon=1e-3)
    for a, b in ((y, jy), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # Channels first (the models' NCHW) gives the same moments.
    m2, v2 = sync_bn.batch_moments(torch.tensor(x).permute(0, 3, 1, 2),
                                   None, channel_dim=1)
    np.testing.assert_allclose(m2.numpy(), mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(v2.numpy(), var.numpy(), rtol=1e-5)


def test_resnet_pallas_with_sync_bn_raises():
    from horovod_tpu_torch.models import ResNet
    with pytest.raises(ValueError, match="bn_impl='flax'"):
        ResNet(stage_sizes=[1], num_filters=8, num_classes=4,
               bn_impl="pallas", bn_axis_name="dp", device="cpu")


def test_sync_bn_resnet_keeps_the_local_keys():
    from horovod_tpu_torch.data.sync_bn import SyncBatchNorm
    from horovod_tpu_torch.models import ResNet
    kw = dict(stage_sizes=[1, 1], num_filters=8, num_classes=4,
              dtype=torch.float32, device="cpu")
    local, dist_ = ResNet(**kw), ResNet(bn_axis_name="dp", **kw)
    assert local.state_dict().keys() == dist_.state_dict().keys()
    bns = [m for m in dist_.modules() if isinstance(m, SyncBatchNorm)]
    assert len(bns) == 9 and all(b.axis_name == "dp" and b.channel_dim == 1
                                 for b in bns)
    dist_.load_state_dict(local.state_dict())
    assert float(dist_.stage1_block1.bn3.scale.detach().abs().max()) == 0.0
