"""The port's bucketed ``DistributedOptimizer`` against the JAX package's
torch shim (``horovod_tpu.torch``), which runs the same torch model.

In this process both run at world size 1: the JAX package is initialised
on one of the 8 CPU devices for this module (its ``size()`` is then 1,
so an average is the identity, as at the port's world size 1), and
restored to all 8 afterwards. Tolerance: 0 (bit for bit) for the
gradients, residuals and parameters of every compressor, the blockwise
wires included (both sides quantize each bucket's buffer as one flat
tensor, and the port's wire computes what the compiled JAX program
does); the SGD and Adam runs are held to rtol 1e-5 as well.

On 2 gloo ranks with different data on each rank, each bucket's buffer
after the allreduce is held bit for bit to ``executor._fused_reduce``
of the two ranks' buffers as they were submitted (under ``shard_map``
over 2 CPU devices), with and without ``int8_blockwise``.
"""

import os
import socket
import time
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu as jhvd
import horovod_tpu.torch as shim
import horovod_tpu_torch as hvd
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.ops import collective as tcoll

COMPRESSIONS = ["none", "fp16", "bf16", "int8_blockwise", "fp8_blockwise"]
JOB_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _jax_world_of_one():
    import jax
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    assert jhvd.size() == 1
    yield
    jhvd.shutdown()
    jhvd.init()


@pytest.fixture(autouse=True)
def _port_initialized():
    hvd.init(device="cpu")
    yield


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(16, 32), torch.nn.Tanh(),
        torch.nn.Linear(32, 32), torch.nn.Tanh(),
        torch.nn.Linear(32, 4))


def _wrap(pkg, model, inner=None, compression="none", **kw):
    inner = inner or torch.optim.SGD(model.parameters(), lr=0.05)
    return pkg.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        compression=getattr(pkg.Compression, compression), **kw)


def _train(pkg, steps=3, compression="none", seed=0, passes=1,
           inner=None, zero_none=False, **kw):
    model = _model(seed)
    opt = _wrap(pkg, model, inner(model) if inner else None, compression,
                backward_passes_per_step=passes, **kw)
    torch.manual_seed(7)
    for _ in range(steps):
        for _ in range(passes):
            model(torch.rand(8, 16)).sum().backward()
        opt.step()
        if zero_none:
            opt.zero_grad(set_to_none=True)
        else:
            opt.zero_grad()
    return model, opt


def _grads_after_sync(pkg, compression="none", **kw):
    model = _model()
    opt = _wrap(pkg, model, torch.optim.SGD(model.parameters(), lr=0.0),
                compression, **kw)
    torch.manual_seed(7)
    model(torch.rand(8, 16)).sum().backward()
    opt.synchronize()
    return opt, {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}


def _same_params(a, b):
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


def _partition(opt, model):
    index = {id(p): i for i, p in enumerate(model.parameters())}
    return [([index[id(p)] for p in b.params], b.buffer.dtype, b.numel)
            for b in opt._buckets]


# ------------------------------------------------------------- partition

@pytest.mark.parametrize("compression", ["none", "fp16"])
@pytest.mark.parametrize("cap", [0.001, 0.004, 64])
def test_bucket_partition_equals_shim(cap, compression):
    parts = []
    for pkg in (shim, hvd):
        model = _model()
        opt = _wrap(pkg, model, compression=compression, bucket_cap_mb=cap)
        parts.append(_partition(opt, model))
    assert parts[0] == parts[1]
    assert (len(parts[1]) > 1) == (cap < 1)


def test_bucket_partition_covers_every_param():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0.001)
    covered = {pid for b in opt._buckets for pid in b.offsets}
    assert covered == {id(p) for p in model.parameters()}
    for b in opt._buckets:
        assert b.numel == sum(n for _, n in b.offsets.values())
        assert b.buffer.numel() == b.numel


def test_bucket_cap_zero_keeps_per_tensor_hooks():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0)
    assert opt._buckets == []
    model(torch.rand(4, 16)).sum().backward()
    assert len(opt._handles) == 6          # one request per gradient
    opt.step()


# ----------------------------------------------------- against the shim

@pytest.mark.parametrize("cap", [0.001, 0])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_gradients_equal_shim(compression, cap):
    _, want = _grads_after_sync(shim, compression, bucket_cap_mb=cap)
    _, got = _grads_after_sync(hvd, compression, bucket_cap_mb=cap)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_buckets_equal_per_tensor_bitwise(compression):
    _, bucketed = _grads_after_sync(hvd, compression, bucket_cap_mb=0.001)
    _, per_tensor = _grads_after_sync(hvd, compression, bucket_cap_mb=0)
    for n in per_tensor:
        assert torch.equal(bucketed[n], per_tensor[n]), n


def test_bucket_quantized_within_wire_tolerance():
    """Blocks span parameters in a bucket and not per tensor, so the two
    paths quantize differently: within the shim's 2e-2 of each
    tensor's max."""
    kw = dict(compression="int8_blockwise")
    _, bucketed = _grads_after_sync(hvd, bucket_cap_mb=0.001, **kw)
    _, per_tensor = _grads_after_sync(hvd, bucket_cap_mb=0, **kw)
    for n in per_tensor:
        ref = per_tensor[n]
        tol = 2e-2 * (ref.abs().max().item() + 1e-8)
        assert (bucketed[n] - ref).abs().max().item() <= tol, n


@pytest.mark.parametrize("compression", ["int8_blockwise", "fp8_blockwise"])
def test_residuals_keyed_by_bucket_equal_shim(compression):
    (_, want), (_, got) = (_train(pkg, 2, compression, bucket_cap_mb=0.001)
                           for pkg in (shim, hvd))
    assert len(got._buckets) > 1
    assert sorted(got._bucket_residuals) == [b.index for b in got._buckets]
    assert sorted(want._bucket_residuals) == sorted(got._bucket_residuals)
    for idx, res in got._bucket_residuals.items():
        assert res.shape == got._buckets[idx].buffer.shape
        assert res.abs().sum() > 0           # the wire drops bits
        assert torch.equal(res, want._bucket_residuals[idx]), idx


def test_no_error_feedback_without_blockwise():
    opt, _ = _grads_after_sync(hvd, "fp16", bucket_cap_mb=0.001)
    assert opt._bucket_residuals == {}


@pytest.mark.parametrize("inner", ["sgd", "adam"])
@pytest.mark.parametrize("compression", ["none", "int8_blockwise"])
def test_five_steps_match_shim(inner, compression):
    make = {"sgd": lambda m: torch.optim.SGD(m.parameters(), lr=0.05,
                                             momentum=0.9),
            "adam": lambda m: torch.optim.Adam(m.parameters(), lr=1e-2)}
    runs = [_train(pkg, 5, compression, inner=make[inner])
            for pkg in (shim, hvd)]
    for (n, p), (_, q) in zip(runs[0][0].named_parameters(),
                              runs[1][0].named_parameters()):
        torch.testing.assert_close(q, p, rtol=1e-5, atol=0, msg=n)


# -------------------------------------------------- accumulation, hooks

def test_backward_passes_per_step_and_early_flush():
    model = _model()
    opt = _wrap(hvd, model, backward_passes_per_step=2, bucket_cap_mb=0.001)
    nb = len(opt._buckets)
    model(torch.rand(4, 16)).sum().backward()      # one pass only
    opt.step()                                      # early step: flush
    assert opt.bucket_fires == {"hook": 0, "flush": nb}
    assert all(opt._allreduce_delay[id(p)] == 2 for p in model.parameters())
    assert not opt._handles
    model(torch.rand(4, 16)).sum().backward()
    model(torch.rand(4, 16)).sum().backward()
    opt.step()                     # a full step fires every bucket by hook
    assert opt.bucket_fires == {"hook": nb, "flush": nb}


def test_accumulation_matches_shim():
    runs = [_train(pkg, 2, passes=2, bucket_cap_mb=0.001)
            for pkg in (shim, hvd)]
    _same_params(runs[0][0], runs[1][0])


@pytest.mark.parametrize("cap", [0.001, 0])
def test_double_backward_raises(cap):
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=cap)
    x = torch.rand(4, 16)
    model(x).sum().backward()
    with pytest.raises(AssertionError, match="already allreduced"):
        model(x).sum().backward()
    opt.synchronize()


def test_skip_synchronize_gradient_clipping():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0.001)
    model(torch.rand(4, 16)).sum().backward()
    opt.synchronize()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with opt.skip_synchronize():
            opt.step()
    model(torch.rand(4, 16)).sum().backward()
    opt.synchronize()
    with pytest.warns(UserWarning, match="skip_synchronize"):
        opt.step()


def test_zero_grad_refuses_while_in_flight():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0.001)
    model(torch.rand(4, 16)).sum().backward()
    assert opt._handles              # fired by the hooks
    with pytest.raises(AssertionError, match="in-flight"):
        opt.zero_grad()
    opt.synchronize()
    opt.zero_grad()


def test_custom_compressor_falls_back_to_per_tensor():
    class Doubler(hvd.Compression.none):
        @staticmethod
        def compress(tensor):
            return tensor * 0.5, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor * 2.0

    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0),
        named_parameters=model.named_parameters(), compression=Doubler)
    assert opt._buckets == []
    torch.manual_seed(7)
    model(torch.rand(8, 16)).sum().backward()
    expected = {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}
    opt.synchronize()
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, expected[n]), n


def test_isinstance_and_validation():
    model = _model()
    opt = _wrap(hvd, model)
    assert isinstance(opt, torch.optim.SGD)
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=_model(1).named_parameters())


# ------------------------------------------------------------- repartition

def test_repartition_equals_fresh_optimizer():
    model = _model()
    opt = _wrap(hvd, model, torch.optim.SGD(model.parameters(), lr=0.0),
                bucket_cap_mb=0.001)
    torch.manual_seed(7)
    model(torch.rand(8, 16)).sum().backward()
    opt.step()
    assert len(opt._buckets) > 1
    opt.zero_grad()
    opt.set_bucket_cap_mb(64)
    assert len(opt._buckets) == 1
    torch.manual_seed(7)
    model(torch.rand(8, 16)).sum().backward()
    opt.synchronize()
    fresh, grads = _grads_after_sync(hvd, bucket_cap_mb=64)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, grads[n]), n
    names = [[[o._names[id(p)] for p in b.params] for b in o._buckets]
             for o in (opt, fresh)]
    assert names[0] == names[1]


def test_repartition_refuses_in_flight_and_without_buckets():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0.001)
    model(torch.rand(8, 16)).sum().backward()
    with pytest.raises(RuntimeError, match="in flight"):
        opt.set_bucket_cap_mb(32)
    opt.synchronize()
    opt.set_bucket_cap_mb(32)
    with pytest.raises(ValueError, match="positive"):
        opt.set_bucket_cap_mb(0)
    bucketless = _wrap(hvd, _model(), bucket_cap_mb=0)
    with pytest.raises(ValueError, match="already bucketed"):
        bucketless.set_bucket_cap_mb(32)


def test_repartition_moves_grad_views_with_their_contents():
    model = _model()
    opt = _wrap(hvd, model, bucket_cap_mb=0.001, gradient_as_bucket_view=True)
    model(torch.rand(8, 16)).sum().backward()
    opt.step()
    before = {n: p.grad.clone() for n, p in model.named_parameters()}
    old = {b.buffer.data_ptr() for b in opt._buckets}
    opt.set_bucket_cap_mb(64)
    assert not old & {b.buffer.data_ptr() for b in opt._buckets}
    for n, p in model.named_parameters():
        assert opt._grad_is_view(p) and torch.equal(p.grad, before[n]), n


# ------------------------------------------------------- gradient views

def test_views_installed_and_aliased():
    _, opt = _train(hvd, 1, bucket_cap_mb=0.001,
                    gradient_as_bucket_view=True)
    assert len(opt._grad_views) == sum(len(b.params) for b in opt._buckets)
    for group in opt.param_groups:
        for p in group["params"]:
            assert opt._grad_is_view(p)
            b = opt._param_bucket[id(p)]
            assert p.grad.data_ptr() == b.view_of(p).data_ptr()


@pytest.mark.parametrize("compression", ["none", "int8_blockwise"])
def test_views_bitwise_equal_copy_path(compression):
    m_copy, _ = _train(hvd, 3, compression, bucket_cap_mb=0.001)
    m_view, _ = _train(hvd, 3, compression, bucket_cap_mb=0.001,
                       gradient_as_bucket_view=True)
    _same_params(m_copy, m_view)
    m_shim, _ = _train(shim, 3, compression, bucket_cap_mb=0.001,
                       gradient_as_bucket_view=True)
    _same_params(m_shim, m_view)


def test_fp16_wire_keeps_copy_path():
    _, opt = _train(hvd, 1, "fp16", bucket_cap_mb=0.001,
                    gradient_as_bucket_view=True)
    assert opt._grad_views == {}


def test_zero_grad_default_keeps_views(monkeypatch):
    fills = []
    fill = topt._GradBucket.fill
    monkeypatch.setattr(topt._GradBucket, "fill",
                        lambda b, p: (fills.append(1), fill(b, p)))
    _, opt = _train(hvd, 3, bucket_cap_mb=0.001,
                    gradient_as_bucket_view=True)
    for group in opt.param_groups:
        for p in group["params"]:
            assert opt._grad_is_view(p)
    assert not fills                 # no hook ever copied: no rebind


def test_set_to_none_drops_views_and_hooks_alias_again():
    m_view, opt = _train(hvd, 3, bucket_cap_mb=0.001,
                         gradient_as_bucket_view=True, zero_none=True)
    assert all(p.grad is None for p in m_view.parameters())
    m_copy, _ = _train(hvd, 3, bucket_cap_mb=0.001, zero_none=True)
    _same_params(m_copy, m_view)
    m_view(torch.rand(8, 16)).sum().backward()
    opt.synchronize()
    assert all(opt._grad_is_view(p) for p in m_view.parameters())


def test_grad_view_env_default(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_TORCH_GRAD_VIEW", "1")
    opt, _ = _grads_after_sync(hvd, bucket_cap_mb=0.001)
    assert opt._grad_views


def test_bucket_cap_env_default(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUCKET_MB", "0.001")
    opt, _ = _grads_after_sync(hvd)
    assert len(opt._buckets) > 1
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUCKET_MB", "0")
    opt, _ = _grads_after_sync(hvd)
    assert opt._buckets == []


# ---------------------------------------------------- nonfinite steps

def _nan_step(pkg):
    model = _model()
    opt = _wrap(pkg, model, bucket_cap_mb=0.001, skip_nonfinite_steps=True)
    before = [p.detach().clone() for p in model.parameters()]
    x = torch.rand(8, 16)
    x[0, 0] = float("nan")
    model(x).sum().backward()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        opt.step()
    skipped = all(torch.equal(b, p) for b, p in zip(before,
                                                    model.parameters()))
    opt.zero_grad()                                  # a finite step after
    model(torch.rand(8, 16)).sum().backward()
    opt.step()
    moved = not any(torch.equal(b, p) for b, p in zip(before,
                                                      model.parameters()))
    return skipped, moved, any("skip_nonfinite" in str(w.message)
                               for w in caught)


def test_skip_nonfinite_steps_under_numerics(monkeypatch):
    from horovod_tpu.observability import numerics
    monkeypatch.setenv("HOROVOD_TPU_NUMERICS", "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    numerics.set_enabled(True)
    try:
        assert _nan_step(shim) == (True, True, True)
        assert _nan_step(hvd) == (True, True, True)
    finally:
        numerics.set_enabled(False)
        hvd.shutdown()


def test_nonfinite_not_counted_without_numerics():
    assert not hvd.get_topology().numerics
    skipped, _, warned = _nan_step(hvd)
    assert not skipped and not warned


# ------------------------------------------------------ the train steps

def test_train_step_keeps_grad_views(monkeypatch):
    """``TrainStep`` zeroes through the optimizer's default, so views
    survive its steps: no hook has to copy a gradient home."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.train import build_train_step
    cfg = tfm.TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=1,
                                d_ff=32, max_seq=8, dtype=torch.float32,
                                remat=False)
    step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=0.1),
                            device="cpu")
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), bucket_cap_mb=0.004,
        gradient_as_bucket_view=True)
    fills = []
    fill = topt._GradBucket.fill
    monkeypatch.setattr(topt._GradBucket, "fill",
                        lambda b, p: (fills.append(1), fill(b, p)))
    tok = torch.randint(0, 32, (2, 9), generator=torch.Generator()
                        .manual_seed(1))
    losses = [float(step(model, opt, tok[:, :-1], tok[:, 1:]))
              for _ in range(3)]
    assert losses[-1] < losses[0] and len(opt._buckets) > 1
    assert not fills
    assert all(opt._grad_is_view(p) for p in model.parameters())
    assert opt.bucket_fires == {"hook": 3 * len(opt._buckets), "flush": 0}


# --------------------------------------------------------------- 2 ranks

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_worker(rank, port, outdir):
    hvd.shutdown()
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=2)
    submitted = {}
    fused = tcoll.fused_allreduce_async_

    def recording(tensors, *args, names=None, **kw):
        for nm, t in zip(names, tensors):
            submitted[nm] = t.clone()
        return fused(tensors, *args, names=names, **kw)

    tcoll.fused_allreduce_async_ = recording
    out = {}
    for compression in ("none", "int8_blockwise"):
        model = _model()
        opt = _wrap(hvd, model, torch.optim.SGD(model.parameters(), lr=0.1),
                    compression, bucket_cap_mb=0.002)
        torch.manual_seed(100 + rank)          # different data per rank
        for step in range(2):
            submitted.clear()
            model(torch.rand(8, 16) * (rank + 1)).sum().backward()
            opt.synchronize()
            for b in opt._buckets:
                key = f"{compression}.{step}.{b.index}"
                out[f"in.{key}"] = submitted[b.name]
                out[f"out.{key}"] = b.buffer.clone()
            with opt.skip_synchronize():
                opt.step()
            opt.zero_grad()
        out[f"params.{compression}"] = [p.detach().clone()
                                        for p in model.parameters()]
        out[f"buckets.{compression}"] = len(opt._buckets)
    tcoll.fused_allreduce_async_ = fused
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    hvd.shutdown()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("optimizer2")
    ctx = mp.spawn(_two_rank_worker, args=(_free_port(), str(d)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("compression", ["none", "int8_blockwise"])
def test_two_ranks_buckets_equal_fused_reduce(two_ranks, compression):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.executor import _fused_reduce
    from horovod_tpu.quantization import parse

    wire = parse("int8x256") if compression != "none" else None
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    fn = jax.jit(jax.shard_map(
        lambda y: _fused_reduce((y[0],), lambda b: jax.lax.psum(b, "dp"),
                                1.0, 0.5, wire=wire, axis="dp", world=2),
        mesh=mesh, in_specs=P("dp"), out_specs=P(), check_vma=False))
    r0, r1 = two_ranks
    nb = r0[f"buckets.{compression}"]
    assert nb > 1
    for step in range(2):
        for i in range(nb):
            key = f"{compression}.{step}.{i}"
            ins = [r[f"in.{key}"] for r in two_ranks]
            assert not torch.equal(ins[0], ins[1])
            want = np.asarray(fn(jnp.stack([jnp.asarray(t.numpy())
                                            for t in ins]))[0])
            for r in two_ranks:
                assert np.array_equal(r[f"out.{key}"].numpy().view(np.uint32),
                                      want.view(np.uint32)), (key)
    for p, q in zip(r0[f"params.{compression}"], r1[f"params.{compression}"]):
        assert torch.equal(p, q)
