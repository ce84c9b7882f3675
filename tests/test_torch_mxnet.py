"""The port's MXNet shim (``horovod_tpu_torch.mxnet``) on the CPU: a
counterpart of every case of ``tests/test_mxnet.py`` (the dtype x dims
sweeps of allreduce, allgather and broadcast, the in-place forms, the
fused multi-allreduce, 64-bit exactness, ``DistributedOptimizer`` and
``broadcast_parameters`` with the ParameterDict and deferred-init
cases) at world 1, each sweep case held to JAX's shim where the two
meet (JAX's 8 virtual ranks hold replicated inputs: its sum over 8 is 8
times the port's sum over 1, its gather 8 copies of the port's), and a
spawned 2-rank gloo job whose distinct per-rank inputs must give
numpy's sums and averages, ``broadcast`` from root 1 and ``allgather``
in rank order. The NDArray holds a torch tensor on its context: the
rank's CUDA device unless the caller passes ``"cpu"``."""

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.observability import flight_recorder as jax_flight_recorder
import horovod_tpu.mxnet as jax_mx
from horovod_tpu.mxnet import nd as jax_nd
import horovod_tpu_torch as hvd
import horovod_tpu_torch.mxnet as hvd_mx
from horovod_tpu_torch.mxnet import nd
from horovod_tpu_torch.mxnet.ndarray import DeferredInitializationError

SWEEP_DTYPES = [np.uint8, np.int8, np.int32, np.float16, np.float32]


@pytest.fixture(scope="module", autouse=True)
def _init():
    jhvd.init()
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    # JAX's groups of this module stay in JAX's process-global flight
    # recorder for the rest of the worker, where a later dump's time
    # window can cut one between its deliver and its done event.
    jax_flight_recorder.reset()


def _data(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rs.randint(0, 10, shape).astype(dtype)
    return rs.rand(*shape).astype(dtype)


def _rand(shape, dtype, seed=0):
    return nd.array(_data(shape, dtype, seed), dtype=dtype, ctx="cpu")


class TestMXAllreduce:
    @pytest.mark.parametrize("dtype", SWEEP_DTYPES)
    @pytest.mark.parametrize("dim", [1, 2, 3])
    def test_allreduce_sum(self, dtype, dim):
        data = _data([17] * dim, dtype, dim)
        t = nd.array(data, dtype=dtype, ctx="cpu")
        out = hvd_mx.allreduce(t, average=False)
        expected = t.asnumpy().astype(np.float64) * hvd.size()
        assert out.dtype == dtype
        assert out.context == torch.device("cpu")
        tol = 1e-2 if dtype == np.float16 else 1e-5
        got = out.asnumpy().astype(np.float64)
        if np.issubdtype(dtype, np.integer):
            expected = expected.astype(dtype).astype(np.float64)
        assert np.allclose(got, expected, rtol=tol, atol=tol)
        # JAX's shim: 8 replicated virtual ranks sum to 8 times this
        # (exactly for the integers; a float sum of 8 equal terms rounds
        # from its third add on: within two ulps of the dtype).
        theirs = jax_mx.allreduce(jax_nd.array(data, dtype=dtype),
                                  average=False)
        assert theirs.dtype == out.dtype and theirs.shape == out.shape
        ulp = 0.0 if np.issubdtype(dtype, np.integer) \
            else 2 * float(np.finfo(dtype).eps)
        np.testing.assert_allclose(
            theirs.asnumpy().astype(np.float64) / jhvd.size(), got,
            rtol=ulp, atol=0)
        mean = jax_mx.allreduce(jax_nd.array(data, dtype=dtype),
                                average=True)
        np.testing.assert_allclose(
            mean.asnumpy().astype(np.float64),
            hvd_mx.allreduce(t, average=True).asnumpy().astype(np.float64),
            rtol=ulp, atol=0)

    def test_allreduce_average(self):
        t = _rand((5, 5), np.float32)
        out = hvd_mx.allreduce(t, average=True)
        assert np.allclose(out.asnumpy(), t.asnumpy(), rtol=1e-5, atol=1e-6)
        assert out is not t       # input unmodified

    def test_allreduce_inplace(self):
        t = nd.array(np.ones((4, 4)), dtype=np.float32, ctx="cpu")
        ret = hvd_mx.allreduce_(t, average=False)
        assert ret is t
        assert np.allclose(t.asnumpy(), hvd.size() * np.ones((4, 4)))

    def test_allreduce_multi_fused(self):
        tensors = [nd.array(np.full((8,), i + 1.0), dtype=np.float32,
                            ctx="cpu") for i in range(5)]
        hvd_mx.allreduce_multi_(tensors, average=False, name_prefix="mx.mk")
        for i, t in enumerate(tensors):
            assert np.allclose(t.asnumpy(), hvd.size() * (i + 1.0))


class TestMXAllgather:
    @pytest.mark.parametrize("dtype", SWEEP_DTYPES)
    @pytest.mark.parametrize("dim", [1, 2, 3])
    def test_allgather(self, dtype, dim):
        data = _data([17] * dim, dtype, dim)
        out = hvd_mx.allgather(nd.array(data, dtype=dtype, ctx="cpu"))
        assert out.shape == (17 * hvd.size(),) + tuple([17] * (dim - 1))
        assert out.dtype == dtype
        got = out.asnumpy()
        for r in range(hvd.size()):
            assert np.array_equal(got[r * 17:(r + 1) * 17], data)
        theirs = jax_mx.allgather(jax_nd.array(data, dtype=dtype))
        assert theirs.dtype == out.dtype
        assert theirs.shape == (17 * jhvd.size(),) + out.shape[1:]
        np.testing.assert_array_equal(theirs.asnumpy()[:17], got)

    def test_allgather_64bit_exact(self):
        vals = np.array([[2 ** 40 + 3, -7], [1, 2 ** 52 + 1]], dtype=np.int64)
        out = hvd_mx.allgather(nd.array(vals, dtype=np.int64, ctx="cpu"))
        assert out.dtype == np.int64
        assert out.data.dtype == torch.int64      # no int32 bit pairs
        assert np.array_equal(out.asnumpy()[:2], vals)
        np.testing.assert_array_equal(
            jax_mx.allgather(jax_nd.array(vals, dtype=np.int64))
            .asnumpy()[:2], out.asnumpy())


class TestMXBroadcast:
    @pytest.mark.parametrize("dtype", SWEEP_DTYPES)
    @pytest.mark.parametrize("dim", [1, 2, 3])
    def test_broadcast(self, dtype, dim):
        data = _data([17] * dim, dtype, dim)
        t = nd.array(data, dtype=dtype, ctx="cpu")
        out = hvd_mx.broadcast(t, root_rank=0)
        assert out.dtype == dtype
        assert np.array_equal(out.asnumpy(), t.asnumpy())
        assert out is not t
        theirs = jax_mx.broadcast(jax_nd.array(data, dtype=dtype), 0)
        assert theirs.dtype == out.dtype
        np.testing.assert_array_equal(theirs.asnumpy(), out.asnumpy())

    def test_broadcast_inplace(self):
        t = nd.array(np.arange(12.0).reshape(3, 4), dtype=np.float32,
                     ctx="cpu")
        ref = t.asnumpy()
        ret = hvd_mx.broadcast_(t, root_rank=0)
        assert ret is t
        assert np.array_equal(t.asnumpy(), ref)

    def test_broadcast_float64_exact(self):
        vals = np.array([1e300, -2.5e-308, 3.14], dtype=np.float64)
        out = hvd_mx.broadcast(nd.array(vals, dtype=np.float64, ctx="cpu"),
                               root_rank=0)
        assert out.dtype == np.float64
        assert np.array_equal(out.asnumpy(), vals)
        np.testing.assert_array_equal(
            jax_mx.broadcast(jax_nd.array(vals, dtype=np.float64), 0)
            .asnumpy(), out.asnumpy())

    def test_invalid_root_raises(self):
        with pytest.raises(ValueError, match="root rank"):
            hvd_mx.broadcast(_rand((3,), np.float32), root_rank=1)


class _SGD:
    """MXNet-style optimizer stub: update(index, weight, grad, state)
    applies weight -= lr * grad (mx.optimizer.Optimizer surface)."""

    def __init__(self, learning_rate=0.1):
        self.learning_rate = learning_rate

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        if isinstance(index, (tuple, list)):
            for w, g in zip(weight, grad):
                w[:] = w.asnumpy() - self.learning_rate * g.asnumpy()
        else:
            weight[:] = (weight.asnumpy()
                         - self.learning_rate * grad.asnumpy())

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self.learning_rate = lr


class TestMXDistributedOptimizer:
    def test_update_averages_then_delegates(self):
        opt = hvd_mx.DistributedOptimizer(_SGD(learning_rate=0.5))
        w = nd.array(np.ones(4), dtype=np.float32, ctx="cpu")
        g = nd.array(np.full(4, 2.0), dtype=np.float32, ctx="cpu")
        opt.update(0, w, g, opt.create_state(0, w))
        assert np.allclose(w.asnumpy(), np.zeros(4))
        assert np.allclose(g.asnumpy(), np.full(4, 2.0))
        # JAX's shim takes the same step (its average over replicated
        # ranks is the local gradient too).
        jopt = jax_mx.DistributedOptimizer(_SGD(learning_rate=0.5))
        jw = jax_nd.array(np.ones(4), dtype=np.float32)
        jopt.update(0, jw, jax_nd.array(np.full(4, 2.0), dtype=np.float32),
                    None)
        np.testing.assert_array_equal(jw.asnumpy(), w.asnumpy())

    def test_update_index_list(self):
        opt = hvd_mx.DistributedOptimizer(_SGD(learning_rate=1.0))
        ws = [nd.array(np.ones(3), dtype=np.float32, ctx="cpu")
              for _ in range(3)]
        gs = [nd.array(np.full(3, float(i)), dtype=np.float32, ctx="cpu")
              for i in range(3)]
        opt.update([0, 1, 2], ws, gs, [None] * 3)
        for i, w in enumerate(ws):
            assert np.allclose(w.asnumpy(), 1.0 - float(i))

    def test_getattr_delegates(self):
        opt = hvd_mx.DistributedOptimizer(_SGD(learning_rate=0.25))
        assert opt.learning_rate == 0.25
        opt.set_learning_rate(0.125)
        assert opt._optimizer.learning_rate == 0.125
        assert type(opt).__name__ == type(
            jax_mx.DistributedOptimizer(_SGD())).__name__


class _Param:
    """gluon Parameter stub: data() returns the NDArray or raises
    DeferredInitializationError before init."""

    def __init__(self, arr=None):
        self._arr = arr

    def data(self):
        if self._arr is None:
            raise DeferredInitializationError("not initialized")
        return self._arr


class _ParamDict:
    """gluon ParameterDict stub — NOT a dict subclass (gluon's isn't):
    exposes items() yielding (name, Parameter)."""

    def __init__(self, params):
        self._params = params

    def items(self):
        return self._params.items()

    def __getitem__(self, k):
        return self._params[k]


class TestMXBroadcastParameters:
    def test_dict(self):
        params = {"b": nd.array(np.full(4, 2.0), dtype=np.float32, ctx="cpu"),
                  "a": nd.array(np.arange(3.0), dtype=np.float32, ctx="cpu")}
        before = {k: v.asnumpy() for k, v in params.items()}
        hvd_mx.broadcast_parameters(params, root_rank=0)
        for k in params:
            assert np.array_equal(params[k].asnumpy(), before[k])

    def test_parameter_dict_with_deferred_init(self):
        pd = _ParamDict({
            "w": _Param(nd.array(np.ones(5), dtype=np.float32, ctx="cpu")),
            "deferred": _Param(None),
            "b": _Param(nd.array(np.zeros(2), dtype=np.float32, ctx="cpu")),
        })
        hvd_mx.broadcast_parameters(pd, root_rank=0)  # must not raise
        assert np.array_equal(pd["w"].data().asnumpy(), np.ones(5))

    def test_invalid_type_raises(self):
        with pytest.raises(ValueError, match="invalid params"):
            hvd_mx.broadcast_parameters([1, 2, 3])


class TestNDArrayDevice:
    def test_default_context_is_the_process_device(self):
        assert nd.array([1.0]).context == hvd.device()
        assert nd.zeros((2,), ctx="cpu(0)").context == torch.device("cpu")

    def test_gpu_context_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nd.array([1.0], ctx="gpu(0)")

    def test_arithmetic_stays_on_the_tensor(self):
        w = nd.array(np.ones(4, np.float32), ctx="cpu")
        g = nd.array(np.full(4, 2.0, np.float32), ctx="cpu")
        w -= 0.25 * g
        np.testing.assert_array_equal(w.asnumpy(), np.full(4, 0.5,
                                                           np.float32))
        assert isinstance(w.data, torch.Tensor)


def test_two_rank_gloo_job_against_numpy(tmp_path):
    """Distinct per-rank inputs on 2 gloo ranks: sums (every dtype, 64-bit
    included), the average, ``allreduce_multi_``, ``broadcast[_]`` and
    ``broadcast_parameters`` from root 1, ``allgather``'s rank order and
    ``DistributedOptimizer.update`` against numpy."""
    import _torch_shim_workers as w
    ranks = w.run(w.mxnet_rank, str(tmp_path))
    xs = {r: w.inputs(r) for r in range(w.WORLD)}
    for dt in ("uint8", "int8", "int32", "int64", "float16", "float32",
               "float64"):
        per = [w.inputs(r, dt) for r in range(w.WORLD)]
        for res in ranks:
            np.testing.assert_array_equal(res[f"sum.{dt}"], sum(per))
            np.testing.assert_array_equal(res[f"bcast.{dt}"], per[w.ROOT])
            np.testing.assert_array_equal(res[f"gather.{dt}"],
                                          np.concatenate(per))
    for res in ranks:
        np.testing.assert_allclose(res["avg"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(res["bcast_"], xs[w.ROOT])
        for i, got in enumerate(res["multi"]):
            np.testing.assert_array_equal(got, xs[0] + xs[1] + 2 * i)
        np.testing.assert_array_equal(
            res["update_w"], np.float32(1) - np.float32(0.5)
            * ((xs[0] + xs[1]) / np.float32(2)))
        np.testing.assert_array_equal(res["params"]["a"], xs[w.ROOT] * 2)
        np.testing.assert_array_equal(
            res["params"]["b"], w.inputs(w.ROOT, shape=(4,)))
