"""The port's Keras shim (``horovod_tpu_torch.keras``) on Keras 3's torch
backend, on the CPU: a counterpart of every case of
``tests/test_keras.py`` (the wrapped optimizer and its class name,
``fit`` end to end, averaged gradients, fp16 compression, the host
collectives, ``broadcast_variables``, every callback and ``load_model``)
at world 1, held to JAX's shim where the two meet (the wrapped class
names, the learning-rate sequence of each schedule callback, the host
collectives' averages), the jax backend refused, and a spawned 2-rank
gloo job whose distinct per-rank batches must give numpy's sums,
``broadcast`` from root 1 and one SGD step on the average of both
ranks' gradients.

Keras fixes one backend per process: this file sets ``KERAS_BACKEND`` to
torch with ``setdefault``, as ``tests/test_keras.py`` does."""

import os

os.environ.setdefault("KERAS_BACKEND", "torch")

import numpy as np
import pytest

keras = pytest.importorskip("keras")

import horovod_tpu as jhvd
from horovod_tpu.observability import flight_recorder as jax_flight_recorder
import horovod_tpu.keras as jax_keras
import horovod_tpu_torch as hvd
import horovod_tpu_torch.keras as hvd_keras
from horovod_tpu_torch.keras import callbacks as tcb


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


def _model():
    keras.utils.set_random_seed(0)
    return keras.Sequential([
        keras.layers.Input((8,)),
        keras.layers.Dense(16, activation="relu"),
        keras.layers.Dense(2),
    ])


def _xy(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 8).astype("float32"), rs.rand(n, 2).astype("float32"))


class TestDistributedOptimizer:
    def test_wraps_and_preserves_class_name(self):
        opt = hvd_keras.DistributedOptimizer(keras.optimizers.SGD(0.01))
        assert opt.__class__.__name__ == "SGD"
        assert isinstance(opt, keras.optimizers.SGD)
        assert opt._hvd_wrapped
        theirs = jax_keras.DistributedOptimizer(keras.optimizers.SGD(0.01))
        assert type(theirs).__name__ == type(opt).__name__
        assert opt.get_config() == theirs.get_config()

    def test_fit_end_to_end(self):
        model = _model()
        opt = hvd_keras.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=0.1))
        model.compile(optimizer=opt, loss="mse", jit_compile=False)
        x, y = _xy(16)
        before = [np.array(w) for w in model.get_weights()]
        model.fit(x, y, batch_size=8, epochs=1, verbose=0)
        after = model.get_weights()
        assert any(not np.allclose(b, a) for b, a in zip(before, after))

    def test_gradients_are_averaged(self):
        # At world 1 the average over the ranks is the local gradient:
        # a wrapped and an unwrapped optimizer take identical steps (the
        # 2-rank job below averages distinct gradients).
        x, y = _xy(16, seed=1)

        def run(wrap):
            model = _model()
            opt = keras.optimizers.SGD(learning_rate=0.1)
            if wrap:
                opt = hvd_keras.DistributedOptimizer(opt)
            model.compile(optimizer=opt, loss="mse", jit_compile=False)
            model.fit(x, y, batch_size=16, epochs=1, shuffle=False,
                      verbose=0)
            return model.get_weights()

        for w_ref, w_hvd in zip(run(False), run(True)):
            np.testing.assert_array_equal(w_ref, w_hvd)

    def test_compression_fp16(self):
        model = _model()
        opt = hvd_keras.DistributedOptimizer(
            keras.optimizers.SGD(0.1), compression=hvd_keras.Compression.fp16)
        model.compile(optimizer=opt, loss="mse", jit_compile=False)
        x, y = _xy(8)
        model.fit(x, y, batch_size=8, epochs=1, verbose=0)
        assert opt._hvd_compression is hvd_keras.Compression.fp16

    def test_fp16_reduction_round_trip_matches_jax(self):
        """The fp16 wire's round trip of a gradient, fp32(fp16(g)), has
        JAX's bits (its average of 8 equal fp16 values is exact)."""
        import torch
        from horovod_tpu_torch.keras import _torch_allreduce_batch
        g = torch.tensor([1.5, 0.1, -7.3e-3, 3.3333], dtype=torch.float32)
        ours = _torch_allreduce_batch([g], ["k.fp16"],
                                      hvd_keras.Compression.fp16)[0]
        theirs = np.asarray(jax_keras._engine_allreduce_batch(
            [g.numpy()], ["k.fp16.j"], jax_keras.Compression.fp16)[0])
        np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                      theirs.view(np.uint32))

    def test_jax_backend_is_refused(self, monkeypatch):
        monkeypatch.setattr(keras.backend, "backend", lambda: "jax")
        with pytest.raises(RuntimeError, match="jax backend"):
            hvd_keras.DistributedOptimizer(keras.optimizers.SGD(0.1))


class TestHostCollectives:
    def test_allreduce_scalar(self):
        out = hvd_keras.allreduce(3.0, average=False, name="k.ar")
        assert out == pytest.approx(3.0 * hvd.size())
        assert out.dtype == np.float32
        theirs = jax_keras.allreduce(3.0, average=False, name="k.ar")
        assert float(theirs) / jhvd.size() == float(out)

    def test_allgather(self):
        out = hvd_keras.allgather(np.array([1.0, 2.0], np.float32),
                                  name="k.ag")
        assert out.shape == (2 * hvd.size(),)
        theirs = jax_keras.allgather(np.array([1.0, 2.0], np.float32))
        np.testing.assert_array_equal(theirs[:2], out)

    def test_broadcast(self):
        out = hvd_keras.broadcast(np.arange(4.0, dtype=np.float32),
                                  root_rank=0, name="k.bc")
        assert np.allclose(out, np.arange(4.0))

    def test_allreduce_python_list(self):
        out = hvd_keras.allreduce([1.0, 2.0], average=True, name="k.arl")
        assert np.allclose(out, [1.0, 2.0])
        np.testing.assert_array_equal(
            out, jax_keras.allreduce([1.0, 2.0], average=True))

    def test_64bit_arrays_exact(self):
        big = np.array([2 ** 40 + 1, -3], np.int64)
        assert hvd_keras.broadcast(big).tolist() == big.tolist()
        assert hvd_keras.allreduce(big, average=False).tolist() == \
            big.tolist()


class TestBroadcastVariables:
    def test_broadcast_variables_roundtrip(self):
        model = _model()
        before = [np.array(w) for w in model.get_weights()]
        hvd_keras.broadcast_variables(model.variables, root_rank=0)
        for b, a in zip(before, model.get_weights()):
            assert np.allclose(b, a)


class TestCallbacks:
    def test_broadcast_callback_fit(self):
        model = _model()
        model.compile(optimizer=hvd_keras.DistributedOptimizer(
            keras.optimizers.SGD(0.1)), loss="mse", jit_compile=False)
        cb = hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0)
        x, y = _xy(8)
        model.fit(x, y, batch_size=4, epochs=1, callbacks=[cb], verbose=0)
        assert cb._model_done and cb._opt_done

    def test_metric_average_callback(self):
        cb = hvd_keras.callbacks.MetricAverageCallback()
        logs = {"loss": 2.5, "acc": 0.5}
        cb._average_metrics_in_place(logs)
        assert logs["loss"] == pytest.approx(2.5, rel=1e-5)
        assert logs["acc"] == pytest.approx(0.5, rel=1e-5)
        theirs = {"loss": 2.5, "acc": 0.5}
        jax_keras.callbacks.MetricAverageCallback() \
            ._average_metrics_in_place(theirs)
        assert theirs == logs

    def _lrs(self, make_cb, lr, epochs, batch_size, momentum=None):
        model = _model()
        sgd = (keras.optimizers.SGD(learning_rate=lr) if momentum is None
               else keras.optimizers.SGD(learning_rate=lr,
                                         momentum=momentum))
        model.compile(optimizer=sgd, loss="mse", jit_compile=False)
        x, y = _xy(16)
        hist = model.fit(x, y, batch_size=batch_size, epochs=epochs,
                         callbacks=[make_cb()], verbose=0)
        return hist.history["lr"], model

    def test_lr_schedule_staircase(self):
        def ours():
            return tcb.LearningRateScheduleCallback(
                multiplier=lambda epoch: 10 ** -epoch, start_epoch=0)

        lrs, model = self._lrs(ours, 0.1, 3, 8, momentum=0.9)
        assert lrs[0] == pytest.approx(0.1, rel=1e-5)
        assert lrs[1] == pytest.approx(0.01, rel=1e-5)
        assert lrs[2] == pytest.approx(0.001, rel=1e-5)
        assert float(model.optimizer.momentum) == pytest.approx(0.9)
        theirs, _ = self._lrs(
            lambda: jax_keras.callbacks.LearningRateScheduleCallback(
                multiplier=lambda epoch: 10 ** -epoch, start_epoch=0),
            0.1, 3, 8, momentum=0.9)
        assert lrs == theirs

    def test_checkpoint_callback_commits_epochs(self, tmp_path):
        from horovod_tpu_torch.checkpoint import list_steps

        model = _model()
        model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse",
                      jit_compile=False)
        cb = hvd_keras.callbacks.CheckpointCallback(
            str(tmp_path / "kck"), every_epochs=2)
        x, y = _xy(16)
        model.fit(x, y, batch_size=8, epochs=4, callbacks=[cb], verbose=0)
        assert list_steps(str(tmp_path / "kck")) == [2, 4]
        weights = cb.engine.restore(template=list(model.get_weights()))
        for got, want in zip(weights, model.get_weights()):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6)
        # The JAX engine reads the port's commit: the format is one.
        from horovod_tpu.checkpoint import CheckpointEngine as JaxEngine
        jw = JaxEngine(str(tmp_path / "kck")).restore(
            template=[np.asarray(w) for w in model.get_weights()])
        for got, want in zip(jw, model.get_weights()):
            np.testing.assert_array_equal(np.asarray(got), want)
        with pytest.raises(ValueError, match="exactly one"):
            hvd_keras.callbacks.CheckpointCallback()

    def test_lr_warmup_reaches_initial(self, monkeypatch):
        lrs, _ = self._lrs(lambda: tcb.LearningRateWarmupCallback(
            warmup_epochs=2, verbose=0), 0.8, 3, 4)
        assert lrs[-1] == pytest.approx(0.8, rel=1e-3)
        # JAX's world is 8 virtual ranks: at the same size the port's
        # warmup takes JAX's sequence.
        monkeypatch.setattr(tcb._topo, "size", jhvd.size)
        ours, _ = self._lrs(lambda: tcb.LearningRateWarmupCallback(
            warmup_epochs=2, verbose=0), 0.8, 3, 4)
        theirs, _ = self._lrs(
            lambda: jax_keras.callbacks.LearningRateWarmupCallback(
                warmup_epochs=2, verbose=0), 0.8, 3, 4)
        assert ours == theirs
        assert ours[0] < 0.8

    def test_metrics_callback_records_steps(self):
        from horovod_tpu_torch.observability import registry as reg
        model = _model()
        model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse",
                      jit_compile=False)
        cb = tcb.MetricsCallback(batch_size=4, log_metrics=True)
        x, y = _xy(8)
        model.fit(x, y, batch_size=4, epochs=1, callbacks=[cb], verbose=0)
        assert cb._timer.last_step_s > 0
        assert 'framework="keras"' in reg.snapshot(
            "hvdtpu_step_seconds")["hvdtpu_step_seconds"]["values"]


class TestLoadModel:
    def test_load_model_rewraps_optimizer(self, tmp_path):
        model = _model()
        model.compile(optimizer=hvd_keras.DistributedOptimizer(
            keras.optimizers.SGD(0.05)), loss="mse", jit_compile=False)
        x, y = _xy(8)
        model.fit(x, y, batch_size=8, epochs=1, verbose=0)
        path = str(tmp_path / "model.keras")
        model.save(path)
        loaded = hvd_keras.load_model(path)
        assert getattr(loaded.optimizer, "_hvd_wrapped", False)
        assert loaded.optimizer.__class__.__name__ == "SGD"
        loaded.fit(x, y, batch_size=8, epochs=1, verbose=0)


def _dense_step(x, y, w, b):
    """One mse gradient of Dense(2) in float64: (dW, db)."""
    err = x @ w + b - y
    return 2 * x.T @ err / err.size, 2 * err.sum(0) / err.size


def test_two_rank_gloo_job_against_numpy(tmp_path):
    """Distinct per-rank batches on 2 gloo ranks (torch backend): the host
    collectives against numpy, ``broadcast_variables`` and the metric
    average, and one ``fit`` step of SGD(lr=1) on the wrapped optimizer:
    the weights move by the average of both ranks' gradients."""
    import _torch_shim_workers as w
    ranks = w.run(w.keras_rank, str(tmp_path))
    xs = [w.inputs(r) for r in range(w.WORLD)]
    w0 = [np.asarray(a, np.float64) for a in ranks[0]["w0"]]
    grads = [_dense_step(xs[r] / 10, w.inputs(r, shape=(5, 2)) / 10, *w0)
             for r in range(w.WORLD)]
    want = [w0[i] - (grads[0][i] + grads[1][i]) / 2 for i in range(2)]
    for res in ranks:
        np.testing.assert_array_equal(res["sum"], xs[0] + xs[1])
        np.testing.assert_allclose(res["avg"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(res["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(res["bcast"], xs[w.ROOT])
        np.testing.assert_array_equal(res["var"],
                                      w.inputs(w.ROOT, shape=(3,)))
        assert res["metric"] == 1.5
        for got, exp in zip(res["w1"], want):
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
