"""The port's TensorFlow shim (``horovod_tpu_torch.tensorflow``) on the
CPU: a counterpart of every case of ``tests/test_tensorflow.py`` (the
dtype x dims sweeps, eager and under ``tf.function``, the registered
gradients, fp16 compression, the ``IndexedSlices`` path, allgather and
broadcast with their gradients, ``broadcast_variables``, the tape, the
callback, the one-crossing grouped bridge, the v1 optimizer's
``compute_gradients`` and the graph-mode ``SessionRunHook``) at world 1,
held to JAX's shim where the two meet (its 8 virtual ranks hold
replicated inputs: ``allreduce(average=False) / size``, the averages,
dtypes and shapes, the bits of the fp16 round trip), 64-bit payloads
carried exactly, and a spawned 2-rank gloo job whose distinct per-rank
inputs must give numpy's sums and ``broadcast`` from root 1.

Keras-optimizer integration runs in a subprocess with
``KERAS_BACKEND=tensorflow`` (``tests/test_torch_keras_tf.py``)."""

import contextlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

# The ops here are tiny: two threads a pool keep TF's spinning workers
# off the cores the other test processes share (TF refuses once it
# has run an op in this process).
with contextlib.suppress(RuntimeError):
    tf.config.threading.set_intra_op_parallelism_threads(2)
    tf.config.threading.set_inter_op_parallelism_threads(2)

import horovod_tpu as jhvd
from horovod_tpu.observability import flight_recorder as jax_flight_recorder
import horovod_tpu.tensorflow as jax_tf
import horovod_tpu_torch as hvd
import horovod_tpu_torch.tensorflow as hvd_tf

SWEEP_DTYPES = [tf.uint8, tf.int8, tf.int32, tf.float16, tf.float32,
                tf.bfloat16]
# The dtypes' machine epsilons (bfloat16 has no numpy finfo).
EPS = {tf.float16: 2.0 ** -10, tf.float32: 2.0 ** -23,
       tf.bfloat16: 2.0 ** -7}


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


def _rand(shape, dtype, seed=0):
    tf.random.set_seed(seed)
    if dtype in (tf.uint8, tf.int8, tf.int32):
        return tf.cast(tf.random.uniform(shape, 0, 10, dtype=tf.int32),
                       dtype)
    return tf.cast(tf.random.uniform(shape), dtype)


def _f64(t):
    return tf.cast(t, tf.float64).numpy()


class TestTFAllreduce:
    @pytest.mark.parametrize("dtype", SWEEP_DTYPES)
    @pytest.mark.parametrize("dim", [1, 2, 3])
    def test_allreduce_sum(self, dtype, dim):
        t = _rand([17] * dim, dtype, seed=dim)
        out = hvd_tf.allreduce(t, average=False)
        assert out.dtype == dtype
        expected = tf.cast(t, tf.float32) * hvd.size()
        tol = 1e-1 if dtype in (tf.float16, tf.bfloat16) else 1e-4
        assert np.allclose(tf.cast(out, tf.float32).numpy(),
                           expected.numpy(), rtol=tol, atol=tol)
        # JAX's shim: 8 replicated virtual ranks sum to 8 times this
        # (exactly for integers; a float sum of 8 equal terms rounds from
        # its third add on, within two ulps of the dtype).
        theirs = jax_tf.allreduce(t, average=False)
        assert theirs.dtype == out.dtype and theirs.shape == out.shape
        ulp = 0.0 if not dtype.is_floating else 2 * EPS[dtype]
        np.testing.assert_allclose(_f64(theirs) / jhvd.size(), _f64(out),
                                   rtol=ulp, atol=0)

    def test_allreduce_average(self):
        t = tf.constant([1.0, 2.0, 3.0])
        out = hvd_tf.allreduce(t, average=True)
        assert np.allclose(out.numpy(), t.numpy(), atol=1e-5)
        np.testing.assert_array_equal(
            out.numpy(), jax_tf.allreduce(t, average=True).numpy())

    def test_allreduce_inside_tf_function(self):
        @tf.function
        def fn(x):
            return hvd_tf.allreduce(x, average=False)

        t = tf.constant([[1.0, 2.0], [3.0, 4.0]])
        out = fn(t)
        assert np.allclose(out.numpy(), t.numpy() * hvd.size())
        assert out.shape == t.shape

    def test_allreduce_grad(self):
        t = tf.Variable([1.0, 2.0, 3.0])
        with tf.GradientTape() as tape:
            out = tf.reduce_sum(hvd_tf.allreduce(t, average=False))
        g = tape.gradient(out, t)
        assert np.allclose(g.numpy(), np.full(3, float(hvd.size())))

    def test_allreduce_compression_fp16(self):
        t = tf.constant([1.5, 2.5, 3.5, 0.1, -7.3e-3])
        out = hvd_tf.allreduce(t, average=True,
                               compression=hvd_tf.Compression.fp16)
        assert out.dtype == tf.float32
        assert np.allclose(out.numpy(), t.numpy(), atol=1e-2)
        # The round trip's bits are JAX's: fp32(fp16(x)).
        theirs = jax_tf.allreduce(t, average=True,
                                  compression=jax_tf.Compression.fp16)
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      theirs.numpy().view(np.uint32))

    def test_allreduce_indexed_slices(self):
        v = tf.IndexedSlices(values=tf.constant([[1.0, 2.0]]),
                             indices=tf.constant([3]),
                             dense_shape=tf.constant([8, 2]))
        out = hvd_tf.allreduce(v, average=False)
        assert isinstance(out, tf.IndexedSlices)
        assert out.values.shape[0] == hvd.size()
        assert out.indices.shape[0] == hvd.size()
        assert np.allclose(out.values.numpy()[0], [1.0, 2.0])
        # Averaged, the rows JAX gathers from its 8 replicated ranks sum
        # to the port's one row: the same dense gradient.
        theirs = jax_tf.allreduce(v, average=True)
        ours = hvd_tf.allreduce(v, average=True)
        np.testing.assert_array_equal(tf.convert_to_tensor(ours).numpy(),
                                      tf.convert_to_tensor(theirs).numpy())


class TestTFAllgather:
    @pytest.mark.parametrize("dtype", [tf.int32, tf.float32])
    @pytest.mark.parametrize("dim", [1, 2])
    def test_allgather(self, dtype, dim):
        t = _rand([5] * dim, dtype)
        out = hvd_tf.allgather(t)
        assert out.shape[0] == 5 * hvd.size()
        assert np.allclose(tf.cast(out[:5], tf.float32).numpy(),
                           tf.cast(t, tf.float32).numpy())
        theirs = jax_tf.allgather(t)
        assert theirs.dtype == out.dtype
        assert theirs.shape[1:] == out.shape[1:]
        np.testing.assert_array_equal(theirs.numpy()[:5], out.numpy())

    def test_allgather_grad(self):
        t = tf.Variable([[1.0, 2.0], [3.0, 4.0]])
        with tf.GradientTape() as tape:
            out = tf.reduce_sum(hvd_tf.allgather(t))
        g = tape.gradient(out, t)
        assert np.allclose(g.numpy(), np.full((2, 2), float(hvd.size())))


class TestTFBroadcast:
    def test_broadcast(self):
        t = tf.constant([1.0, 2.0, 3.0])
        out = hvd_tf.broadcast(t, root_rank=0)
        assert np.allclose(out.numpy(), t.numpy())
        np.testing.assert_array_equal(out.numpy(),
                                      jax_tf.broadcast(t, 0).numpy())

    def test_broadcast_grad_root(self):
        t = tf.Variable([1.0, 2.0])
        with tf.GradientTape() as tape:
            out = tf.reduce_sum(hvd_tf.broadcast(t, root_rank=0))
        g = tape.gradient(out, t)
        assert hvd.rank() == 0
        assert np.allclose(g.numpy(), np.full(2, float(hvd.size())))

    def test_broadcast_variables(self):
        v1 = tf.Variable([1.0, 2.0])
        v2 = tf.Variable([[3.0]])
        before = [v1.numpy().copy(), v2.numpy().copy()]
        hvd_tf.broadcast_variables([v1, v2], root_rank=0)
        assert np.allclose(v1.numpy(), before[0])
        assert np.allclose(v2.numpy(), before[1])

    def test_broadcast_global_requires_variables(self):
        with pytest.raises(ValueError):
            hvd_tf.broadcast_global_variables(0)


class TestDistributedGradientTape:
    def test_tape_averages(self):
        v = tf.Variable([1.0, 2.0])
        with hvd_tf.DistributedGradientTape() as tape:
            loss = tf.reduce_sum(v * v)
        g = tape.gradient(loss, [v])[0]
        assert np.allclose(g.numpy(), 2 * v.numpy(), atol=1e-5)

    def test_tape_training_loop(self):
        v = tf.Variable([4.0])
        for _ in range(3):
            with hvd_tf.DistributedGradientTape() as tape:
                loss = tf.reduce_sum(v * v)
            (g,) = tape.gradient(loss, [v])
            v.assign_sub(0.1 * g)
        assert float(v.numpy()[0]) < 4.0
        np.testing.assert_allclose(v.numpy(), 4.0 * 0.8 ** 3, rtol=1e-6)

    def test_callback_hook(self):
        cb = hvd_tf.BroadcastGlobalVariablesCallback(0)

        class M:
            variables = [tf.Variable([1.0])]

        cb(model=M())
        assert cb._done


class TestGroupedBridge:
    def test_tape_many_variables_one_bridge(self):
        n_vars = 24
        vs = [tf.Variable(tf.fill([3], float(i + 1))) for i in range(n_vars)]
        with hvd_tf.DistributedGradientTape() as tape:
            loss = tf.add_n([tf.reduce_sum(v * v) for v in vs])
        before = hvd_tf._bridge_calls[0]
        grads = tape.gradient(loss, vs)
        bridged = hvd_tf._bridge_calls[0] - before
        assert bridged == 1, f"{bridged} host bridges for {n_vars} grads"
        for i, g in enumerate(grads):
            np.testing.assert_allclose(g.numpy(), 2.0 * (i + 1), rtol=1e-5)

    def test_grouped_allreduce_values_and_grad(self):
        xs = [tf.constant([1.0, 2.0]), tf.constant([[3.0]]),
              tf.constant([4.0, 5.0, 6.0])]
        outs = hvd_tf.grouped_allreduce(xs, average=False)
        for x, o in zip(xs, outs):
            np.testing.assert_allclose(o.numpy(), x.numpy() * hvd.size())
        v = tf.Variable([2.0, 3.0])
        with tf.GradientTape() as tape:
            out = hvd_tf.grouped_allreduce([v * v], average=True)[0]
            loss = tf.reduce_sum(out)
        g = tape.gradient(loss, v)
        np.testing.assert_allclose(g.numpy(), 2.0 * v.numpy(), rtol=1e-5)

    def test_grouped_allreduce_mixed_dtypes(self):
        outs = hvd_tf.grouped_allreduce(
            [tf.constant([1.0, 2.0]), tf.constant([3], tf.int32)],
            average=False)
        np.testing.assert_allclose(outs[0].numpy(),
                                   [hvd.size(), 2.0 * hvd.size()])
        assert outs[1].numpy().tolist() == [3 * hvd.size()]
        assert outs[1].dtype == tf.int32

    def test_v1_optimizer_compute_gradients_one_bridge(self):
        vs = [tf.Variable(tf.ones([2]) * (i + 1)) for i in range(21)]
        opt = hvd_tf.DistributedOptimizer(
            tf.compat.v1.train.GradientDescentOptimizer(0.1))

        def loss():
            return tf.add_n([tf.reduce_sum(v * v) for v in vs])

        before = hvd_tf._bridge_calls[0]
        gvs = opt.compute_gradients(loss, var_list=vs)
        assert hvd_tf._bridge_calls[0] - before == 1
        opt.apply_gradients(gvs)
        for i, v in enumerate(vs):
            np.testing.assert_allclose(v.numpy(), 0.8 * (i + 1),
                                       rtol=1e-5)
        assert type(opt).__name__ == type(jax_tf.DistributedOptimizer(
            tf.compat.v1.train.GradientDescentOptimizer(0.1))).__name__


class TestSessionRunHook:
    def test_broadcast_hook_graph_mode(self):
        with tf.Graph().as_default():
            v1 = tf.compat.v1.get_variable(
                "hook_v1", initializer=tf.constant([1.0, 2.0]))
            v2 = tf.compat.v1.get_variable(
                "hook_v2", initializer=tf.constant(5.0))
            hook = hvd_tf.BroadcastGlobalVariablesHook(root_rank=0)
            hook.begin()
            assert hook.bcast_op is not None
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                hook.after_create_session(sess, None)
                out1, out2 = sess.run([v1, v2])
        np.testing.assert_allclose(out1, [1.0, 2.0])
        np.testing.assert_allclose(out2, 5.0)


class TestPortOnly:
    def test_64bit_payloads_exact(self):
        """int64 and float64 cross the bridge and the engine exactly
        (JAX's shim narrows them to 32 bits without x64)."""
        big = tf.constant([2 ** 40 + 3, -(2 ** 52) - 1], tf.int64)
        f = tf.constant([1e300, -2.5e-308], tf.float64)
        assert hvd_tf.allreduce(big, average=False).numpy().tolist() == \
            big.numpy().tolist()
        np.testing.assert_array_equal(hvd_tf.broadcast(f, 0).numpy(),
                                      f.numpy())
        v = tf.Variable(np.int64(2 ** 40 + 1))
        hvd_tf.broadcast_variables([v], root_rank=0)
        assert int(v.numpy()) == 2 ** 40 + 1

    @pytest.mark.parametrize("name", ["bf16", "fp8"])
    def test_cast_wires_round_trip_as_jax(self, name):
        """The bf16 and fp8 wires' round trips have JAX's bits."""
        t = tf.constant([1.5, -2.25, 300.0, 0.1, -7.3e-3])
        ours = hvd_tf.allreduce(t, compression=getattr(hvd_tf.Compression,
                                                       name))
        theirs = jax_tf.allreduce(t, compression=getattr(
            jax_tf.Compression, name))
        assert ours.dtype == tf.float32
        np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                      theirs.numpy().view(np.uint32))

    def test_bridge_without_dlpack(self, monkeypatch):
        """Where TF refuses DLPack (fp8 has none) the bridge goes through
        numpy, bfloat16 and fp8 by their bits, with the same results."""
        def refuse(*a):
            raise RuntimeError("no DLPack")

        x = tf.constant([1.5, -2.25, 300.0, 0.1])
        want = [hvd_tf.allreduce(tf.cast(x, tf.bfloat16)),
                hvd_tf.allreduce(x, compression=hvd_tf.Compression.fp8),
                hvd_tf.allreduce(tf.constant([2 ** 40, 3], tf.int64))]
        monkeypatch.setattr(tf.experimental.dlpack, "to_dlpack", refuse)
        monkeypatch.setattr(tf.experimental.dlpack, "from_dlpack", refuse)
        got = [hvd_tf.allreduce(tf.cast(x, tf.bfloat16)),
               hvd_tf.allreduce(x, compression=hvd_tf.Compression.fp8),
               hvd_tf.allreduce(tf.constant([2 ** 40, 3], tf.int64))]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(_f64(g), _f64(w))

    def test_step_metrics_framework_label(self):
        from horovod_tpu_torch.observability import registry as reg
        with hvd_tf.StepMetrics(batch_size=4) as m:
            hvd_tf.allreduce(tf.constant([1.0]))
        assert m.framework == "tensorflow" and m.last_step_s > 0
        snap = reg.snapshot("hvdtpu_step_seconds")
        assert 'framework="tensorflow"' in snap["hvdtpu_step_seconds"][
            "values"]


def test_two_rank_gloo_job_against_numpy(tmp_path):
    """Distinct per-rank inputs on 2 gloo ranks: sums over every sweep
    dtype (64-bit included), ``broadcast`` from root 1, ``allgather``'s
    rank order, the average, a grouped allreduce, one under
    ``tf.function``, the tape's averaged gradient and
    ``broadcast_variables`` from root 1 against numpy."""
    import _torch_shim_workers as w
    ranks = w.run(w.tensorflow_rank, str(tmp_path))
    xs = [w.inputs(r) for r in range(w.WORLD)]
    for dt in ("uint8", "int8", "int32", "int64", "float16", "float32",
               "bfloat16", "float64"):
        for res in ranks:
            np.testing.assert_array_equal(res[f"sum.{dt}"], xs[0] + xs[1])
            np.testing.assert_array_equal(res[f"bcast.{dt}"], xs[w.ROOT])
            np.testing.assert_array_equal(res[f"gather.{dt}"],
                                          np.concatenate(xs))
    for res in ranks:
        np.testing.assert_allclose(res["avg"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(res["grouped"][0], xs[0] + xs[1])
        np.testing.assert_array_equal(res["grouped"][1], xs[0] + xs[1] + 2)
        np.testing.assert_array_equal(
            res["grouped"][2], sum(w.inputs(r, np.int32, (4,))
                                   for r in range(w.WORLD)))
        np.testing.assert_array_equal(res["traced"], xs[0] + xs[1])
        np.testing.assert_allclose(res["tape"], xs[0] + xs[1])
        np.testing.assert_array_equal(res["vars"][0], xs[w.ROOT])
        assert res["vars"][1] == w.ROOT + 2 ** 40
