"""The port's Keras shim on Keras's tensorflow backend (the counterpart
of ``tests/test_keras_tf.py``).

Keras fixes one backend per process and ``tests/test_torch_keras.py``
pins this one to torch, so the tensorflow-backend path — ``model.fit``
tracing the shim's allreduce through ``tf.function`` via the port's TF
shim — runs in fresh interpreters: two gloo ranks (the wrapped optimizer
reduces only above world 1) on identical data, once per module. Each
test asserts its own marker from rank 0's output:

  - the gradient path crosses the collective engine during ``fit``
    (submissions counted), and training under the DistributedOptimizer
    matches plain SGD (the average of identical gradients is the
    identity);
  - ``BroadcastGlobalVariablesCallback`` broadcasts every weight and
    keeps the root's values;
  - ``MetricAverageCallback`` routes the epoch metrics through allreduce;
  - the TF shim's ``DistributedOptimizer`` applies gradients;
  - the host ``allreduce``/``allgather``/``broadcast`` on TF tensors.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["KERAS_BACKEND"] = "tensorflow"
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    import numpy as np
    import keras
    import tensorflow as tf
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.keras as hvd_keras
    import horovod_tpu_torch.tensorflow as hvd_tf
    from horovod_tpu_torch import ops as _ops

    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=2)
    counts = {"allreduce": 0, "broadcast": 0}
    _ar, _bc = _ops.allreduce_async, _ops.broadcast_async
    def ar(*a, **kw):
        counts["allreduce"] += 1
        return _ar(*a, **kw)
    def bc(*a, **kw):
        counts["broadcast"] += 1
        return _bc(*a, **kw)
    _ops.allreduce_async, _ops.broadcast_async = ar, bc

    def build():
        keras.utils.set_random_seed(0)
        return keras.Sequential([keras.layers.Input((8,)),
                                 keras.layers.Dense(16, activation="relu"),
                                 keras.layers.Dense(2)])

    x = np.random.RandomState(1).rand(16, 8).astype("float32")
    y = np.random.RandomState(2).rand(16, 2).astype("float32")

    ref = build()
    ref.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
    ref.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0)
    before = counts["allreduce"]
    dist = build()
    dist.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.1)), loss="mse")
    dist.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0)
    n = counts["allreduce"] - before
    assert n >= 4, f"no collective in the fit path ({n})"
    for wr, wd in zip(ref.get_weights(), dist.get_weights()):
        assert np.allclose(wr, wd, atol=1e-5), (wr, wd)
    print("TFK1_GRAD_PATH_OK", n, flush=True)

    before = counts["broadcast"]
    m2 = build()
    m2.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(0.1)), loss="mse")
    w_pre = [np.array(w) for w in m2.get_weights()]
    m2.fit(x, y, batch_size=8, epochs=1, verbose=0, steps_per_epoch=1,
           callbacks=[hvd_keras.callbacks.BroadcastGlobalVariablesCallback(
               0)])
    assert counts["broadcast"] - before >= len(w_pre), counts
    print("TFK2_BROADCAST_OK", counts["broadcast"] - before, flush=True)

    m3 = build()
    m3.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(0.1)), loss="mse", metrics=["mae"])
    before = counts["allreduce"]
    hist = m3.fit(x, y, batch_size=8, epochs=1, verbose=0,
                  callbacks=[hvd_keras.callbacks.MetricAverageCallback()])
    n = counts["allreduce"] - before
    assert n >= 4 + 2, n
    assert np.isfinite(hist.history["loss"][0])
    print("TFK3_METRIC_AVG_OK", n, flush=True)

    opt2 = hvd_tf.DistributedOptimizer(keras.optimizers.SGD(0.05))
    assert opt2._hvd_wrapped
    v = tf.Variable([1.0, 2.0])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(v * v)
    g = tape.gradient(loss, [v])
    opt2.apply_gradients(zip(g, [v]))
    assert np.allclose(v.numpy(), [0.9, 1.8]), v
    print("TFK4_TF_SHIM_OK", flush=True)

    s = hvd_keras.allreduce(tf.constant([1.0, 2.0]), average=False)
    assert np.allclose(np.asarray(s), [2.0, 4.0]), s
    a = hvd_keras.allreduce(tf.constant([4.0]), average=True)
    assert np.allclose(np.asarray(a), [4.0]), a
    g2 = hvd_keras.allgather(tf.constant([[1.0, 2.0]]))
    assert np.asarray(g2).shape == (2, 2), g2
    b = hvd_keras.broadcast(tf.constant([3.0, 4.0]), root_rank=0)
    assert np.allclose(np.asarray(b), [3.0, 4.0]), b
    print("TFK5_FUNCTIONAL_OK", flush=True)
    hvd.shutdown()
""")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tf_backend_run():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PYTEST_CURRENT_TEST", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(r), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=540))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs[0]


def _check(run, marker):
    out, err = run
    assert marker in out, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"


def test_fit_gradient_path_uses_collective_and_matches_sgd(tf_backend_run):
    _check(tf_backend_run, "TFK1_GRAD_PATH_OK")


def test_broadcast_callback_broadcasts_all_weights(tf_backend_run):
    _check(tf_backend_run, "TFK2_BROADCAST_OK")


def test_metric_average_callback_allreduces_metrics(tf_backend_run):
    _check(tf_backend_run, "TFK3_METRIC_AVG_OK")


def test_tf_shim_distributed_optimizer_applies(tf_backend_run):
    _check(tf_backend_run, "TFK4_TF_SHIM_OK")


def test_functional_collectives_on_tf_tensors(tf_backend_run):
    _check(tf_backend_run, "TFK5_FUNCTIONAL_OK")
