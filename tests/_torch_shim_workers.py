"""2-rank gloo jobs of the port's framework shims, held to numpy: each
rank draws distinct inputs from its own seed, and the sums, averages,
``broadcast`` from root 1 and ``allgather``'s rank order must equal
numpy's over every rank's inputs (which each rank can redraw). Kept free
of JAX: the workers are spawned processes."""

import json
import multiprocessing as mp
import os
import socket
import time

import numpy as np

WORLD = 2
ROOT = 1
TIMEOUT_S = 240


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def inputs(rank, dtype=np.float32, shape=(5, 3)):
    """Rank ``rank``'s input: small integers, so every sum is exact."""
    rs = np.random.RandomState(100 + rank)
    return rs.randint(0, 10, size=shape).astype(dtype)


def _init(rank, port):
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
             rank=rank, world_size=WORLD)
    return hvd


def mxnet_rank(rank, port, out):
    hvd = _init(rank, port)
    import horovod_tpu_torch.mxnet as mx
    from horovod_tpu_torch.mxnet import nd
    res = {}
    for dt in ("uint8", "int8", "int32", "int64", "float16", "float32",
               "float64"):
        x = nd.array(inputs(rank, dt), dtype=dt, ctx="cpu")
        res[f"sum.{dt}"] = mx.allreduce(x, average=False).asnumpy().tolist()
        res[f"bcast.{dt}"] = mx.broadcast(x, ROOT).asnumpy().tolist()
        res[f"gather.{dt}"] = mx.allgather(x).asnumpy().tolist()
    x = nd.array(inputs(rank), ctx="cpu")
    res["avg"] = mx.allreduce(x).asnumpy().tolist()
    mx.broadcast_(x, ROOT)
    res["bcast_"] = x.asnumpy().tolist()
    ts = [nd.array(inputs(rank) + i, ctx="cpu") for i in range(3)]
    mx.allreduce_multi_(ts, average=False, name_prefix="mk")
    res["multi"] = [t.asnumpy().tolist() for t in ts]

    class SGD:
        learning_rate = 0.5

        def update(self, index, weight, grad, state):
            weight -= self.learning_rate * grad

    opt = mx.DistributedOptimizer(SGD())
    w = nd.array(np.ones((5, 3), np.float32), ctx="cpu")
    g = nd.array(inputs(rank), ctx="cpu")
    opt.update(0, w, g, None)
    res["update_w"] = w.asnumpy().tolist()
    params = {"a": nd.array(inputs(rank) * 2, ctx="cpu"),
              "b": nd.array(inputs(rank, shape=(4,)), ctx="cpu")}
    mx.broadcast_parameters(params, root_rank=ROOT)
    res["params"] = {k: v.asnumpy().tolist() for k, v in params.items()}
    hvd.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def tensorflow_rank(rank, port, out):
    hvd = _init(rank, port)
    import tensorflow as tf
    tf.config.threading.set_intra_op_parallelism_threads(1)
    tf.config.threading.set_inter_op_parallelism_threads(1)
    import horovod_tpu_torch.tensorflow as hvd_tf
    res = {}
    for dt in ("uint8", "int8", "int32", "int64", "float16", "float32",
               "bfloat16", "float64"):
        x = tf.cast(tf.constant(inputs(rank)), dt)
        res[f"sum.{dt}"] = tf.cast(hvd_tf.allreduce(x, average=False),
                                   tf.float64).numpy().tolist()
        res[f"bcast.{dt}"] = tf.cast(hvd_tf.broadcast(x, ROOT),
                                     tf.float64).numpy().tolist()
        res[f"gather.{dt}"] = tf.cast(hvd_tf.allgather(x),
                                      tf.float64).numpy().tolist()
    x = tf.constant(inputs(rank))
    res["avg"] = hvd_tf.allreduce(x).numpy().tolist()
    res["grouped"] = [o.numpy().tolist() for o in hvd_tf.grouped_allreduce(
        [x, x + 1, tf.constant(inputs(rank, np.int32, (4,)))],
        average=False)]

    @tf.function
    def traced(v):
        return hvd_tf.allreduce(v, average=False)

    res["traced"] = traced(x).numpy().tolist()
    v = tf.Variable(inputs(rank))
    with hvd_tf.DistributedGradientTape() as tape:
        loss = tf.reduce_sum(v * v)
    res["tape"] = tape.gradient(loss, [v])[0].numpy().tolist()
    w = [tf.Variable(inputs(rank)), tf.Variable(np.int64(rank + 2 ** 40))]
    hvd_tf.broadcast_variables(w, root_rank=ROOT)
    res["vars"] = [w[0].numpy().tolist(), int(w[1].numpy())]
    hvd.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def keras_rank(rank, port, out):
    os.environ["KERAS_BACKEND"] = "torch"
    hvd = _init(rank, port)
    import keras
    import horovod_tpu_torch.keras as hvd_keras
    res = {}
    x = inputs(rank)
    res["sum"] = hvd_keras.allreduce(x, average=False).tolist()
    res["avg"] = hvd_keras.allreduce(x).tolist()
    res["gather"] = hvd_keras.allgather(x).tolist()
    res["bcast"] = hvd_keras.broadcast(x, ROOT).tolist()

    def model():
        keras.utils.set_random_seed(0)
        return keras.Sequential([keras.layers.Input((3,)),
                                 keras.layers.Dense(2)])

    # One step of SGD(lr=1) on this rank's batch: the wrapped optimizer
    # applies the average of both ranks' gradients.
    m = model()
    m.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=1.0)), loss="mse",
        jit_compile=False)
    res["w0"] = [w.tolist() for w in m.get_weights()]
    y = inputs(rank, shape=(5, 2)) / 10
    m.fit(x / 10, y, batch_size=5, epochs=1, shuffle=False, verbose=0)
    res["w1"] = [w.tolist() for w in m.get_weights()]
    # broadcast_variables from root 1 over distinct weights.
    v = keras.Variable(inputs(rank, shape=(3,)))
    hvd_keras.broadcast_variables([v], root_rank=ROOT)
    res["var"] = keras.ops.convert_to_numpy(v).tolist()
    cb = hvd_keras.callbacks.MetricAverageCallback()
    logs = {"loss": float(rank + 1)}
    cb._average_metrics_in_place(logs)
    res["metric"] = logs["loss"]
    hvd.shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run(target, outdir):
    """Run ``target`` on 2 spawned ranks; every rank's results."""
    ctx = mp.get_context("spawn")
    port = _port()
    procs = [ctx.Process(target=target, args=(r, port, outdir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * WORLD:
        raise RuntimeError(f"{target.__name__} exited {codes}")
    out = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
