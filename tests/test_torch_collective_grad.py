"""Gradients through the port's synchronous collectives: ``allreduce``,
``allgather`` and ``broadcast`` are autograd Functions whose backward is a
collective, as the JAX package's torch shim registers them
(``horovod_tpu/torch/mpi_ops.py``; the ports of ``tests/test_torch.py``'s
``test_allreduce_grad``, ``test_allgather_grad`` and
``test_broadcast_grad_root``).

- At world size 1, against the shim on one device (the same inputs,
  drawn with numpy): sum and average allreduce, the fp16 cast
  compressor, allgather and broadcast, gradients bit for bit.
- On gloo jobs of 2 and 3 ranks, against the closed form: rank r's loss
  is ``sum(w_r * op(x_r))`` with weights of its own, so the gradient of
  ``x_r`` is the sum over ranks of the weights that its values reach:
  ``sum_s w_s`` for a sum allreduce (over n for the average, times the
  pre- and postscale), the rows of ``sum_s W_s`` that rank r's rows
  occupy in the gather (a ragged gather too, rank r contributing r + 1
  rows), and ``sum_s w_s`` on the root of a broadcast, zeros elsewhere.
  Tolerance 1e-6 of the largest term (fp32 sums in another order).
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import Compression as TCompression

JOB_TIMEOUT_S = 180
WORLDS = (2, 3)


def _rng(*key):
    return np.random.RandomState(1000 * key[0] + key[1])


def _x(rank, rows=4):
    return _rng(1, rank).standard_normal((rows, 3)).astype(np.float32)


def _w(rank, shape, k):
    return _rng(2 + k, rank).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- world size 1


@pytest.fixture(scope="module")
def shim_one_device():
    """The shim on one device, the port on a gloo world of one."""
    import jax

    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    thvd.shutdown()
    thvd.init(device="cpu")
    import horovod_tpu.torch as shim
    yield shim
    thvd.shutdown()
    hvd.shutdown()
    hvd.init()


def _grad(op, x, w):
    t = torch.tensor(x, requires_grad=True)
    out = op(t)
    (out * torch.tensor(w)).sum().backward()
    assert out.grad_fn is not None
    return out.detach(), t.grad


CASES = {
    "allreduce_sum": lambda m: lambda t: m.allreduce(t, average=False),
    "allreduce_average": lambda m: lambda t: m.allreduce(t, average=True),
    "allreduce_fp16": lambda m: lambda t: m.allreduce(
        t, average=False, compression=m.Compression.fp16),
    "allgather": lambda m: lambda t: m.allgather(t),
    "broadcast": lambda m: lambda t: m.broadcast(t, root_rank=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_the_shim_at_world_one(shim_one_device, case):
    x = _x(0)
    w = _w(0, x.shape, 0)
    want_out, want = _grad(CASES[case](shim_one_device), x, w)
    got_out, got = _grad(CASES[case](thvd), x, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got_out, want_out)
    assert torch.equal(got, want)


def test_compression_is_the_port_compressor(shim_one_device):
    t = torch.rand(8, requires_grad=True)
    out = thvd.allreduce(t, average=True, compression=TCompression.fp16)
    out.sum().backward()
    assert out.dtype == torch.float32
    assert torch.equal(t.grad, torch.ones(8))


def test_inplace_and_async_ops_stay_outside_autograd(shim_one_device):
    t = torch.rand(4)
    assert thvd.allreduce_(t, average=False) is t
    h = thvd.allreduce_async(torch.rand(4, requires_grad=True))
    assert h.wait().grad_fn is None


# ------------------------------------------------------------ gloo 2-3 ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, n, port, outdir):
    torch.set_num_threads(1)
    thvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
              rank=rank, world_size=n)
    out = {}
    x = _x(rank)
    ops = {
        "sum": (lambda t: thvd.allreduce(t, average=False), x.shape),
        "average": (lambda t: thvd.allreduce(t, average=True), x.shape),
        "scaled": (lambda t: thvd.allreduce(t, average=False,
                                            prescale_factor=0.5,
                                            postscale_factor=3.0), x.shape),
        "gather": (thvd.allgather, (4 * n, 3)),
        "broadcast": (lambda t: thvd.broadcast(t, root_rank=1), x.shape),
    }
    for k, (name, (op, shape)) in enumerate(sorted(ops.items())):
        out[name] = _grad(op, x, _w(rank, shape, k))[1]
    xr = _x(rank, rows=rank + 1)
    total = n * (n + 1) // 2
    out["ragged"] = _grad(thvd.allgather, xr, _w(rank, (total, 3), 9))[1]
    thvd.shutdown()
    torch.save(out, f"{outdir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{n: [rank 0's gradients, ...]} of a 2- and a 3-rank job, run at
    once."""
    ctxs = {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"grad{n}")
        ctxs[n] = (d, mp.spawn(_worker, args=(n, _free_port(), str(d)),
                               nprocs=n, join=False))
    deadline = time.monotonic() + JOB_TIMEOUT_S
    for n, (d, ctx) in ctxs.items():
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c[1].processes:
                        p.kill()
                pytest.fail(f"the {n}-rank job did not finish within "
                            f"{JOB_TIMEOUT_S} s")
    return {n: [torch.load(d / f"rank{r}.pt") for r in range(n)]
            for n, (d, _) in ctxs.items()}


NAMES = sorted(["sum", "average", "scaled", "gather", "broadcast"])


def _closed_form(name, n, rank):
    k = NAMES.index(name)
    if name == "gather":
        w = sum(_w(s, (4 * n, 3), k) for s in range(n))
        return w[4 * rank:4 * rank + 4]
    w = sum(_w(s, (4, 3), k) for s in range(n))
    if name == "average":
        return w / n
    if name == "scaled":
        return w * 1.5
    if name == "broadcast":
        return w if rank == 1 else np.zeros_like(w)
    return w


@pytest.mark.parametrize("name", NAMES + ["ragged"])
@pytest.mark.parametrize("n", WORLDS)
def test_gradients_are_the_closed_form_on_gloo(jobs, n, name):
    total = n * (n + 1) // 2
    for rank, out in enumerate(jobs[n]):
        if name == "ragged":
            w = sum(_w(s, (total, 3), 9) for s in range(n))
            start = rank * (rank + 1) // 2
            want = w[start:start + rank + 1]
        else:
            want = _closed_form(name, n, rank)
        got = out[name].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))
