"""The engine's hierarchical allreduce and allgather against the JAX
package's ``horovod_tpu/executor.py`` (``_hier_reduce``,
``_hier_gather``): the ports of ``tests/test_ops.py``'s
``TestHierarchical`` and ``tests/test_multiprocess.py``'s
``TestHierarchicalMultiProcess``.

One 4-rank gloo job with ``LOCAL_WORLD_SIZE=2`` (two "nodes" of two
ranks: dcn = 2, ici = 2). Only rank 0 sets
``HOROVOD_TPU_HIERARCHICAL_ALLREDUCE`` and ``_ALLGATHER``: rank 0's plan
rules every rank's execution, so a rank that ran a group flat would
enter other collectives than its peers.

- Allreduce, each rank's inputs drawn from its own numpy seed: fp32 and
  int32 of odd lengths (the padding to a multiple of ici), sum and
  average, a fused submission of several tensors and dtypes, bf16
  (accumulated in fp32), bit for bit JAX's ``_fused_reduce`` with
  ``_hier_reduce`` as the reduction under ``shard_map`` over a
  ``('dcn', 'ici')`` mesh of 4 CPU devices, on every rank.
- The multi-process case: rank r contributes ``r // 2 + 1`` five times
  (sum 6 each) and ones seven times (average 1).
- A blockwise wire skips the hierarchy, as JAX's does: bit for bit
  JAX's flat ``_fused_reduce(wire=...)`` over 'dp'.
- Allgather, equal and ragged first dims: bit for bit the flat gather
  (the concatenation of every rank's input in rank order).
- The plan's flags: each group carries rank 0's hierarchical flags.
"""

import os
import socket
import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 180
WORLD, ICI = 4, 2
# (name, dtype, length, average); several with one fused submission.
CASES = [("odd_sum", "float32", 37, False), ("odd_avg", "float32", 37, True),
         ("int_sum", "int32", 7, False), ("bf16_sum", "bfloat16", 19, False),
         ("even_sum", "float32", 64, False)]
FUSED = [("fused.a", "float32", 5, False), ("fused.b", "float32", 11, False),
         ("fused.c", "int32", 3, False)]
WIRE = "int8x256"


def _np(name, dtype, n, rank):
    rng = np.random.RandomState(zlib.crc32(f"{name}/{rank}".encode()))
    if dtype == "int32":
        return rng.randint(-1000, 1000, size=n).astype(np.int32)
    return rng.standard_normal(n).astype(np.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, outdir):
    os.environ["LOCAL_WORLD_SIZE"] = str(ICI)
    if rank == 0:
        os.environ["HOROVOD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
        os.environ["HOROVOD_TPU_HIERARCHICAL_ALLGATHER"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.ops import collective
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    out = {"local_size": hvd.local_size()}
    for name, dtype, n, avg in CASES:
        out[name] = hvd.allreduce(_torch(_np(name, dtype, n, rank), dtype),
                                  average=avg, name=name)
    fused = hvd.grouped_allreduce(
        [_torch(_np(nm, dt, n, rank), dt) for nm, dt, n, _ in FUSED],
        average=False, name="fused")
    out.update({nm: t for (nm, *_), t in zip(FUSED, fused)})
    out["mp_sum"] = hvd.allreduce(torch.full((5,), float(rank // 2 + 1)),
                                  average=False, name="hier.sum")
    out["mp_avg"] = hvd.allreduce(torch.ones(7), average=True,
                                  name="hier.avg")
    out["wire"] = hvd.allreduce(
        _torch(_np("wire", "float32", 300, rank), "float32"), average=False,
        name="wire", compression=Compression.int8_blockwise)
    out["gather"] = hvd.allgather(torch.arange(10.0).reshape(5, 2) + rank,
                                  name="gather")
    out["ragged"] = hvd.allgather(torch.full((rank + 1, 3), float(rank)),
                                  name="ragged")
    out["flags"] = collective.engine()._coord.flags
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier_engine")
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


def _jax_per_rank(cases, average, wire=None):
    """Each device's results of JAX's ``_fused_reduce`` over its own
    inputs: hierarchical over ('dcn', 'ici') without a wire, flat over
    'dp' with one."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.executor import _fused_reduce, _hier_reduce
    from horovod_tpu.quantization import parse

    devs = np.array(jax.devices()[:WORLD])
    if wire is None:
        mesh, spec = Mesh(devs.reshape(WORLD // ICI, ICI),
                          ("dcn", "ici")), P(("dcn", "ici"))

        def reduce_fn(b):
            return _hier_reduce(b, ICI)
    else:
        mesh, spec = Mesh(devs, ("dp",)), P("dp")

        def reduce_fn(b):
            return jax.lax.psum(b, "dp")
    xs = [jnp.stack([jnp.asarray(_np(nm, dt, n, r), dtype=getattr(jnp, dt))
                     for r in range(WORLD)]) for nm, dt, n, _ in cases]

    def body(*ys):
        outs = _fused_reduce(tuple(y[0] for y in ys), reduce_fn, 1.0,
                             1.0 / WORLD if average else 1.0,
                             wire=parse(wire), axis="dp", world=WORLD)
        return tuple(o[None] for o in outs)

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=tuple(spec for _ in xs),
                               out_specs=tuple(spec for _ in xs),
                               check_vma=False))
    return {c[0]: np.asarray(o.astype(jnp.float32) if c[1] == "bfloat16"
                             else o)
            for c, o in zip(cases, fn(*xs))}


def _np_of(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_hierarchical_allreduce_bit_for_bit_jax(ranks, case):
    want = _jax_per_rank([case], case[3])[case[0]]
    for r, out in enumerate(ranks):
        got = _np_of(out[case[0]])
        assert got.dtype == want.dtype and got.shape == want[r].shape
        np.testing.assert_array_equal(got, want[r])


def test_fused_group_bit_for_bit_jax(ranks):
    want = _jax_per_rank(FUSED, False)
    for r, out in enumerate(ranks):
        for nm, *_ in FUSED:
            np.testing.assert_array_equal(out[nm].numpy(), want[nm][r])


def test_hierarchical_allreduce_matches_flat(ranks):
    """``test_ops.py``'s odd-length case: the sum of every rank's input
    (up to the order of the fp32 sums)."""
    flat = sum(_np("odd_sum", "float32", 37, r) for r in range(WORLD))
    for out in ranks:
        np.testing.assert_allclose(out["odd_sum"].numpy(), flat, rtol=1e-6,
                                   atol=1e-6)


def test_multiprocess_hierarchical_sums(ranks):
    for out in ranks:
        assert out["local_size"] == ICI
        assert out["mp_sum"].tolist() == [6.0] * 5
        assert out["mp_avg"].tolist() == [1.0] * 7


def test_blockwise_wire_skips_the_hierarchy(ranks):
    want = _jax_per_rank([("wire", "float32", 300, False)], False,
                         wire=WIRE)["wire"]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["wire"].numpy(), want[r])


def test_hierarchical_allgather_is_the_flat_gather(ranks):
    flat = torch.cat([torch.arange(10.0).reshape(5, 2) + r
                      for r in range(WORLD)])
    ragged = torch.cat([torch.full((r + 1, 3), float(r))
                        for r in range(WORLD)])
    for out in ranks:
        assert torch.equal(out["gather"], flat)
        assert torch.equal(out["ragged"], ragged)


def test_rank_zero_stamps_its_flags_into_the_plan(ranks):
    from horovod_tpu_torch.ops.control_plane import (
        FLAG_HIERARCHICAL_ALLGATHER, FLAG_HIERARCHICAL_ALLREDUCE)
    both = FLAG_HIERARCHICAL_ALLREDUCE | FLAG_HIERARCHICAL_ALLGATHER
    assert [out["flags"] for out in ranks] == [both, 0, 0, 0]


def test_env_knobs(monkeypatch):
    """``test_ops.py``'s env-knob case: both switches and their
    ``HOROVOD_*`` fallback."""
    from horovod_tpu_torch.utils import env
    for name in ("HIERARCHICAL_ALLREDUCE", "HIERARCHICAL_ALLGATHER"):
        fn = getattr(env, name.lower())
        monkeypatch.delenv("HOROVOD_TPU_" + name, raising=False)
        monkeypatch.delenv("HOROVOD_" + name, raising=False)
        assert fn() is False
        monkeypatch.setenv("HOROVOD_" + name, "1")
        assert fn() is True
        monkeypatch.setenv("HOROVOD_TPU_" + name, "0")
        assert fn() is False
