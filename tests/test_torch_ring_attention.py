"""The port's ring attention against the JAX package's, at sp = 2 and 4
(Ulysses: ``tests/test_torch_axis_collectives.py``).

One 4-rank gloo job runs every case: sp = 2 on ``create_mesh(dp=2,
sp=2)`` (both dp rows compute the same case) and sp = 4 on
``create_mesh(sp=4)``. Each rank takes its sequence shard of inputs
drawn once with numpy, computes the forward and the gradients of the
loss summed over the ranks (each rank's backward runs the ring's
transposes), and keeps its shard of both. JAX runs
``ring_attention(use_flash=False/True, flash_interpret=True)`` under
``shard_map`` on the first 2 or 4 virtual CPU devices, with
``jax.grad`` of the psum of the same loss. The loss is ``sum(out * g)``
with a cotangent ``g`` drawn with the inputs, so the gradients are the
VJP of ``g``.

Tolerances: fp32 inputs 2e-5 on the output and 1e-4 on the gradients
(blockwise sums in other orders); bf16 inputs 3e-2 (one bf16 rounding
at other points).
"""

import functools
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 4
B, S, H, D = 2, 32, 4, 8

CASES = {}
for _n in (2, 4):
    for _causal in (True, False):
        for _dt in ("float32", "bfloat16"):
            for _impl in ("ring", "ring_flash"):
                CASES[f"{_impl}-sp{_n}-{'causal' if _causal else 'full'}"
                      f"-{_dt}"] = (_impl, _n, _causal, _dt)


def _inputs(n, causal, dtype):
    rng = np.random.RandomState(100 * n + 10 * causal + (dtype == "bfloat16"))
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.collectives import axis_index
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    meshes = {2: create_mesh(dp=2, sp=2), 4: create_mesh(sp=4)}
    out = {}
    for name, (impl, n, causal, dt) in CASES.items():
        mesh = meshes[n]
        i = axis_index(mesh, "sp")
        sl = slice(i * S // n, (i + 1) * S // n)
        q, k, v, g = (torch.tensor(x[:, sl], dtype=getattr(torch, dt),
                                   requires_grad=True)
                      for x in _inputs(n, causal, dt))
        g = g.detach().float()
        o = ring_attention(q, k, v, mesh=mesh, axis="sp", causal=causal,
                           use_flash=impl == "ring_flash")
        loss = (o.float() * g).sum()
        grads = torch.autograd.grad(loss, (q, k, v))
        out[name] = (i, o.detach(), [x.detach() for x in grads])
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_ulysses")
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


def _jax_case(impl, n, causal, dt):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.ring_attention import ring_attention
    mesh = create_mesh(devices=jax.devices()[:n], sp=n)
    attend = functools.partial(ring_attention, axis_name="sp",
                               causal=causal, use_flash=impl == "ring_flash",
                               flash_interpret=True)
    spec = P(None, "sp")
    fwd = jax.jit(jax.shard_map(attend, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=spec, check_vma=False))

    def loss(q, k, v, g):
        def shard(q, k, v, g):
            o = attend(q, k, v)
            return lax.psum((o.astype(jnp.float32) * g).sum(), "sp")
        return jax.shard_map(shard, mesh=mesh, in_specs=(spec,) * 4,
                             out_specs=P(), check_vma=False)(q, k, v, g)

    q, k, v, g = (jnp.asarray(x, getattr(jnp, dt))
                  for x in _inputs(n, causal, dt))
    out = fwd(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        q, k, v, g.astype(jnp.float32))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(ranks, case):
    impl, n, causal, dt = CASES[case]
    want_out, want_grads = _jax_case(impl, n, causal, dt)
    fwd_tol, grad_tol = (2e-5, 1e-4) if dt == "float32" else (3e-2, 3e-2)
    for out in ranks:
        i, o, grads = out[case]
        assert o.dtype == getattr(torch, dt)
        sl = slice(i * S // n, (i + 1) * S // n)
        err = float(np.max(np.abs(o.float().numpy() - want_out[:, sl])))
        assert err < fwd_tol, f"output: {err}"
        for name, g, w in zip("qkv", grads, want_grads):
            err = float(np.max(np.abs(g.float().numpy() - w[:, sl])))
            assert err < grad_tol, f"d{name}: {err}"
