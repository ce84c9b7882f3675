"""The port's axis collectives, tensor-parallel layers and Ulysses
attention against the JAX package's.

One 4-rank gloo job runs every case: axes of 2 on ``create_mesh(dp=2,
sp=2)`` and ``create_mesh(dp=2, tp=2)`` (both dp rows compute the same
case), of 4 on ``create_mesh(sp=4)``.

- Collectives (``psum``, ``ppermute``, tiled ``all_to_all``,
  ``all_gather``, ``psum_scatter``, ``axis_index``, ``axis_size``): each
  rank's forward, and its VJP of a cotangent drawn for it, against the
  ``jax.lax`` collective and ``jax.vjp`` of it inside ``shard_map``
  (``check_vma=False``) on the first 2 or 4 virtual CPU devices. Exact
  for the permutations and all-to-alls, 1e-6 for the sums.
- ``ColumnParallelDense``, ``RowParallelDense`` and ``ParallelMLP`` at
  tp = 2, fp32, each rank given its slice of the same fixed weights:
  forward and the per-rank gradients of the input, kernels and biases
  against the flax modules, within 1e-5 of each tensor's max |value|
  (unit-normal weights give values up to ~15; fp32 products in other
  orders).
- ``ulysses_attention`` at sp = 2 and 4, causal and not, fp32 and bf16:
  as ``tests/test_torch_ring_attention.py`` holds the ring (2e-5 / 1e-4
  in fp32, 3e-2 in bf16), and its head-divisibility error.
"""

import functools
import os
import socket
import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 4

# name: (shard shape at axis size n, exact)
COLLECTIVES = {
    "psum": (lambda n: (3, 5), False),
    "ppermute": (lambda n: (3, 5), True),
    "ppermute_back": (lambda n: (3, 5), True),
    "all_to_all_heads_to_seq": (lambda n: (1, 4, 4, 3), True),
    "all_to_all_seq_to_heads": (lambda n: (1, 4, 4, 3), True),
    "all_gather_0": (lambda n: (2, 3), False),
    "all_gather_1": (lambda n: (2, 3), False),
    "psum_scatter_0": (lambda n: (2 * n, 3), False),
    "psum_scatter_1": (lambda n: (3, 2 * n), False),
}
COLLECTIVE_CASES = {f"{name}-n{n}": (name, n)
                    for name in COLLECTIVES for n in (2, 4)}

TP_IN, TP_HIDDEN, TP_OUT = 8, 8, 6
TP_LAYERS = ("column", "row", "mlp")

B, S, H, D = 2, 32, 4, 8
ULYSSES_CASES = {f"sp{n}-{'causal' if c else 'full'}-{dt}": (n, c, dt)
                 for n in (2, 4) for c in (True, False)
                 for dt in ("float32", "bfloat16")}


def _rng(*key):
    # A seed every process derives alike (str hashes are salted).
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _collective_input(name, n):
    shape = COLLECTIVES[name][0](n)
    return _rng("x", name, n).randn(n * shape[0],
                                    *shape[1:]).astype(np.float32)


def _cotangent(name, n, shard_shape):
    return _rng("g", name, n).randn(n * shard_shape[0],
                                    *shard_shape[1:]).astype(np.float32)


def _tp_weights():
    rng = np.random.RandomState(7)
    w = {"column": {"kernel": rng.randn(TP_IN, TP_OUT),
                    "bias": rng.randn(TP_OUT)},
         "row": {"kernel": rng.randn(TP_HIDDEN, TP_OUT),
                 "bias": rng.randn(TP_OUT)},
         "mlp": {"wi": {"kernel": rng.randn(TP_IN, TP_HIDDEN),
                        "bias": rng.randn(TP_HIDDEN)},
                 "wo": {"kernel": rng.randn(TP_HIDDEN, TP_IN),
                        "bias": rng.randn(TP_IN)}}}
    x = rng.randn(4, TP_IN)
    return (_f32_tree(w), x.astype(np.float32),
            rng.randn(4, TP_HIDDEN).astype(np.float32))


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _tp_cotangent(layer, width):
    return _rng("tp", layer).randn(4, width).astype(np.float32)


def _ulysses_inputs(n, causal, dtype):
    rng = _rng("ulysses", n, causal, dtype)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ workers

def _port_collective(name, x, mesh):
    from horovod_tpu_torch.parallel import collectives as c
    if name == "psum":
        return c.psum(x, mesh, "sp")
    if name == "ppermute":
        return c.ppermute((x,), mesh, "sp")[0]
    if name == "ppermute_back":
        return c.ppermute((x,), mesh, "sp", shift=-1)[0]
    if name == "all_to_all_heads_to_seq":
        return c.all_to_all(x, mesh, "sp", split_axis=2, concat_axis=1)
    if name == "all_to_all_seq_to_heads":
        return c.all_to_all(x, mesh, "sp", split_axis=1, concat_axis=2)
    if name.startswith("all_gather"):
        return c.all_gather(x, mesh, "sp", dim=int(name[-1]))
    return c.psum_scatter(x, mesh, "sp", dim=int(name[-1]))


def _collectives(meshes):
    from horovod_tpu_torch.parallel.collectives import axis_index, axis_size
    out = {}
    for case, (name, n) in COLLECTIVE_CASES.items():
        mesh = meshes[n]
        i = axis_index(mesh, "sp")
        shard = COLLECTIVES[name][0](n)
        x = torch.from_numpy(_collective_input(name, n)).chunk(n)[i]
        x = x.clone().requires_grad_()
        y = _port_collective(name, x, mesh)
        g = torch.from_numpy(_cotangent(name, n, tuple(y.shape))).chunk(n)[i]
        (dx,) = torch.autograd.grad(y, x, g)
        out[case] = (i, y.detach(), dx)
        assert tuple(x.shape) == shard
    out["axis"] = {n: (axis_index(m, "sp"), axis_size(m, "sp"))
                   for n, m in meshes.items()}
    return out


def _load(module, tree, tp_index, specs):
    for name, leaf in tree.items():
        sub = getattr(module, name)
        if isinstance(leaf, dict):
            _load(sub, leaf, tp_index, specs[name])
        else:
            t = torch.from_numpy(leaf)
            if specs[name] is not None:
                t = t.chunk(2, dim=specs[name])[tp_index]
            sub.data.copy_(t)


TP_SPLIT = {"column": {"kernel": 1, "bias": 0},
            "row": {"kernel": 0, "bias": None},
            "mlp": {"wi": {"kernel": 1, "bias": 0},
                    "wo": {"kernel": 0, "bias": None}}}


def _tensor_parallel(mesh):
    from horovod_tpu_torch.parallel import tensor_parallel as tpl
    from horovod_tpu_torch.parallel.collectives import axis_index
    i = axis_index(mesh, "tp")
    weights, x_full, h_full = _tp_weights()
    kw = dict(mesh=mesh, axis="tp", dtype=torch.float32)
    layers = {
        "column": tpl.ColumnParallelDense(TP_IN, TP_OUT, **kw),
        "row": tpl.RowParallelDense(TP_HIDDEN // 2, TP_OUT, **kw),
        "mlp": tpl.ParallelMLP(TP_HIDDEN, TP_IN, **kw),
    }
    out = {}
    for name, layer in layers.items():
        _load(layer, weights[name], i, TP_SPLIT[name])
        x = torch.from_numpy(h_full).chunk(2, dim=1)[i] if name == "row" \
            else torch.from_numpy(x_full)
        x = x.clone().requires_grad_()
        y = layer(x)
        g = torch.from_numpy(_tp_cotangent(name, TP_OUT if name != "mlp"
                                           else TP_IN))
        if name == "column":
            g = g.chunk(2, dim=1)[i]
        params = dict(layer.named_parameters())
        grads = torch.autograd.grad(y, [x, *params.values()], g)
        out[name] = (i, y.detach(), grads[0],
                     dict(zip(params, grads[1:])))
    return out


def _ulysses(meshes):
    from horovod_tpu_torch.parallel.collectives import axis_index
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention
    out = {}
    for case, (n, causal, dt) in ULYSSES_CASES.items():
        mesh = meshes[n]
        i = axis_index(mesh, "sp")
        sl = slice(i * S // n, (i + 1) * S // n)
        q, k, v, g = (torch.tensor(x[:, sl], dtype=getattr(torch, dt),
                                   requires_grad=True)
                      for x in _ulysses_inputs(n, causal, dt))
        o = ulysses_attention(q, k, v, mesh=mesh, axis="sp", causal=causal)
        grads = torch.autograd.grad((o.float() * g.detach().float()).sum(),
                                    (q, k, v))
        out[case] = (i, o.detach(), [x.detach() for x in grads])
    # The head-divisibility error, raised before any collective.
    x = torch.zeros(1, 4, 3, 8)
    try:
        ulysses_attention(x, x, x, mesh=meshes[2], axis="sp")
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    meshes = {2: create_mesh(dp=2, sp=2), 4: create_mesh(sp=4)}
    out = {"collectives": _collectives(meshes),
           "tp": _tensor_parallel(create_mesh(dp=2, tp=2)),
           "ulysses": _ulysses(meshes)}
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("axis_collectives")
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


# ------------------------------------------------------------------ oracles

def _jax_collective(name, n, x):
    from jax import lax
    if name == "psum":
        return lax.psum(x, "sp")
    if name == "ppermute":
        return lax.ppermute(x, "sp", [(i, (i + 1) % n) for i in range(n)])
    if name == "ppermute_back":
        return lax.ppermute(x, "sp", [(i, (i - 1) % n) for i in range(n)])
    if name == "all_to_all_heads_to_seq":
        return lax.all_to_all(x, "sp", 2, 1, tiled=True)
    if name == "all_to_all_seq_to_heads":
        return lax.all_to_all(x, "sp", 1, 2, tiled=True)
    if name.startswith("all_gather"):
        return lax.all_gather(x, "sp", axis=int(name[-1]), tiled=True)
    return lax.psum_scatter(x, "sp", scatter_dimension=int(name[-1]),
                            tiled=True)


@pytest.mark.parametrize("case", sorted(COLLECTIVE_CASES))
def test_collective_forward_and_vjp_match_jax(ranks, case):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    name, n = COLLECTIVE_CASES[case]
    mesh = create_mesh(devices=jax.devices()[:n], sp=n)
    x = _collective_input(name, n)
    fwd = jax.shard_map(functools.partial(_jax_collective, name, n),
                        mesh=mesh, in_specs=P("sp"), out_specs=P("sp"),
                        check_vma=False)
    y = np.asarray(fwd(x))
    g = _cotangent(name, n, (y.shape[0] // n, *y.shape[1:]))

    def vjp(x, g):
        return jax.vjp(functools.partial(_jax_collective, name, n), x)[1](g)[0]

    dx = np.asarray(jax.shard_map(vjp, mesh=mesh, in_specs=(P("sp"),) * 2,
                                  out_specs=P("sp"), check_vma=False)(x, g))
    exact = COLLECTIVES[name][1]
    for out in ranks:
        i, got_y, got_dx = out["collectives"][case]
        for got, want in ((got_y, np.split(y, n)[i]),
                          (got_dx, np.split(dx, n)[i])):
            assert tuple(got.shape) == want.shape
            if exact:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-6)


def test_axis_index_and_size(ranks):
    for r, out in enumerate(ranks):
        assert out["collectives"]["axis"] == {2: (r % 2, 2), 4: (r, 4)}


@pytest.mark.parametrize("layer", TP_LAYERS)
def test_tensor_parallel_layer_matches_flax(ranks, layer):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel import tensor_parallel as jtp
    mesh = create_mesh(devices=jax.devices()[:2], tp=2)
    weights, x_full, h_full = _tp_weights()

    def spec(split):
        if isinstance(split, dict):
            return {k: spec(v) for k, v in split.items()}
        if split is None:
            return P()
        return P(*([None] * split), "tp")

    kw = dict(axis_name="tp", dtype=jnp.float32)
    module = {"column": jtp.ColumnParallelDense(TP_OUT, **kw),
              "row": jtp.RowParallelDense(TP_OUT, **kw),
              "mlp": jtp.ParallelMLP(TP_HIDDEN, TP_IN, **kw)}[layer]
    x = h_full if layer == "row" else x_full
    x_spec = P(None, "tp") if layer == "row" else P()
    g = _tp_cotangent(layer, TP_OUT if layer != "mlp" else TP_IN)
    y_spec = P(None, "tp") if layer == "column" else P()
    p_spec = spec(TP_SPLIT[layer])

    def per_rank(params, x, g):
        def f(params, x):
            return module.apply({"params": params}, x)
        y, pull = jax.vjp(f, params, x)
        dp, dx = pull(g)
        # Stack each rank's values on a new leading axis.
        stack = functools.partial(jax.tree_util.tree_map,
                                  lambda a: a[None])
        return stack(y), stack(dx), stack(dp)

    y, dx, dp = jax.shard_map(
        per_rank, mesh=mesh, in_specs=(p_spec, x_spec, y_spec),
        out_specs=P("tp"), check_vma=False)(weights[layer], x, g)
    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    for out in ranks:
        i, got_y, got_dx, got_dp = out["tp"][layer]
        close(got_y, y[i], "output")
        close(got_dx, dx[i], "input gradient")
        flat = jax.tree_util.tree_flatten_with_path(dp)[0]
        assert len(flat) == len(got_dp)
        for path, leaf in flat:
            key = ".".join(p.key for p in path)
            close(got_dp[key], leaf[i], key)


def _jax_ulysses(n, causal, dt):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.ulysses import ulysses_attention
    mesh = create_mesh(devices=jax.devices()[:n], sp=n)
    attend = functools.partial(ulysses_attention, axis_name="sp",
                               causal=causal)
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
                  for x in _ulysses_inputs(n, causal, dt))
    out = fwd(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        q, k, v, g.astype(jnp.float32))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("case", sorted(ULYSSES_CASES))
def test_ulysses_matches_jax(ranks, case):
    n, causal, dt = ULYSSES_CASES[case]
    want_out, want_grads = _jax_ulysses(n, causal, dt)
    fwd_tol, grad_tol = (2e-5, 1e-4) if dt == "float32" else (3e-2, 3e-2)
    for out in ranks:
        i, o, grads = out["ulysses"][case]
        assert o.dtype == getattr(torch, dt)
        sl = slice(i * S // n, (i + 1) * S // n)
        err = float(np.max(np.abs(o.float().numpy() - want_out[:, sl])))
        assert err < fwd_tol, f"output: {err}"
        for name, g, w in zip("qkv", grads, want_grads):
            err = float(np.max(np.abs(g.float().numpy() - w[:, sl])))
            assert err < grad_tol, f"d{name}: {err}"


def test_ulysses_needs_heads_divisible_by_axis(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.ulysses import ulysses_attention
    mesh = create_mesh(devices=jax.devices()[:2], sp=2)
    x = jnp.zeros((1, 8, 3, 8))
    with pytest.raises(ValueError) as want:
        jax.shard_map(lambda q: ulysses_attention(q, q, q, axis_name="sp"),
                      mesh=mesh, in_specs=P(None, "sp"),
                      out_specs=P(None, "sp"), check_vma=False)(x)
    for out in ranks:
        assert out["ulysses"]["error"] == str(want.value)
