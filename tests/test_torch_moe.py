"""The port's top-1 mixture of experts against the JAX package's
``horovod_tpu/parallel/expert.py`` and the MoE train step against JAX's
``build_train_step`` on the same mesh.

- ``top1_dispatch``: the port's index form (expert, slot, gate, kept),
  with JAX's dense ``dispatch``/``combine`` rebuilt from it, against
  JAX's on the same logits, with ties: exact.
- ``moe_apply`` at ``ep=1`` (JAX inside ``shard_map`` over a one-device
  'ep' axis) with ample capacity (8.0) and with drops (1.0, 0.5): fp32
  within 1e-5, bf16 experts within 3e-2; its gradients in x, router,
  ``wi`` and ``wo`` against ``jax.grad`` within 1e-5 of each
  gradient's max |value| (fp32; the gate's gradient sums its dot
  product in another order).
- One 8-rank gloo job, two Adam(1e-2) steps of each variant, vocab 64,
  d_model 32, 4 heads, 2 layers (layer 1 a MoE of 4 experts), d_ff 64,
  seq 32, batch 4, fp32: JAX's ``test_moe_dp_ep`` configuration
  (capacity 8.0) on ``dp=2, ep=4``; ``tp=2, ep=2, dp=2`` (the tp token
  split, capacity 2.0); and ZeRO-1 on ``dp=2, ep=4`` (the experts'
  moments padded per ep block). JAX runs each on the 8 virtual CPU
  devices; step 1's loss within 1e-5, step 2's within 1e-5 relative
  (Adam's normalised step magnifies the order of the gradients' sums
  where they are near 0), parameters within 1e-4. The ZeRO-1
  variant also matches the port's own replicated step bit for bit.
- ``interop`` round trip of a MoE tree, and its expert shards against
  JAX's ``NamedSharding`` placement.
"""

import os
import socket
import time
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 8
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=32, remat=False)
LR = 1e-2
STEPS = 2
VARIANTS = {
    "dp2_ep4": (dict(dp=2, ep=4), dict(num_experts=4, capacity_factor=8.0),
                False),
    "tp2_ep2_dp2": (dict(dp=2, tp=2, ep=2),
                    dict(num_experts=4, capacity_factor=2.0, tp_axis="tp"),
                    False),
    "zero1_dp2_ep4": (dict(dp=2, ep=4),
                      dict(num_experts=4, capacity_factor=8.0), True),
}


def _seed(*key):
    return zlib.crc32(repr(key).encode())


def _batch():
    rng = np.random.RandomState(1)
    tok = rng.randint(0, CFG["vocab"], size=(4, 33)).astype(np.int64)
    return tok[:, :-1], tok[:, 1:]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ routing


def _logits(t, e, seed, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if ties:
        # Whole rows of one value, and pairs tied at the top.
        x[::5] = 0.5
        x[1::7, 1] = x[1::7, 0] = 3.0
    return x


@pytest.mark.parametrize("capacity", [1, 3, 16])
@pytest.mark.parametrize("ties", [False, True])
def test_top1_dispatch_matches_jax(capacity, ties):
    import jax.numpy as jnp
    from horovod_tpu.parallel.expert import top1_dispatch as jdispatch
    from horovod_tpu_torch.parallel.expert import (dense_dispatch,
                                                   top1_dispatch)
    x = _logits(40, 4, _seed("dispatch", capacity, ties), ties)
    want_d, want_c = (np.asarray(a) for a in jdispatch(jnp.asarray(x),
                                                       capacity))
    d = top1_dispatch(torch.from_numpy(x), capacity)
    got_d, got_c = dense_dispatch(d, 4, capacity)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert int(d.keep.sum()) == int(want_d.sum())


def _moe_inputs(t, f, h, e, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((t, f)).astype(np.float32)
    p = {"router": (rng.standard_normal((f, e)) * 0.25).astype(np.float32),
         "wi": (rng.standard_normal((e, f, h)) * 0.1).astype(np.float32),
         "wo": (rng.standard_normal((e, h, f)) * 0.1).astype(np.float32)}
    dy = rng.standard_normal((t, f)).astype(np.float32)
    return x, p, dy


def _jax_moe(x, p, dy, e, capacity_factor, dtype):
    """JAX's moe_apply in shard_map over a one-device 'ep' axis: its
    output and the gradients of sum(out * dy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel.expert import moe_apply
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))

    def run(pw, xl):
        return moe_apply(pw, xl, num_experts=e,
                         capacity_factor=capacity_factor, axis_name="ep",
                         act=jax.nn.gelu, dtype=dtype)

    f = jax.shard_map(run, mesh=mesh,
                      in_specs=({"router": P(), "wi": P("ep"),
                                 "wo": P("ep")}, P("ep")),
                      out_specs=P("ep"), check_vma=False)
    out = jax.jit(f)(p, x)
    gp, gx = jax.jit(jax.grad(
        lambda pw, xl: jnp.sum(f(pw, xl) * dy), argnums=(0, 1)))(p, x)
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


def _torch_moe(x, p, dy, e, capacity_factor, dtype):
    import functools
    import torch.nn.functional as F
    from horovod_tpu_torch.parallel.expert import moe_apply
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    drops = []
    out = moe_apply(tp, tx, num_experts=e, capacity_factor=capacity_factor,
                    mesh=None, axis=None,
                    act=functools.partial(F.gelu, approximate="tanh"),
                    dtype=dtype, drops=drops)
    (out * torch.from_numpy(dy)).sum().backward()
    return (out.detach().numpy(), {k: v.grad.numpy() for k, v in tp.items()},
            tx.grad.numpy(), int(drops[0]))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(capacity_factor, dtype):
    import jax.numpy as jnp
    e = 4
    x, p, dy = _moe_inputs(64, 16, 32, e, _seed("moe", capacity_factor))
    want, want_gp, want_gx = _jax_moe(x, p, dy, e, capacity_factor,
                                      getattr(jnp, dtype))
    got, gp, gx, dropped = _torch_moe(x, p, dy, e, capacity_factor,
                                      getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert np.abs(got - want).max() <= tol
    # A dropped token's output is zero on both sides.
    assert (np.abs(want).max(1) == 0).sum() == dropped
    if capacity_factor == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0
    if dtype == "float32":
        for name, g in [("x", gx)] + sorted(gp.items()):
            ref = want_gx if name == "x" else want_gp[name]
            err = np.abs(g - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, f"d{name}: {err}"


# ------------------------------------------------------------ the step


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh, place
    from horovod_tpu_torch.parallel.train import build_train_step
    from horovod_tpu_torch.parallel.zero import Zero1Optimizer
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    tree = _torch_tree(tree.item())
    tok, tgt = _batch()

    def factory(p):
        return torch.optim.Adam(p, lr=LR, betas=(0.9, 0.999), eps=1e-8)

    def train(cfg, mesh, zero1):
        step = build_train_step(cfg, factory, mesh=mesh, device="cpu")
        model = step.make_model(params=step.shard_params(tree))
        opt = step.make_optimizer(model, zero1=zero1)
        assert isinstance(opt, Zero1Optimizer) == zero1
        losses = [float(step(model, opt,
                             step.shard_batch(torch.from_numpy(tok)),
                             step.shard_batch(torch.from_numpy(tgt))))
                  for _ in range(STEPS)]
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        moments = ({n: opt.state[s]["exp_avg"].numel() for (n, _), s
                    in zip(model.named_parameters(), opt.shadows)}
                   if zero1 else None)
        return losses, sd, moments

    out = {}
    for name, (axes, kw, zero1) in VARIANTS.items():
        mesh = create_mesh(**axes)
        cfg = ttfm.TransformerConfig(dtype=torch.float32, ep_axis="ep",
                                     **kw, **CFG)
        losses, sd, moments = train(cfg, mesh, zero1)
        out[name] = {"place": place(mesh), "losses": losses, "params": sd,
                     "moment_numel": moments}
        if zero1:
            ref_losses, ref_sd, _ = train(cfg, mesh, False)
            out[name]["same_as_replicated"] = (
                ref_losses == losses
                and all(torch.equal(sd[k], ref_sd[k]) for k in sd))
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _jax_cfg(**kw):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    return jtfm.TransformerConfig(dtype=jnp.float32, ep_axis="ep", **kw,
                                  **CFG)


@pytest.fixture(scope="module")
def tree():
    import jax
    from horovod_tpu.models import transformer as jtfm
    return jax.device_get(jtfm.init_params(
        _jax_cfg(num_experts=4), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_train")
    np.save(d / "tree.npy", tree, allow_pickle=True)
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


def _jax_train(tree, variant):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_train_step
    from horovod_tpu.parallel.zero import zero1_init
    axes, kw, zero1 = VARIANTS[variant]
    cfg = _jax_cfg(**kw)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    mesh = create_mesh(**axes)
    make, shard_p, shard_b = build_train_step(cfg, mesh, opt)
    state = (zero1_init(opt, tree, n_shards=axes["dp"],
                        param_specs=jtfm.param_specs(cfg), mesh=mesh)
             if zero1 else opt.init(tree))
    step, _ = make(tree, state)
    tok, tgt = _batch()
    params = shard_p(tree)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, shard_b(jnp.asarray(tok)),
                                   shard_b(jnp.asarray(tgt)))
        losses.append(float(loss))
    return jax.device_get(params), losses


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_step_matches_jax(ranks, tree, variant):
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import TransformerConfig
    params, want_losses = _jax_train(tree, variant)
    _, kw, _ = VARIANTS[variant]
    cfg = TransformerConfig(ep_axis="ep", **kw, **CFG)
    for out in ranks:
        got = out[variant]
        # Step 1's loss comes before any update: 1e-5. A later one is
        # relative (1e-5, as TestZero1), since Adam's normalised step
        # magnifies the gradients' summation order where they are near 0.
        assert abs(got["losses"][0] - want_losses[0]) < 1e-5
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        want = interop.shard_from_jax(params, cfg, *got["place"])
        assert got["params"].keys() == want.keys()
        for key in want:
            assert got["params"][key].shape == want[key].shape, key
            err = float((got["params"][key] - want[key]).abs().max())
            assert err < 1e-4, f"{variant} {key}: {err}"


def test_zero1_with_experts_is_the_replicated_step(ranks):
    """ZeRO-1 over 'dp' with ep-sharded experts: each rank's moments are
    1/dp of its padded block, and the step equals the replicated one."""
    from horovod_tpu_torch.parallel.zero import _padded_size
    for out in ranks:
        got = out["zero1_dp2_ep4"]
        assert got["same_as_replicated"]
        for name, numel in got["moment_numel"].items():
            local = got["params"][name].numel()
            assert numel == _padded_size(local, 2) // 2, name
        # The experts: 4 over ep=4, one per rank.
        assert got["params"]["layers.1.moe.wi"].shape == (1, 32, 64)


def test_every_rank_holds_its_place(ranks):
    for name, (axes, _, _) in VARIANTS.items():
        seen = {tuple(sorted(out[name]["place"][1].items()))
                for out in ranks}
        assert len(seen) == WORLD
        assert all(out[name]["place"][0] == axes for out in ranks)


# ------------------------------------------------------------ interop


def test_interop_round_trip_of_a_moe_tree(tree):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models import transformer as ttfm
    sd = interop.params_from_jax(tree)
    assert "layers.1.moe.wi" in sd and "layers.1.wi" not in sd
    back = interop.params_to_jax(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    cfg = ttfm.TransformerConfig(num_experts=4, ep_axis="ep",
                                 dtype=torch.float32, **CFG)
    # The expert shards against JAX's placement on dp=2, ep=4.
    jcfg = _jax_cfg(num_experts=4)
    mesh = create_mesh(dp=2, ep=4)
    specs = jtfm.param_specs(jcfg)
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, P))
    sizes = {a: int(mesh.shape[a]) for a in mesh.axis_names}
    n = 0
    for pos in np.ndindex(*mesh.devices.shape):
        device = mesh.devices[pos]
        got = interop.shard_from_jax(tree, cfg, sizes,
                                     dict(zip(mesh.axis_names, pos)))
        for key in ("router", "wi", "wo"):
            arr = placed["layers"][1]["moe"][key]
            shard = next(s for s in arr.addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(got[f"layers.1.moe.{key}"].numpy(),
                                          np.asarray(shard.data))
            n += 1
    assert n == 8 * 3


def test_moe_config_needs_its_axis():
    from horovod_tpu_torch.models import transformer as ttfm
    with pytest.raises(ValueError, match="ep_axis"):
        ttfm.TransformerConfig(num_experts=4, **CFG)
    cfg = ttfm.TransformerConfig(num_experts=4, ep_axis="ep", **CFG)
    with pytest.raises(ValueError, match="mesh"):
        ttfm.Transformer(cfg, device="cpu")
    specs = ttfm.param_specs(cfg)
    assert specs["layers"][1]["moe"] == {"router": (),
                                         "wi": ("ep", None, None),
                                         "wo": ("ep", None, None)}
    assert "moe" not in specs["layers"][0]
