"""The port's mesh train step against the JAX package's
``build_train_step`` on the same mesh: the counterpart of
``tests/test_parallel.py::TestTrainStepParity::test_dense_dp_tp_sp``.

One 8-rank gloo job (``dp=2, tp=2, sp=2``, fp32, ``remat=True``, vocab
64, d_model 32, 4 heads, 2 layers, d_ff 64, seq 32, batch 4) runs one
SGD step of each variant: ring attention plain, ring attention on the
flash path (the kernels' plain versions here) and Ulysses, plus the
ring with ``remat_policy="dots"``. Each rank builds its model from its
shard of one JAX-initialised tree (``shard_params``, which must equal
``interop.shard_from_jax``) and takes its block of the batch
(``shard_batch``). JAX runs the same step on
``create_mesh(dp=2, tp=2, sp=2)`` of the 8 virtual CPU devices; its
updated parameters are cut at each rank's coordinate and compared.
``shard_from_jax`` itself is held to the per-device shards of JAX's
``NamedSharding`` placement.

Tolerances (fp32; the two sides sum in other orders): loss 1e-5,
parameters after the step 1e-4, shards exact.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 8
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=32)
LR = 0.1
VARIANTS = {
    "ring": {},
    "ring_flash": {"use_flash": True},
    "ulysses": {"sp_impl": "ulysses"},
    "ring_remat_dots": {"remat_policy": "dots"},
}


def _batch():
    rng = np.random.RandomState(1)
    tok = rng.randint(0, CFG["vocab"], size=(4, 32)).astype(np.int64)
    return tok, np.roll(tok, -1, axis=1)


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


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh, place
    from horovod_tpu_torch.parallel.train import (MeshTrainStep,
                                                  build_train_step)
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    mesh = create_mesh(dp=2, tp=2, sp=2)
    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    tree = tree.item()
    tok, tgt = _batch()
    out = {"place": place(mesh)}
    for name, kw in VARIANTS.items():
        cfg = ttfm.TransformerConfig(dtype=torch.float32, tp_axis="tp",
                                     sp_axis="sp", remat=True, **kw, **CFG)
        step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=LR),
                                mesh=mesh, device="cpu")
        assert isinstance(step, MeshTrainStep)
        model = step.make_model(params=step.shard_params(_torch_tree(tree)))
        want = interop.shard_from_jax(tree, cfg, *place(mesh))
        out[f"{name}_shards"] = all(torch.equal(v, want[k]) for k, v
                                    in model.state_dict().items())
        opt = step.make_optimizer(model)
        loss = step(model, opt, step.shard_batch(torch.from_numpy(tok)),
                    step.shard_batch(torch.from_numpy(tgt)))
        out[name] = (float(loss), {k: v.detach().clone()
                                   for k, v in model.state_dict().items()})
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _jax_cfg(**kw):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    return jtfm.TransformerConfig(dtype=jnp.float32, tp_axis="tp",
                                  sp_axis="sp", remat=True, **kw, **CFG)


@pytest.fixture(scope="module")
def tree():
    import jax
    from horovod_tpu.models import transformer as jtfm
    return jax.device_get(jtfm.init_params(_jax_cfg(),
                                           jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
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


def _jax_step(tree, variant):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_train_step
    opt = optax.sgd(LR)
    mesh = create_mesh(dp=2, tp=2, sp=2)
    make, shard_p, shard_b = build_train_step(_jax_cfg(**VARIANTS[variant]),
                                              mesh, opt)
    state = opt.init(tree)
    step, _ = make(tree, state)
    tok, tgt = _batch()
    params, _, loss = step(shard_p(tree), state, shard_b(jnp.asarray(tok)),
                           shard_b(jnp.asarray(tgt)))
    return jax.device_get(params), float(loss)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh_step_matches_jax(ranks, tree, variant):
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import TransformerConfig
    params, want_loss = _jax_step(tree, variant)
    cfg = TransformerConfig(tp_axis="tp", sp_axis="sp", **CFG)
    for out in ranks:
        assert out[f"{variant}_shards"]
        got_loss, got = out[variant]
        assert abs(got_loss - want_loss) < 1e-5
        want = interop.shard_from_jax(params, cfg, *out["place"])
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].shape == want[key].shape, key
            err = float((got[key] - want[key]).abs().max())
            assert err < 1e-4, f"{variant} {key}: {err}"


def test_every_rank_holds_its_place(ranks):
    seen = {tuple(sorted(out["place"][1].items())) for out in ranks}
    assert len(seen) == WORLD
    assert all(out["place"][0] == {"dp": 2, "tp": 2, "sp": 2}
               for out in ranks)


def test_shard_from_jax_matches_named_sharding(tree):
    import jax
    from jax.sharding import NamedSharding
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import TransformerConfig
    mesh = create_mesh(dp=2, tp=2, sp=2)
    specs = jtfm.param_specs(_jax_cfg())
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    names = mesh.axis_names
    sizes = {a: int(mesh.shape[a]) for a in names}
    cfg = TransformerConfig(tp_axis="tp", sp_axis="sp", **CFG)
    flat = {"embed": placed["embed"], "pos": placed["pos"],
            "ln_f": placed["ln_f"]}
    for i, layer in enumerate(placed["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    n_checked = 0
    for pos in np.ndindex(*mesh.devices.shape):
        device = mesh.devices[pos]
        coords = dict(zip(names, pos))
        got = interop.shard_from_jax(tree, cfg, sizes, coords)
        for key, arr in flat.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(shard.data))
            n_checked += 1
    assert n_checked == 8 * len(flat)
