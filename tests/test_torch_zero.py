"""The port's ZeRO-1 (``horovod_tpu_torch/parallel/zero.py``) against the
JAX package's ``horovod_tpu/parallel/zero.py`` and ZeRO-1 step: the
counterpart of ``tests/test_parallel.py::TestZero1``.

- The layout helpers (``_spec_axes_ordered``, ``_padded_size``,
  ``_flat_pad``) against JAX's, exact.
- One 4-rank gloo job, three AdamW(1e-2, weight decay 1e-4) steps of
  the LM (vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64, seq 32,
  batch 8, fp32):
  - ZeRO-1 on ``dp=4`` against the port's replicated mesh step:
    parameters within 1e-6 (the same elementwise AdamW; the
    gradients' sums may run in another order);
  - ZeRO-1 on ``dp=4`` and on ``dp=2, tp=2`` (a tp block's moments
    padded per block) against JAX's ZeRO-1 step on the same mesh of
    virtual CPU devices: step 1's loss within 1e-5, every step's within
    1e-5 relative (TestZero1's ``rtol``), parameters within 1e-5;
  - each rank's moments hold 1/dp of its padded elements, the shapes
    that JAX's ``zero1_state_specs`` gives one device, and
    ``_model_factor`` is JAX's on every spec.
- In this process: JAX's four refusals (a mesh with no 'dp', a state
  built for another dp, a spec that uses 'dp', ZeRO-1 with
  ``dcn_axis``).
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 4
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=32, remat=False)
LR, WD = 1e-2, 1e-4
STEPS = 3
VARIANTS = {"dp4": (dict(dp=4), {}),
            "dp2_tp2": (dict(dp=2, tp=2), dict(tp_axis="tp"))}


def _batch():
    rng = np.random.RandomState(1)
    tok = rng.randint(0, CFG["vocab"], size=(8, 33)).astype(np.int64)
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


def _factory(p):
    return torch.optim.AdamW(p, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WD)


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh, place, spec_of
    from horovod_tpu_torch.parallel.train import build_train_step
    from horovod_tpu_torch.parallel.zero import (_model_factor,
                                                 zero1_state_specs)
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    tree = _torch_tree(tree.item())
    tok, tgt = _batch()
    out = {}
    for name, (axes, kw) in VARIANTS.items():
        mesh = create_mesh(**axes)
        cfg = ttfm.TransformerConfig(dtype=torch.float32, **kw, **CFG)
        step = build_train_step(cfg, _factory, mesh=mesh, device="cpu")
        runs = {}
        for zero1 in (True, False):
            model = step.make_model(params=step.shard_params(tree))
            opt = step.make_optimizer(model, zero1=zero1)
            losses = [float(step(model, opt,
                                 step.shard_batch(torch.from_numpy(tok)),
                                 step.shard_batch(torch.from_numpy(tgt))))
                      for _ in range(STEPS)]
            runs[zero1] = (losses, {k: v.detach().clone()
                                    for k, v in model.state_dict().items()})
            if zero1:
                names = [n for n, _ in model.named_parameters()]
                moments = {n: (tuple(opt.state[s]["exp_avg"].shape),
                               tuple(opt.state[s]["exp_avg_sq"].shape))
                           for n, s in zip(names, opt.shadows)}
                shapes = {n: tuple(s) for n, s in
                          zero1_state_specs(axes["dp"], model).items()}
                factors = {n: _model_factor(spec_of(step.specs, n), mesh)
                           for n in names}
        out[name] = {"place": place(mesh), "zero1": runs[True],
                     "replicated": runs[False], "moments": moments,
                     "shapes": shapes, "factors": factors}
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _jax_cfg(**kw):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    return jtfm.TransformerConfig(dtype=jnp.float32, **kw, **CFG)


@pytest.fixture(scope="module")
def tree():
    import jax
    from horovod_tpu.models import transformer as jtfm
    return jax.device_get(jtfm.init_params(_jax_cfg(),
                                           jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("zero1")
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


def _jax_zero1(tree, variant):
    """JAX's ZeRO-1 run: (params, losses, per-device state shapes by
    dotted parameter name, the jax mesh)."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_train_step
    from horovod_tpu.parallel.zero import zero1_init
    axes, kw = VARIANTS[variant]
    cfg = _jax_cfg(**kw)
    mesh = create_mesh(devices=jax.devices()[:WORLD], **axes)
    opt = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    state = zero1_init(opt, tree, n_shards=axes["dp"],
                       param_specs=jtfm.param_specs(cfg), mesh=mesh)
    make, shard_p, shard_b = build_train_step(cfg, mesh, opt)
    step, _ = make(tree, state)
    tok, tgt = _batch()
    params, losses = shard_p(tree), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, shard_b(jnp.asarray(tok)),
                                   shard_b(jnp.asarray(tgt)))
        losses.append(float(loss))
    mu = state.inner[0].mu
    shapes = {"embed": mu["embed"], "pos": mu["pos"], "ln_f": mu["ln_f"]}
    for i, layer in enumerate(mu["layers"]):
        shapes.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    shapes = {k: tuple(v.addressable_shards[0].data.shape)
              for k, v in shapes.items()}
    return jax.device_get(params), losses, shapes, mesh, cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zero1_matches_jax(ranks, tree, variant):
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel.zero import _model_factor as jfactor
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import TransformerConfig
    params, want_losses, want_shapes, mesh, jcfg = _jax_zero1(tree, variant)
    cfg = TransformerConfig(**VARIANTS[variant][1], **CFG)
    jspecs = jtfm.param_specs(jcfg)
    for out in ranks:
        got = out[variant]
        losses, sd = got["zero1"]
        assert abs(losses[0] - want_losses[0]) < 1e-5
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        want = interop.shard_from_jax(params, cfg, *got["place"])
        assert sd.keys() == want.keys()
        for key in want:
            err = float((sd[key] - want[key]).abs().max())
            assert err < 1e-5, f"{variant} {key}: {err}"
        assert got["shapes"] == want_shapes
        assert all(m == (s, s) for m, s in zip(got["moments"].values(),
                                               got["shapes"].values()))
        for name, factor in got["factors"].items():
            parts = name.split(".")
            spec = (jspecs[name] if len(parts) == 1
                    else jspecs["layers"][int(parts[1])][parts[2]])
            assert factor == jfactor(spec, mesh), name


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zero1_is_the_replicated_step(ranks, variant):
    dp = VARIANTS[variant][0]["dp"]
    for out in ranks:
        got = out[variant]
        (lz, z), (lr, r) = got["zero1"], got["replicated"]
        np.testing.assert_allclose(lz, lr, rtol=1e-6)
        for key in r:
            assert float((z[key] - r[key]).abs().max()) <= 1e-6, key
            numel = r[key].numel()
            # 1/dp of the padded elements.
            assert got["shapes"][key] == (-(-numel // dp),), key


def test_layout_helpers_match_jax():
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import zero as jzero
    from horovod_tpu_torch.parallel import zero as tzero
    for spec, pspec in [((), P()), ((None, "tp"), P(None, "tp")),
                        (("ep", None, None), P("ep", None, None)),
                        ((("dp", "tp"), None), P(("dp", "tp"), None))]:
        assert tzero._spec_axes_ordered(spec) == \
            jzero._spec_axes_ordered(pspec)
    for n in (1, 7, 8, 1000, 1001):
        for k in (1, 2, 3, 4, 8):
            assert tzero._padded_size(n, k) == jzero._padded_size(n, k)
    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    for k in (1, 3, 4, 8):
        np.testing.assert_array_equal(
            tzero._flat_pad(torch.from_numpy(x), k).numpy(),
            np.asarray(jzero._flat_pad(jnp.asarray(x), k)))


def test_zero1_refusals():
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    from horovod_tpu_torch.parallel.zero import zero1_init
    thvd.init(device="cpu")
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    tp_cfg = ttfm.TransformerConfig(dtype=torch.float32, tp_axis="tp", **CFG)
    step = build_train_step(tp_cfg, _factory, device="cpu",
                            mesh=create_mesh(tp=1))
    with pytest.raises(ValueError, match="requires a 'dp' mesh axis"):
        step.make_optimizer(step.make_model(), zero1=True)

    step = build_train_step(cfg, _factory, device="cpu",
                            mesh=create_mesh(dp=1))
    model = step.make_model()
    tok = torch.zeros(2, 8, dtype=torch.long)
    wrong = zero1_init(_factory, model, 2, step.mesh)
    with pytest.raises(ValueError, match="n_shards=2 but this mesh's 'dp' "
                                         "axis has 1"):
        step(model, wrong, tok, tok)
    step.specs["layers"][0]["wq"] = ("dp", None)
    with pytest.raises(ValueError, match="already uses 'dp'"):
        step.make_optimizer(model, zero1=True)

    step = build_train_step(cfg, _factory, device="cpu",
                            mesh=create_mesh(dcn=1, dp=1), dcn_axis="dcn")
    with pytest.raises(ValueError, match="mutually exclusive"):
        step.make_optimizer(step.make_model(), zero1=True)
