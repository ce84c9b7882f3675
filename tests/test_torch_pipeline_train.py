"""The port's pipelined flagship (``build_pipeline_train_step`` in
``horovod_tpu_torch/parallel/train.py``) against the JAX package's on
the same layout: the counterpart of ``tests/test_pipeline.py``'s
``TestPipelineTrainStep`` and ``TestPipelineWithDataParallel``.

The model is ``tests/test_pipeline.py``'s (vocab 64, d_model 16, 2
heads, 4 layers, d_ff 32, seq 8, fp32, no remat), a batch of 8 as m = 4
microbatches of 2, SGD(0.05), the weights JAX's ``init_params`` in JAX's
pipeline layout. One 8-rank gloo job runs:

- one step of each variant on the 'pp' rows of a mesh: 1f1b, zb-h1,
  gpipe and 1f1b with ``use_flash=True`` (the kernels' plain versions)
  over pp = 4 (``create_mesh(pp=4, dp=2)``, each row alone), and
  interleaved with V = 2 over pp = 2 (``create_mesh(pp=2, dcn=2,
  dp=2)``); each rank's model built by ``shard_params`` must hold what
  ``interop.pipeline_from_jax`` gives. Against JAX's step on n virtual
  CPU devices: the loss within 1e-5, every parameter after the step
  (every rank's state gathered by ``interop.pipeline_to_jax``, then
  ``from_pipeline_params``) within 1e-4 of its max |value|; the
  replicated parameters the same bits on every rank;
- every refusal of ``build_pipeline_train_step`` (no 'pp' axis; tp, sp
  or ep; experts; another axis larger than 1; layers that do not divide;
  ``num_virtual`` against the schedule), with JAX's text;
- ``TestPipelineWithDataParallel``'s composition on ``create_mesh(pp=2,
  dcn=2, dp=2)``: each data shard pipelines its slice (1f1b) and the
  gradients are averaged over ('dcn', 'dp') by ``hierarchical_psum`` and
  by the flat ``data_parallel.allreduce_gradients``: the two within 1e-6,
  each against JAX's run (loss 1e-5, gradients 1e-5 of max |value|).

In this process: the virtual transport (4 or 2 stages in lockstep) gives
the gloo job's loss and parameters bit for bit; ``remat`` (full and
dots, which zb-h1 refuses) gives the step without it bit for bit; ``to_pipeline_params``,
``from_pipeline_params`` and the interop pair bit for bit against JAX's
layout.
"""

import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240
WORLD = 8
CFG = dict(vocab=64, d_model=16, n_heads=2, n_layers=4, d_ff=32, max_seq=8)
B, S, M = 8, 8, 4
LR = 0.05
# name: (schedule, pp, num_virtual, config options)
STEPS = {
    "1f1b": ("1f1b", 4, 1, {}),
    "zb-h1": ("zb-h1", 4, 1, {}),
    "gpipe": ("gpipe", 4, 1, {}),
    "1f1b-flash": ("1f1b", 4, 1, {"use_flash": True}),
    "interleaved": ("interleaved", 2, 2, {}),
}
REFUSALS = ("no_pp", "tp", "sp", "ep", "experts", "extra_axis",
            "indivisible", "interleaved_v1", "1f1b_v2")


def _batch():
    rng = np.random.RandomState(11)
    tok = rng.randint(0, CFG["vocab"], (B, S)).astype(np.int64)
    tgt = rng.randint(0, CFG["vocab"], (B, S)).astype(np.int64)
    return tok.reshape(M, B // M, S), tgt.reshape(M, B // M, S)


def _composition_data():
    rng = np.random.RandomState(9)
    stages = [{"w": (rng.randn(4, 4) * 0.5).astype(np.float32),
               "b": (rng.randn(4) * 0.1).astype(np.float32)}
              for _ in range(2)]
    x = np.random.RandomState(11).randn(4, 8, 4).astype(np.float32)
    return stages, x


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


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _loss_fn(y):
    return (y.float() ** 2).mean()


def _torch_cfg(**kw):
    from horovod_tpu_torch.models.transformer import TransformerConfig
    base = dict(dtype=torch.float32, remat=False, use_flash=False)
    base.update(kw)
    return TransformerConfig(**base, **CFG)


def _sgd(p):
    return torch.optim.SGD(p, lr=LR)


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _refusals(build, cfg_of, meshes):
    """Each refusal's text (None if it did not raise)."""
    experts = cfg_of(ep_axis="ep", num_experts=8)
    object.__setattr__(experts, "ep_axis", None)
    pp4, flat = meshes["pp4"], meshes["no_pp"]
    return {
        "no_pp": _refusal(lambda: build(cfg_of(), flat)),
        "tp": _refusal(lambda: build(cfg_of(tp_axis="tp"), pp4)),
        "sp": _refusal(lambda: build(cfg_of(sp_axis="sp"), pp4)),
        "ep": _refusal(lambda: build(cfg_of(ep_axis="ep", num_experts=8),
                                     pp4)),
        "experts": _refusal(lambda: build(experts, pp4)),
        "extra_axis": _refusal(lambda: build(cfg_of(), meshes["pp_dp"])),
        "indivisible": _refusal(lambda: build(
            dataclasses.replace(cfg_of(), n_layers=6), pp4)),
        "interleaved_v1": _refusal(lambda: build(
            cfg_of(), pp4, schedule="interleaved", num_virtual=1)),
        "1f1b_v2": _refusal(lambda: build(cfg_of(), pp4, schedule="1f1b",
                                          num_virtual=2)),
    }


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.parallel import (allreduce_gradients,
                                            create_mesh, hierarchical_psum,
                                            pipeline_value_and_grad)
    from horovod_tpu_torch.parallel.mesh import place, shard_tensor
    from horovod_tpu_torch.parallel.train import build_pipeline_train_step
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    trees = np.load(os.path.join(outdir, "trees.npy"),
                    allow_pickle=True).item()
    pp4_dp = create_mesh(pp=4, dp=2)
    composed = create_mesh(pp=2, dcn=2, dp=2)
    meshes = {4: pp4_dp["pp"], 2: composed["pp"]}
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    out = {}
    for name, (schedule, n, v, kw) in STEPS.items():
        mesh = meshes[n]
        r = mesh.get_local_rank("pp")
        step = build_pipeline_train_step(
            _torch_cfg(**kw), mesh, _sgd, schedule=schedule, num_virtual=v,
            device="cpu")
        ptree = trees[(n, v)]
        model = step.make_model(params=step.shard_params(_torch_tree(ptree)))
        want = interop.pipeline_from_jax(ptree, r)
        got = model.state_dict()
        same = (got.keys() == want.keys()
                and all(torch.equal(got[k], want[k]) for k in want))
        opt = step.make_optimizer(model)
        loss = step(model, opt, step.shard_batch(tok), step.shard_batch(tgt))
        out[name] = {"pp": r, "row": _row(mesh), "shards": same,
                     "loss": float(loss),
                     "state": {k: t.detach().clone()
                               for k, t in model.state_dict().items()}}
    out["refusals"] = _refusals(
        lambda cfg, mesh, **kw: build_pipeline_train_step(
            cfg, mesh, _sgd, device="cpu", **kw),
        _torch_cfg, {"pp4": meshes[4], "no_pp": create_mesh(dp=8),
                     "pp_dp": pp4_dp})

    stages, x = _composition_data()
    sizes, coords = place(composed)
    x_local = shard_tensor(torch.from_numpy(x), (None, ("dcn", "dp")),
                           sizes, coords)
    p = {k: torch.from_numpy(a) for k, a in stages[coords["pp"]].items()}
    loss, g = pipeline_value_and_grad(_stage_fn, _loss_fn, p, x_local,
                                      composed, "pp", schedule="1f1b")
    loss = allreduce_gradients(loss, composed, ("dcn", "dp"))
    out["composition"] = {
        "coords": coords, "loss": float(loss),
        "hier": {k: hierarchical_psum(t, composed, "dp", "dcn",
                                      average=True).numpy()
                 for k, t in g.items()},
        "flat": {k: t.numpy() for k, t in allreduce_gradients(
            g, composed, ("dcn", "dp")).items()}}
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _row(mesh):
    """The global ranks of this rank's 'pp' row, in 'pp' order."""
    import torch.distributed as dist
    return tuple(dist.get_process_group_ranks(mesh.get_group("pp")))


# ------------------------------------------------------------ JAX side

def _jax_cfg(**kw):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    base = dict(dtype=jnp.float32, remat=False, use_flash=False)
    base.update(kw)
    return jtfm.TransformerConfig(**base, **CFG)


@pytest.fixture(scope="module")
def params():
    import jax
    from horovod_tpu.models import transformer as jtfm
    return jax.device_get(jtfm.init_params(_jax_cfg(),
                                           jax.random.PRNGKey(0)))


def _jax_layout(params, n, v):
    import jax
    from horovod_tpu.parallel.train import to_pipeline_params
    return jax.device_get(to_pipeline_params(_jax_cfg(), params, n, v))


@pytest.fixture(scope="module")
def job(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline_train")
    trees = {(n, v): _jax_layout(params, n, v)
             for _, n, v, _ in STEPS.values()}
    np.save(d / "trees.npy", trees, allow_pickle=True)
    ctx = mp.spawn(_worker, args=(_free_port(), str(d)), nprocs=WORLD,
                   join=False)
    return ctx, d


def _jax_step(params, name):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import (build_pipeline_train_step,
                                            from_pipeline_params)
    schedule, n, v, kw = STEPS[name]
    cfg = _jax_cfg(**kw)
    opt = optax.sgd(LR)
    mesh = create_mesh(devices=jax.devices()[:n], pp=n)
    make, shard_p, shard_b = build_pipeline_train_step(
        cfg, mesh, opt, schedule=schedule, num_virtual=v)
    pparams = _jax_layout(params, n, v)
    state = opt.init(pparams)
    step, _ = make(pparams, state)
    tok, tgt = _batch()
    new, _, loss = step(shard_p(pparams), state,
                        shard_b(jnp.asarray(tok, jnp.int32)),
                        shard_b(jnp.asarray(tgt, jnp.int32)))
    return float(loss), jax.device_get(
        from_pipeline_params(cfg, jax.device_get(new), n, v))


def _jax_composition(reduction):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.collectives import hierarchical_psum
    from horovod_tpu.parallel.pipeline import pipeline_value_and_grad
    stages, x = _composition_data()
    packed = {k: np.stack([s[k] for s in stages]) for k in ("w", "b")}
    mesh = create_mesh(pp=2, dcn=2, dp=2)

    def run(p_local, x_local):
        p = jax.tree_util.tree_map(lambda l: l[0], p_local)
        loss, g = pipeline_value_and_grad(
            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
            lambda y: jnp.mean(y.astype(jnp.float32) ** 2), p, x_local,
            axis_name="pp", schedule="1f1b")
        loss = lax.pmean(loss, ("dcn", "dp"))
        if reduction == "hier":
            g = jax.tree_util.tree_map(
                lambda t: hierarchical_psum(t, "dp", "dcn", average=True), g)
        else:
            g = jax.tree_util.tree_map(
                lambda t: lax.pmean(t, ("dcn", "dp")), g)
        return loss, jax.tree_util.tree_map(lambda l: l[None], g)

    f = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=({"w": P("pp"), "b": P("pp")},
                                  P(None, ("dcn", "dp"))),
        out_specs=(P(), P("pp")), check_vma=False))
    loss, g = f(packed, x)
    return float(loss), jax.device_get(g)


def _jax_refusals():
    import jax
    import optax
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_pipeline_train_step
    devs = jax.devices()
    return _refusals(
        lambda cfg, mesh, **kw: build_pipeline_train_step(
            cfg, mesh, optax.sgd(LR), **kw),
        _jax_cfg, {"pp4": create_mesh(devices=devs[:4], pp=4),
                   "no_pp": create_mesh(devices=devs, dp=8),
                   "pp_dp": create_mesh(devices=devs, pp=4, dp=2)})


@pytest.fixture(scope="module")
def jax_results(job, params):
    """JAX's steps, composition and refusals, once (while the gloo job
    runs)."""
    out = {name: _jax_step(params, name) for name in STEPS}
    out["composition"] = {r: _jax_composition(r) for r in ("hier", "flat")}
    out["refusals"] = _jax_refusals()
    return out


@pytest.fixture(scope="module")
def ranks(job, jax_results):
    ctx, d = job
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------------- checks

def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def _flat_params(tree):
    """(name, array) of a flat-layout tree, in a fixed order."""
    out = [(k, np.asarray(tree[k])) for k in ("embed", "pos", "ln_f")]
    for i, layer in enumerate(tree["layers"]):
        out += [(f"layers.{i}.{k}", np.asarray(layer[k]))
                for k in sorted(layer)]
    return out


def _rows(ranks, name):
    """Each 'pp' row's outputs, in 'pp' order."""
    rows = {}
    for out in ranks:
        rows.setdefault(out[name]["row"], []).append(out[name])
    return [sorted(row, key=lambda o: o["pp"]) for row in rows.values()]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_matches_jax(ranks, jax_results, name):
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.parallel.train import from_pipeline_params
    _, n, v, kw = STEPS[name]
    want_loss, want = jax_results[name]
    rows = _rows(ranks, name)
    assert len(rows) == WORLD // n
    for row in rows:
        assert [o["pp"] for o in row] == list(range(n))
        for o in row:
            assert o["shards"], name
            assert abs(o["loss"] - want_loss) <= 1e-5 * abs(want_loss), name
            for key in ("embed", "pos", "ln_f"):
                assert torch.equal(o["state"][key], row[0]["state"][key])
        got = from_pipeline_params(
            _torch_cfg(**kw),
            _torch_tree(interop.pipeline_to_jax([o["state"] for o in row])),
            n, v)
        for (k, a), (k2, b) in zip(_flat_params(got), _flat_params(want)):
            assert k == k2
            assert a.shape == b.shape, k
            assert _rel(a, b) < 1e-4, f"{name} {k}: {_rel(a, b)}"


@pytest.mark.parametrize("name", sorted(STEPS))
def test_virtual_stages_are_the_gloo_step(ranks, params, name):
    """The same step on n virtual stages in this process: the gloo
    job's loss and parameters, bit for bit."""
    from horovod_tpu_torch.parallel.train import _virtual_pipeline_train_step
    schedule, n, v, kw = STEPS[name]
    step = _virtual_pipeline_train_step(_torch_cfg(**kw), n, _sgd,
                                        schedule=schedule, num_virtual=v,
                                        device="cpu")
    tree = _torch_tree(_jax_layout(params, n, v))
    models = [step.make_model(params=step.shard_params(tree, r))
              for r in range(n)]
    opts = [step.make_optimizer(m) for m in models]
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    loss = float(step(models, opts, tok, tgt))
    (row, *_) = _rows(ranks, name)
    for model, o in zip(models, row):
        assert loss == o["loss"]
        state = model.state_dict()
        assert all(torch.equal(state[k], o["state"][k]) for k in state)


@pytest.mark.parametrize("which", REFUSALS)
def test_refusals_match_jax(ranks, jax_results, which):
    want = jax_results["refusals"][which]
    assert want is not None
    for out in ranks:
        assert out["refusals"][which] == want


def test_composition_with_data_parallel_matches_jax(ranks, jax_results):
    jax_loss = {r: jax_results["composition"][r][0] for r in ("hier",
                                                                "flat")}
    assert abs(jax_loss["hier"] - jax_loss["flat"]) < 1e-7
    for out in ranks:
        c = out["composition"]
        assert abs(c["loss"] - jax_loss["flat"]) <= 1e-5
        for k in ("w", "b"):
            assert float(np.abs(c["hier"][k] - c["flat"][k]).max()) < 1e-6
            for red in ("hier", "flat"):
                want = np.asarray(jax_results["composition"][red][1][k])[
                    c["coords"]["pp"]]
                assert _rel(c[red][k], want) < 1e-5, (red, k)


@pytest.mark.parametrize("schedule,n,v", [("1f1b", 4, 1), ("zb-h1", 4, 1),
                                          ("gpipe", 4, 1),
                                          ("interleaved", 2, 2)])
def test_remat_is_the_same_step(params, schedule, n, v):
    """``remat`` (full, and but for zb-h1 the dots policy) recomputes the
    stage in backward: the loss and parameters of the step without it,
    bit for bit."""
    from horovod_tpu_torch.parallel.train import _virtual_pipeline_train_step
    tree = _torch_tree(_jax_layout(params, n, v))
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    runs = []
    policies = [{}, {"remat": True}]
    if schedule != "zb-h1":
        policies.append({"remat": True, "remat_policy": "dots"})
    for kw in policies:
        step = _virtual_pipeline_train_step(_torch_cfg(**kw), n, _sgd,
                                            schedule=schedule,
                                            num_virtual=v, device="cpu")
        models = [step.make_model(params=step.shard_params(tree, r))
                  for r in range(n)]
        loss = step(models, [step.make_optimizer(m) for m in models], tok,
                    tgt)
        runs.append((float(loss), [m.state_dict() for m in models]))
    for loss, states in runs[1:]:
        assert loss == runs[0][0]
        for a, b in zip(states, runs[0][1]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_zb_h1_refuses_the_dots_policy():
    """ZB-H1's W walks each microbatch's graph a second time, which
    torch's selective checkpoint refuses; the step says so when built."""
    from horovod_tpu_torch.parallel.train import _virtual_pipeline_train_step
    cfg = _torch_cfg(remat=True, remat_policy="dots")
    with pytest.raises(ValueError, match="selective checkpoint"):
        _virtual_pipeline_train_step(cfg, 4, _sgd, schedule="zb-h1",
                                     device="cpu")


@pytest.mark.parametrize("n,v", [(4, 1), (2, 2), (1, 4)])
def test_pipeline_layout_round_trips_with_jax(params, n, v):
    from horovod_tpu.parallel.train import (from_pipeline_params,
                                            pipeline_param_specs)
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.parallel import train as ttrain
    jtree = _jax_layout(params, n, v)
    got = ttrain.to_pipeline_params(_torch_cfg(), _torch_tree(params), n, v)
    for key in ("embed", "pos", "ln_f"):
        assert np.array_equal(got[key].numpy(), jtree[key])
    assert got["stages"].keys() == jtree["stages"].keys()
    for key, arr in jtree["stages"].items():
        assert got["stages"][key].shape == arr.shape
        assert np.array_equal(got["stages"][key].numpy(), arr)
    back = ttrain.from_pipeline_params(_torch_cfg(), got, n, v)
    jback = from_pipeline_params(_jax_cfg(), jtree, n, v)
    for (k, a), (k2, b) in zip(_flat_params(back), _flat_params(jback)):
        assert k == k2 and np.array_equal(a, b), k
    assert (set(ttrain.pipeline_param_specs(_torch_cfg())["stages"])
            == set(pipeline_param_specs(_jax_cfg())["stages"]))
    step = ttrain._virtual_pipeline_train_step(_torch_cfg(), n, _sgd,
                                               num_virtual=v, device="cpu",
                                               schedule="interleaved"
                                               if v > 1 else "1f1b")
    states = []
    for r in range(n):
        sd = interop.pipeline_from_jax(jtree, r)
        model = step.make_model(params=step.shard_params(got, r))
        assert sd.keys() == model.state_dict().keys()
        assert all(torch.equal(t, sd[k])
                   for k, t in model.state_dict().items())
        states.append(sd)
    again = interop.pipeline_to_jax(states)
    for key in ("embed", "pos", "ln_f"):
        assert np.array_equal(again[key], jtree[key])
    for key, arr in jtree["stages"].items():
        assert again["stages"][key].dtype == np.float32
        assert np.array_equal(again["stages"][key], arr)
