"""The port's pipeline schedules (``horovod_tpu_torch/parallel/
pipeline.py``) against the JAX package's ``pipeline_value_and_grad`` and
``pipeline_apply`` on a CPU mesh: the counterpart of
``tests/test_pipeline.py``'s schedule, forward-pipeline and loss-head
tests.

Every case runs twice: on gloo ranks (one 4-rank job; the n = 2 cases on
the 'pp' rows of ``create_mesh(pp=2, dp=2)``) and on the in-process
virtual transport (n stages in lockstep). The stage is
``tanh(x @ w + b)``, d = 4, microbatches of 2, data from numpy seeds both
sides draw alike; JAX's function runs inside ``shard_map`` on n virtual
CPU devices, each case once per module.

- The schedules: gpipe, 1f1b and zb-h1 at (n, m) in (2, 4), (4, 4),
  (4, 8); 1f1b at (4, 3); interleaved at (n, m, V) in (2, 4, 2),
  (4, 8, 2), (2, 8, 3); the loss heads (``loss_params``, ``loss_aux``,
  ``return_input_grads``) on gpipe, 1f1b and zb-h1 at (4, 8). The loss
  within 1e-5 of |JAX's|, every stage gradient (and extra) within 1e-5
  of its max |value|, as ``tests/test_pipeline.py`` holds JAX to its
  oracle.
- ``pipeline_apply``: relay and psum within 1e-6 of JAX's; relay bit for
  bit psum.
- The static accounting: ``schedule_info`` of every schedule (and an
  unknown one) at n in {1, 2, 4}, m in 0..16 and num_virtual in 0..3
  equal to JAX's field by field, or the same ``ValueError`` text: every
  validation error.
- On ``create_mesh(dp=4)``: ``collectives.ring_shift`` and
  ``data_parallel.shard_batch`` bit for bit JAX's ``ring_shift`` and
  ``shard_batch``; ``allreduce_gradients`` (sum and mean) within 1e-6
  of max |JAX's ``allreduce_gradients_in_jit``| (gloo's ring sums in
  another order than XLA).
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
D, MB = 4, 2
TOL = 1e-5
# name: (schedule, n, m, V, heads)
CASES = {}
for _s in ("gpipe", "1f1b", "zb-h1"):
    for _n, _m in ((2, 4), (4, 4), (4, 8)):
        CASES[f"{_s}-n{_n}-m{_m}"] = (_s, _n, _m, 1, False)
    CASES[f"{_s}-heads"] = (_s, 4, 8, 1, True)
CASES["1f1b-n4-m3"] = ("1f1b", 4, 3, 1, False)
for _n, _m, _v in ((2, 4, 2), (4, 8, 2), (2, 8, 3)):
    CASES[f"interleaved-n{_n}-m{_m}-v{_v}"] = ("interleaved", _n, _m, _v,
                                              False)
APPLY_N, APPLY_M = 4, 6
SHIFTS = (1, 2, -1)


# ------------------------------------------------------------------ data

def _data(n_total, m, seed=0):
    """(stages, x, loss params, targets), numpy fp32."""
    rng = np.random.RandomState(seed)
    stages = [{"w": (rng.randn(D, D) * 0.5).astype(np.float32),
               "b": (rng.randn(D) * 0.1).astype(np.float32)}
              for _ in range(n_total)]
    rng = np.random.RandomState(100 + seed)
    x = rng.randn(m, MB, D).astype(np.float32)
    tgt = rng.randn(m, MB, D).astype(np.float32)
    lp = {"w": (rng.randn(D, D) * 0.3).astype(np.float32)}
    return stages, x, lp, tgt


def _rank_params(stages, n, V, r):
    """Rank r's stage (V = 1) or its V chunks stacked (chunk-stage
    v·n + r in slot v)."""
    if V == 1:
        return stages[r]
    return {k: np.stack([stages[v * n + r][k] for v in range(V)])
            for k in ("w", "b")}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------- torch side

def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _loss_fn(y):
    return (y.float() ** 2).mean()


def _head_loss(lp, y, tgt):
    return ((y @ lp["w"] - tgt) ** 2).mean()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _torch_case(run, name, n, r):
    """One case on rank r through ``run(stage_fn, loss_fn, params, x,
    **kw)``; numpy results."""
    schedule, _, m, V, heads = CASES[name]
    stages, x, lp, tgt = _data(n * V, m)
    kw = dict(schedule=schedule, num_virtual=V)
    if heads:
        kw.update(loss_aux=torch.from_numpy(tgt), loss_params=_t(lp),
                  return_input_grads=True)
    out = run(_stage_fn, _head_loss if heads else _loss_fn,
              _t(_rank_params(stages, n, V, r)), torch.from_numpy(x), **kw)
    res = {"loss": float(out[0]), "grads": _np(out[1])}
    if heads:
        res["lp_grads"] = _np(out[2]["loss_params_grads"])
        res["x_grads"] = _np(out[2]["input_grads"])
    return res


def _virtual_case(name):
    from horovod_tpu_torch.parallel import pipeline as tpl
    schedule, n, m, V, heads = CASES[name]
    stages, x, lp, tgt = _data(n * V, m)
    kw = dict(schedule=schedule, num_virtual=V)
    if heads:
        kw.update(loss_aux=torch.from_numpy(tgt), loss_params=_t(lp),
                  return_input_grads=True)
    outs = tpl._virtual_value_and_grad(
        n, _stage_fn, _head_loss if heads else _loss_fn,
        [_t(_rank_params(stages, n, V, r)) for r in range(n)],
        torch.from_numpy(x), **kw)
    ranks = []
    for out in outs:
        res = {"loss": float(out[0]), "grads": _np(out[1])}
        if heads:
            res["lp_grads"] = _np(out[2]["loss_params_grads"])
            res["x_grads"] = _np(out[2]["input_grads"])
        ranks.append(res)
    return ranks


def _apply_inputs():
    stages, x, _, _ = _data(APPLY_N, APPLY_M, seed=3)
    return stages, x


def _rank_value(name, r):
    return np.random.RandomState(1000 + 17 * r + len(name)).randn(
        3, 5).astype(np.float32)


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (allreduce_gradients,
                                            create_mesh, pipeline_apply,
                                            pipeline_value_and_grad,
                                            ring_shift, shard_batch)
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    meshes = {4: create_mesh(pp=4)["pp"],
              2: create_mesh(pp=2, dp=2)["pp"]}
    out = {"coords": {n: m.get_local_rank("pp") for n, m in meshes.items()}}
    for name, (_, n, *_) in CASES.items():
        mesh = meshes[n]

        def run(*args, **kw):
            return pipeline_value_and_grad(*args, mesh, **kw)
        out[name] = _torch_case(run, name, n, out["coords"][n])
    stages, x = _apply_inputs()
    for mode in ("relay", "psum"):
        out[f"apply-{mode}"] = pipeline_apply(
            _stage_fn, _t(stages[rank]), torch.from_numpy(x), meshes[4],
            replicate_output=mode).numpy()
    dp = create_mesh(dp=4)
    for k in SHIFTS:
        out[f"shift{k}"] = ring_shift(
            torch.from_numpy(_rank_value("shift", rank)), dp, "dp",
            offset=k).numpy()
    out["shard_batch"] = shard_batch(
        {"x": torch.arange(48.).reshape(8, 6)}, dp)["x"].numpy()
    g = {"g": torch.from_numpy(_rank_value("grad", rank))}
    out["allreduce_mean"] = allreduce_gradients(g, dp)["g"].numpy()
    out["allreduce_sum"] = allreduce_gradients(g, dp, average=False)[
        "g"].numpy()
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    ctx = mp.spawn(_worker, args=(_free_port(), str(d)), nprocs=WORLD,
                   join=False)
    return ctx, d


@pytest.fixture(scope="module")
def jax_results(job):
    """Every case of JAX's pipeline once (while the gloo job runs)."""
    out = {name: _jax_case(name) for name in CASES}
    out.update({f"apply-{mode}": _jax_apply(mode)
                for mode in ("relay", "psum")})
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


# ------------------------------------------------------------ JAX side

def _jax_stage(p, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_loss(y):
    import jax.numpy as jnp
    return jnp.mean(y.astype(jnp.float32) ** 2)


def _jax_head(lp, y, tgt):
    import jax.numpy as jnp
    return jnp.mean((y @ lp["w"] - tgt) ** 2)


def _jax_case(name):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.pipeline import pipeline_value_and_grad
    schedule, n, m, V, heads = CASES[name]
    stages, x, lp, tgt = _data(n * V, m)
    packed = {k: np.stack([_rank_params(stages, n, V, r)[k]
                           for r in range(n)]) for k in ("w", "b")}
    mesh = create_mesh(devices=jax.devices()[:n], pp=n)

    def run(p_local, lp, x, tgt):
        p = jax.tree_util.tree_map(lambda l: l[0], p_local)
        if not heads:
            loss, g = pipeline_value_and_grad(
                _jax_stage, _jax_loss, p, x, axis_name="pp",
                schedule=schedule, num_virtual=V)
            return loss, jax.tree_util.tree_map(lambda l: l[None], g)
        loss, g, extras = pipeline_value_and_grad(
            _jax_stage, _jax_head, p, x, axis_name="pp", schedule=schedule,
            loss_aux=tgt, loss_params=lp, return_input_grads=True)
        return (loss, jax.tree_util.tree_map(lambda l: l[None], g),
                extras["loss_params_grads"], extras["input_grads"])

    out_specs = (P(), P("pp")) + ((P(), P()) if heads else ())
    f = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=({"w": P("pp"), "b": P("pp")}, P(), P(),
                                  P()),
        out_specs=out_specs, check_vma=False))
    res = jax.device_get(f(packed, lp, x, tgt))
    out = {"loss": float(res[0]), "grads": res[1]}
    if heads:
        out["lp_grads"], out["x_grads"] = res[2], res[3]
    return out


def _jax_apply(mode):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.pipeline import pipeline_apply
    stages, x = _apply_inputs()
    packed = {k: np.stack([s[k] for s in stages]) for k in ("w", "b")}
    mesh = create_mesh(devices=jax.devices()[:APPLY_N], pp=APPLY_N)

    def run(p_local, x):
        p = jax.tree_util.tree_map(lambda l: l[0], p_local)
        return pipeline_apply(_jax_stage, p, x, axis_name="pp",
                              replicate_output=mode)

    f = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=({"w": P("pp"), "b": P("pp")}, P()),
        out_specs=P(), check_vma=False))
    return np.asarray(f(packed, x))


# --------------------------------------------------------------- checks

def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def _check_rank(got, want, name, r):
    """Rank r's results against JAX's (its block of the 'pp' grads)."""
    _, _, _, V, heads = CASES[name]
    assert abs(got["loss"] - want["loss"]) <= TOL * max(abs(want["loss"]),
                                                        1e-9), name
    for k in ("w", "b"):
        err = _rel(got["grads"][k], np.asarray(want["grads"][k])[r])
        assert err < TOL, f"{name} rank {r} grad {k}: {err}"
    if heads:
        assert _rel(got["lp_grads"]["w"],
                    np.asarray(want["lp_grads"]["w"])) < TOL, name
        assert _rel(got["x_grads"], np.asarray(want["x_grads"])) < TOL, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_gloo_ranks_match_jax(ranks, jax_results, name):
    n = CASES[name][1]
    seen = set()
    for out in ranks:
        r = out["coords"][n]
        seen.add(r)
        _check_rank(out[name], jax_results[name], name, r)
    assert seen == set(range(n))


@pytest.mark.parametrize("name", sorted(CASES))
def test_virtual_stages_match_jax(jax_results, name):
    for r, got in enumerate(_virtual_case(name)):
        _check_rank(got, jax_results[name], name, r)


@pytest.mark.parametrize("transport", ["gloo", "virtual"])
def test_pipeline_apply_matches_jax(ranks, jax_results, transport):
    from horovod_tpu_torch.parallel import pipeline as tpl
    stages, x = _apply_inputs()
    if transport == "gloo":
        outs = {mode: [out[f"apply-{mode}"] for out in ranks]
                for mode in ("relay", "psum")}
    else:
        outs = {mode: [o.numpy() for o in tpl._virtual_apply(
                    APPLY_N, _stage_fn, [_t(s) for s in stages],
                    torch.from_numpy(x), mode)]
                for mode in ("relay", "psum")}
    for mode, per_rank in outs.items():
        want = jax_results[f"apply-{mode}"]
        for got in per_rank:
            assert float(np.abs(got - want).max()) < 1e-6, mode
    # Both replications move the same last-stage values: psum adds exact
    # zeros, relay copies.
    for a, b in zip(outs["relay"], outs["psum"]):
        assert np.array_equal(a, b)


def test_bad_replicate_output_rejected():
    from horovod_tpu_torch.parallel import pipeline as tpl
    with pytest.raises(ValueError, match="relay"):
        tpl._virtual_apply(2, _stage_fn, [None, None], torch.ones(2, 2, 2),
                           "bcast")


def test_unknown_schedule_rejected():
    from horovod_tpu_torch.parallel import pipeline as tpl
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tpl._virtual_value_and_grad(2, _stage_fn, _loss_fn, [{}, {}],
                                    torch.ones(2, 2, 2),
                                    schedule="dualpipe")


def test_schedules_agree_with_each_other():
    """gpipe, 1f1b and zb-h1 are the same sums on different ticks (n = 4,
    m = 8, seed 5), as tests/test_pipeline.py holds JAX's."""
    from horovod_tpu_torch.parallel import pipeline as tpl
    stages, x, _, _ = _data(4, 8, seed=5)
    runs = {s: tpl._virtual_value_and_grad(
                4, _stage_fn, _loss_fn, [_t(p) for p in stages],
                torch.from_numpy(x), schedule=s)
            for s in ("gpipe", "1f1b", "zb-h1")}
    for s in ("1f1b", "zb-h1"):
        for a, b in zip(runs["gpipe"], runs[s]):
            assert abs(float(a[0]) - float(b[0])) < 1e-6, s
            for k in ("w", "b"):
                assert float((a[1][k] - b[1][k]).abs().max()) < 1e-6, s


def _info(mod, schedule, n, m, v):
    try:
        s = mod.schedule_info(schedule, n, m, num_virtual=v)
    except ValueError as e:
        return ("error", str(e))
    return (s.name, s.num_stages, s.num_microbatches, s.num_virtual,
            s.cost_fwd, s.cost_bwd, s.ticks, s.total_cost, s.useful_cost,
            s.bubble_share)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved",
                                      "zb-h1", "dualpipe"])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_schedule_info_matches_jax(schedule, v, n):
    """Every field, or the ValueError's text, at m = 0..16."""
    from horovod_tpu.parallel import pipeline as jpl
    from horovod_tpu_torch.parallel import pipeline as tpl
    assert tpl.SCHEDULES == jpl.SCHEDULES
    for m in range(17):
        assert _info(tpl, schedule, n, m, v) == _info(jpl, schedule, n, m,
                                                      v), m


@pytest.mark.parametrize("offset", SHIFTS)
def test_ring_shift_matches_jax(ranks, offset):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.collectives import ring_shift
    mesh = create_mesh(devices=jax.devices()[:WORLD], dp=WORLD)
    glob = np.concatenate([_rank_value("shift", r) for r in range(WORLD)])
    f = jax.jit(jax.shard_map(
        lambda x: ring_shift(x, "dp", offset=offset), mesh=mesh,
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    want = np.asarray(f(jnp.asarray(glob))).reshape(WORLD, 3, 5)
    for r, out in enumerate(ranks):
        assert np.array_equal(out[f"shift{offset}"], want[r])


def test_data_parallel_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.data_parallel import (
        allreduce_gradients_in_jit, shard_batch)
    mesh = create_mesh(devices=jax.devices()[:WORLD], dp=WORLD)
    placed = shard_batch({"x": jnp.arange(48.).reshape(8, 6)}, mesh)["x"]
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    glob = np.concatenate([_rank_value("grad", r) for r in range(WORLD)])
    want = {}
    for average in (True, False):
        f = jax.jit(jax.shard_map(
            lambda g, a=average: allreduce_gradients_in_jit(g, "dp", a),
            mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
            check_vma=False))
        want[average] = np.asarray(f(jnp.asarray(glob))).reshape(WORLD, 3,
                                                                 5)
    for r, out in enumerate(ranks):
        assert np.array_equal(out["shard_batch"],
                              by_device[mesh.devices[r]])
        # gloo's ring adds each chunk from another rank on: fp32 sums in
        # another order than XLA's.
        assert _rel(out["allreduce_mean"], want[True][r]) < 1e-6
        assert _rel(out["allreduce_sum"], want[False][r]) < 1e-6
