"""The port's hierarchical cross-node reduction against the JAX
package's ``horovod_tpu/parallel/collectives.py`` and the mesh train
step's ``dcn_axis`` against JAX's ``build_train_step(dcn_axis=...)``:
the counterpart of ``tests/test_pipeline.py::TestTrainStepHierarchical``.

One 4-rank gloo job on ``create_mesh(dcn=2, dp=2)``:

- ``hierarchical_psum`` of tensors of several shapes (ragged ones that
  pad to the ici size): against the flat psum over both axes within
  1e-5 of max |flat|, against JAX's ``hierarchical_psum`` (the same
  mesh of 4 virtual CPU devices) within 1e-5 of max |flat| too;
  ``wire="int8x256"`` within 1e-2 of max |flat| of the flat sum and bit
  for bit JAX's ``hierarchical_psum(wire=...)``; ``average`` within 1e-5
  of the flat mean; ``hierarchical_psum_tree`` bit for bit one call per
  tensor, exact and quantized. ``quantized_psum`` over the dcn axis bit
  for bit JAX's.
- One SGD(0.1) step of the LM (vocab 64, d_model 32, 4 heads, 2 layers,
  d_ff 64, seq 32, batch 8, fp32) with ``dcn_axis="dcn"``:
  hierarchical against flat (``dcn_hierarchical=False``): loss 1e-5,
  parameters 1e-5; against JAX's hierarchical step: loss 1e-5,
  parameters 1e-4 (TestTrainStepHierarchical's tolerance against the
  one-device step); ``dcn_axis="auto"`` under
  ``HOROVOD_TPU_DCN_AXES=dcn`` bit for bit the explicit axis; and the
  step with ``dcn_wire="int8x256"`` against JAX's with the same wire:
  loss 1e-5, and at most 0.1% of the parameters off by more than 1e-5,
  none by 1e-3 (one int8 level of a block times the learning rate,
  where a gradient summed in another order rounds the other way).

In this process: ``cross_slice_bytes`` against JAX's over a grid of
sizes and wires, a bad ``dcn_axis``, and ZeRO-1 with ``dcn_axis``.
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
WORLD = 4
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=32, remat=False)
LR = 0.1
SHAPES = {"vector": (1000,), "ragged": (37, 3), "matrix": (64, 96),
          "one": (1,)}
WIRE = "int8x256"
STEPS = {"hier": dict(dcn_axis="dcn"),
         "flat": dict(dcn_axis="dcn", dcn_hierarchical=False),
         "auto": dict(dcn_axis="auto"),
         "hier_int8": dict(dcn_axis="dcn", dcn_wire=WIRE)}


def _data(name, rank):
    rng = np.random.RandomState(zlib.crc32(f"{name}/{rank}".encode()))
    return rng.standard_normal(SHAPES[name]).astype(np.float32)


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


def _worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.collectives import (
        hierarchical_psum, hierarchical_psum_tree, psum)
    from horovod_tpu_torch.parallel.mesh import create_mesh, place
    from horovod_tpu_torch.parallel.train import build_train_step
    from horovod_tpu_torch.quantization import quantized_psum
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    mesh = create_mesh(dcn=2, dp=2)
    xs = {n: torch.from_numpy(_data(n, rank)) for n in SHAPES}
    out = {"place": place(mesh), "psum": {}}
    for n, x in xs.items():
        out["psum"][n] = {
            "flat": psum(x, mesh, ("dp", "dcn")),
            "hier": hierarchical_psum(x, mesh, "dp", "dcn"),
            "wire": hierarchical_psum(x, mesh, "dp", "dcn", wire=WIRE),
            "average": hierarchical_psum(x, mesh, "dp", "dcn",
                                         average=True),
            "quantized": quantized_psum(x, mesh, "dcn", WIRE)}
    names = sorted(SHAPES)
    out["tree"] = dict(zip(names, hierarchical_psum_tree(
        [xs[n] for n in names], mesh, "dp", "dcn")))
    out["tree_wire"] = dict(zip(names, hierarchical_psum_tree(
        [xs[n] for n in names], mesh, "dp", "dcn", wire=WIRE)))

    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    tree = _torch_tree(tree.item())
    tok, tgt = _batch()
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    for name, kw in STEPS.items():
        if name == "auto":
            os.environ["HOROVOD_TPU_DCN_AXES"] = "dcn"
        step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=LR),
                                mesh=mesh, device="cpu", **kw)
        os.environ.pop("HOROVOD_TPU_DCN_AXES", None)
        model = step.make_model(params=step.shard_params(tree))
        opt = step.make_optimizer(model)
        loss = step(model, opt, step.shard_batch(torch.from_numpy(tok)),
                    step.shard_batch(torch.from_numpy(tgt)))
        out[name] = (float(loss), step.dcn_axis, step.data_spec,
                     {k: v.detach().clone()
                      for k, v in model.state_dict().items()})
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _jax_cfg():
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    return jtfm.TransformerConfig(dtype=jnp.float32, **CFG)


def _jax_mesh():
    import jax
    from horovod_tpu.parallel import create_mesh
    return create_mesh(devices=jax.devices()[:WORLD], dcn=2, dp=2)


@pytest.fixture(scope="module")
def tree():
    import jax
    from horovod_tpu.models import transformer as jtfm
    return jax.device_get(jtfm.init_params(_jax_cfg(),
                                           jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("hierarchical")
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


def _jax_per_rank(fn, name):
    """``fn(x)`` inside shard_map over (dcn=2, dp=2), rank r's x its
    ``_data(name, r)``; rank r's result."""
    import jax
    from jax.sharding import PartitionSpec as P
    xs = np.stack([_data(name, r) for r in range(WORLD)])
    f = jax.jit(jax.shard_map(lambda x: fn(x[0])[None], mesh=_jax_mesh(),
                              in_specs=P(("dcn", "dp")),
                              out_specs=P(("dcn", "dp")), check_vma=False))
    return np.asarray(f(xs))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_hierarchical_psum_matches_flat_and_jax(ranks, name):
    from horovod_tpu.parallel.collectives import hierarchical_psum as jhier
    from horovod_tpu.quantization import quantized_psum as jqpsum
    flat = sum(_data(name, r) for r in range(WORLD))
    mag = np.abs(flat).max()
    want_hier = _jax_per_rank(lambda x: jhier(x, "dp", "dcn"), name)
    want_wire = _jax_per_rank(lambda x: jhier(x, "dp", "dcn", wire=WIRE),
                              name)
    want_q = _jax_per_rank(lambda x: jqpsum(x, "dcn", WIRE), name)
    for r, out in enumerate(ranks):
        got = {k: v.numpy() for k, v in out["psum"][name].items()}
        assert got["hier"].shape == flat.shape
        assert np.abs(got["flat"] - flat).max() <= 1e-5 * mag
        assert np.abs(got["hier"] - got["flat"]).max() <= 1e-5 * mag
        assert np.abs(got["hier"] - want_hier[r]).max() <= 1e-5 * mag
        assert np.abs(got["average"] - flat / WORLD).max() <= 1e-5 * mag
        assert np.abs(got["wire"] - flat).max() <= 1e-2 * mag
        np.testing.assert_array_equal(got["wire"], want_wire[r])
        np.testing.assert_array_equal(got["quantized"], want_q[r])


def test_tree_is_one_call_per_tensor(ranks):
    for out in ranks:
        for name in SHAPES:
            assert torch.equal(out["tree"][name], out["psum"][name]["hier"])
            assert torch.equal(out["tree_wire"][name],
                               out["psum"][name]["wire"])


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096, 111_000_001])
@pytest.mark.parametrize("ici", [1, 2, 4, 8])
def test_cross_slice_bytes_matches_jax(n, ici):
    from horovod_tpu.parallel.collectives import cross_slice_bytes as jbytes
    from horovod_tpu_torch.parallel.collectives import cross_slice_bytes
    for kw in ({}, {"hierarchical": False}, {"wire": "int8x256"},
               {"wire": "fp8x128"}, {"dtype_bytes": 2}):
        assert cross_slice_bytes(n, ici, **kw) == jbytes(n, ici, **kw), kw


def _jax_step(tree, **kw):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.parallel.train import build_train_step
    opt = optax.sgd(LR)
    make, shard_p, shard_b = build_train_step(_jax_cfg(), _jax_mesh(), opt,
                                              **kw)
    state = opt.init(tree)
    step, _ = make(tree, state)
    tok, tgt = _batch()
    params, _, loss = step(shard_p(tree), state, shard_b(jnp.asarray(tok)),
                           shard_b(jnp.asarray(tgt)))
    return jax.device_get(params), float(loss)


def _max_err(got, want):
    return max(float((got[k] - want[k]).abs().max()) for k in want)


@pytest.mark.parametrize("variant", ["hier", "hier_int8"])
def test_dcn_step_matches_jax(ranks, tree, variant):
    from horovod_tpu_torch import interop
    params, want_loss = _jax_step(tree, **STEPS[variant])
    want = interop.params_from_jax(params)
    for out in ranks:
        loss, axis, spec, got = out[variant]
        assert axis == "dcn" and spec == (("dcn", "dp"), None)
        assert abs(loss - want_loss) < 1e-5
        assert got.keys() == want.keys()
        if variant == "hier":
            assert _max_err(got, want) < 1e-4
            continue
        # The wire's functions are JAX's bit for bit (above), but the
        # gradients reach it summed in another order, and an element
        # that sits on a rounding boundary then moves by one int8 level
        # of its block (absmax / 127, times the learning rate): few
        # elements, each by at most a level.
        n = sum(v.numel() for v in want.values())
        off = sum(int(((got[k] - want[k]).abs() > 1e-5).sum()) for k in want)
        assert off <= n // 1000 and _max_err(got, want) < 1e-3, (off, n)


def test_hierarchical_step_matches_flat(ranks):
    for out in ranks:
        loss_h, _, _, hier = out["hier"]
        loss_f, _, _, flat = out["flat"]
        assert abs(loss_h - loss_f) < 1e-5
        assert _max_err(hier, flat) < 1e-5


def test_auto_is_the_explicit_axis_bit_for_bit(ranks):
    for out in ranks:
        loss_a, axis, _, auto = out["auto"]
        loss_e, _, _, expl = out["hier"]
        assert axis == "dcn" and loss_a == loss_e
        assert all(torch.equal(auto[k], expl[k]) for k in expl)


def test_dcn_axis_refusals():
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    thvd.init(device="cpu")
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
    mesh = create_mesh(dcn=1, dp=1)
    with pytest.raises(ValueError, match="not a mesh axis"):
        build_train_step(cfg, torch.optim.SGD, device="cpu", mesh=mesh,
                         dcn_axis="nope")
    with pytest.raises(ValueError, match="'dp' axis"):
        build_train_step(cfg, torch.optim.SGD, device="cpu",
                         mesh=create_mesh(dcn=1, tp=1), dcn_axis="dcn")
    with pytest.raises(ValueError, match="needs mesh"):
        build_train_step(cfg, torch.optim.SGD, device="cpu",
                         dcn_axis="dcn")
    # No axis crosses a node and none is forced: "auto" finds none.
    os.environ.pop("HOROVOD_TPU_DCN_AXES", None)
    assert build_train_step(cfg, torch.optim.SGD, device="cpu", mesh=mesh,
                            dcn_axis="auto").dcn_axis is None
    step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=LR),
                            device="cpu", mesh=mesh, dcn_axis="dcn")
    model = step.make_model()
    with pytest.raises(ValueError, match="ZeRO-1"):
        step.make_optimizer(model, zero1=True)
