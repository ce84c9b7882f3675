"""The transformer's remainder against the JAX package: ``param_specs``,
``remat_policy="dots"``, ``flash_block``, the mesh options' errors, and
the data-parallel step at two ranks.

- ``param_specs`` equals JAX's leaf by leaf (each ``PartitionSpec`` as a
  tuple), with and without a 'tp' axis.
- ``remat_policy="dots"`` against ``remat=False``: loss within 5e-6 and
  gradients within 1e-5, as JAX's ``test_chunked_loss_matches_monolithic``
  holds its own; its backward recomputes no ``x @ W`` matmul, where
  ``"full"`` recomputes them all.
- ``flash_block`` is accepted and changes nothing, bit for bit.
- The mesh step on a mesh of one rank (``dp=tp=sp=1``), bf16 on the
  flash path, takes the dp step's first-step loss and gradients bit for
  bit, through the ring (the fp32-output forms' plain versions, merged
  at n = 1) and through Ulysses: what ``chip_smoke.py`` phase 12 holds
  on the card.
- One 2-rank gloo job runs three SGD steps of the default dp step
  (``DistributedOptimizer`` through the collective engine), each rank
  on its half of the batch, against JAX's ``build_train_step`` on a
  2-device mesh: per-step loss rtol 1e-5, parameters 1e-4 (fp32; sums
  in other orders).
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as thvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as ttfm

JOB_TIMEOUT_S = 180
CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq=32)
LR = 0.05
STEPS = 3


def _tree(seed=0, **over):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, **{**CFG, **over})
    return jax.device_get(jtfm.init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(seed=1, b=4, s=32):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, CFG["vocab"], size=(b, s)).astype(np.int64)
    return tok, np.roll(tok, -1, axis=1)


@pytest.mark.parametrize("tp_axis", [None, "tp"])
def test_param_specs_match_jax(tp_axis):
    from horovod_tpu.models import transformer as jtfm
    kw = dict(CFG, n_layers=3)
    want = jtfm.param_specs(jtfm.TransformerConfig(tp_axis=tp_axis, **kw))
    got = ttfm.param_specs(ttfm.TransformerConfig(tp_axis=tp_axis, **kw))
    assert got.keys() == want.keys()
    for name in ("embed", "pos", "ln_f"):
        assert got[name] == tuple(want[name])
    assert len(got["layers"]) == len(want["layers"]) == 3
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        assert {k: tuple(v) for k, v in w.items()} == g


def _loss_and_grads(tree, tok, tgt, **over):
    thvd.init(device="cpu")
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **{**CFG, **over})
    model = ttfm.Transformer(cfg, device="cpu")
    model.load_state_dict(interop.params_from_jax(tree))
    loss = model.loss_fn(torch.from_numpy(tok), torch.from_numpy(tgt))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def test_dots_remat_matches_no_remat():
    tree = _tree()
    tok, tgt = _batch()
    l0, g0 = _loss_and_grads(tree, tok, tgt, remat=False)
    ld, gd = _loss_and_grads(tree, tok, tgt, remat=True,
                             remat_policy="dots")
    assert abs(l0 - ld) < 5e-6
    err = max(float((g0[n] - gd[n]).abs().max()) for n in g0)
    assert err < 1e-5, f"dots-policy grad divergence {err}"


class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_dots_remat_saves_the_matmuls(policy):
    """Backward takes 2 matmuls per ``x @ W`` product (6 per block, 2
    in the head). Before that, ``full`` recomputes each block's forward
    as far as the last tensor backward needs: 5 of its 6 products (the
    out-projection of the MLP saves its inputs, not its output);
    ``dots`` recomputes none."""
    thvd.init(device="cpu")
    cfg = ttfm.TransformerConfig(dtype=torch.float32, remat=True,
                                 remat_policy=policy, **CFG)
    model = ttfm.Transformer(cfg, device="cpu")
    tok, tgt = _batch()
    loss = model.loss_fn(torch.from_numpy(tok), torch.from_numpy(tgt))
    counter = _CountMatmuls()
    with counter:
        loss.backward()
    per_block = 12 + (5 if policy == "full" else 0)
    assert counter.n == CFG["n_layers"] * per_block + 2


def test_flash_block_changes_nothing():
    tree = _tree()
    tok, tgt = _batch()
    want = _loss_and_grads(tree, tok, tgt, use_flash=True)
    got = _loss_and_grads(tree, tok, tgt, use_flash=True, flash_block=64)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1])


def test_mesh_options_need_a_mesh_with_their_axes():
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import (MeshTrainStep, TrainStep,
                                                  build_train_step)
    thvd.init(device="cpu")
    cfg = ttfm.TransformerConfig(tp_axis="tp", sp_axis="sp", **CFG)
    with pytest.raises(ValueError, match="mesh"):
        ttfm.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        build_train_step(cfg, torch.optim.SGD, device="cpu")
    dp_only = create_mesh(dp=1)
    with pytest.raises(ValueError, match="not a mesh axis"):
        build_train_step(cfg, torch.optim.SGD, device="cpu", mesh=dp_only)
    plain = ttfm.TransformerConfig(**CFG)
    assert isinstance(build_train_step(plain, torch.optim.SGD,
                                       device="cpu"), TrainStep)
    mesh = create_mesh(dp=1, tp=1, sp=1)
    assert isinstance(build_train_step(cfg, torch.optim.SGD, device="cpu",
                                       mesh=mesh), MeshTrainStep)
    # JAX's error when the heads do not split over 'tp' (2 heads, tp 4).
    with pytest.raises(ValueError, match="tensor-parallel axis size"):
        ttfm._local_heads(cfg, 4)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_mesh_step_of_one_rank_is_the_dp_step_bit_for_bit(sp_impl):
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    thvd.init(device="cpu")
    kw = dict(CFG, dtype=torch.bfloat16, use_flash=True, remat=False)
    tok, tgt = (torch.from_numpy(x) for x in _batch())
    ref = ttfm.Transformer(ttfm.TransformerConfig(**kw), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    ref_loss = ref.loss_fn(tok, tgt)
    ref_loss.backward()
    cfg = ttfm.TransformerConfig(tp_axis="tp", sp_axis="sp",
                                 sp_impl=sp_impl, **kw)
    step = build_train_step(cfg, lambda p: torch.optim.AdamW(p, lr=1e-4),
                            device="cpu", mesh=create_mesh(dp=1, tp=1, sp=1))
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    loss = step(model, step.make_optimizer(model), tok, tgt)
    assert float(loss) == float(ref_loss)
    for (name, p), (ref_name, r) in zip(model.named_parameters(),
                                        ref.named_parameters()):
        assert name == ref_name
        assert torch.equal(p.grad, r.grad), name


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_worker(rank, port, outdir):
    from horovod_tpu_torch.parallel.train import build_train_step
    torch.set_num_threads(1)
    thvd.init(device="cpu", init_method=f"tcp://localhost:{port}",
              rank=rank, world_size=2)
    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    cfg = ttfm.TransformerConfig(dtype=torch.float32, remat=False, **CFG)
    step = build_train_step(cfg, lambda p: torch.optim.SGD(p, lr=LR),
                            device="cpu")
    model = step.make_model()
    model.load_state_dict(interop.params_from_jax(tree.item()))
    opt = step.make_optimizer(model)
    tok, tgt = _batch()
    half = slice(2 * rank, 2 * rank + 2)
    losses = [float(step(model, opt, torch.from_numpy(tok[half]),
                         torch.from_numpy(tgt[half])))
              for _ in range(STEPS)]
    out = (losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()})
    thvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def test_two_rank_dp_step_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import create_mesh
    from horovod_tpu.parallel.train import build_train_step
    tree = _tree(seed=3)
    np.save(tmp_path / "tree.npy", tree, allow_pickle=True)
    ctx = mp.spawn(_dp_worker, args=(_free_port(), str(tmp_path)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, remat=False, **CFG)
    opt = optax.sgd(LR)
    make, shard_p, shard_b = build_train_step(
        jcfg, create_mesh(devices=jax.devices()[:2], dp=2), opt)
    state = opt.init(tree)
    step, _ = make(tree, state)
    params = shard_p(tree)
    tok, tgt = _batch()
    want_losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, shard_b(jnp.asarray(tok)),
                                   shard_b(jnp.asarray(tgt)))
        want_losses.append(float(loss))
    want = interop.params_from_jax(jax.device_get(params))
    for losses, got in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for key in want:
            err = float((got[key] - want[key]).abs().max())
            assert err < 1e-4, f"{key}: {err}"
