"""The port's checkpoint engine and elastic state across 4 gloo ranks.

One spawned 4-rank job (the LM at vocab 64, d_model 34, 2 heads, 2
layers, d_ff 64, seq 16, fp32: d_model 34 makes the ZeRO-1 padding
real, the norms' 34 elements padded to 36 over dp = 4 and not at all
over dp = 2) writes every rank's results to a file; the tests read
them:

- ZeRO-1 over ``dp=4`` (``test_zero1_optimizer_state_roundtrip`` and
  ``test_ws4_to_ws2_ws1_and_reverse`` of ``test_checkpoint_engine.py``):
  2 AdamW steps, an ``ElasticState`` commit on the sharded backend, a
  third step; a fresh model and optimizer (another seed, no optimizer
  state yet) restored in place at dp = 4 replay the third step bit for
  bit (loss, parameters, moments); every sharded leaf reassembled
  through ``restore_addressable`` at process counts 2 and 1 equals the
  ranks' own blocks bit for bit, in its saved padded shape; a ZeRO-1
  optimizer over dp = 2 refuses the dp = 4 state.
- A ``tp=2, dp=2`` model: each tp block written once, restored in place
  into a fresh model, and the templateless restore the global tree.
- The barrier from the writer thread: 5 data-parallel steps whose
  gradients go through the engine in several hook-fired buckets, with
  an async commit after each; the writer's two named barriers run
  while the next step's buckets are in flight. No deadlock (the job's
  time limit), no reordering (losses and parameters bit for bit those
  of the same steps without commits), every commit restores to the
  parameters it was taken of.
- ``save_checkpoint``/``restore_checkpoint`` (``tests/test_checkpoint.
  py``'s multi-process case): rank 0 writes, every rank restores the
  same state, and a rank-0 load error raises on every rank; the pickle
  ``ElasticState`` broadcasts rank 0's initial trees and its commits.
- ``TestMultiProcessSharded``: a leaf split over 'dp' by
  ``spec_layout``, each rank writing its block; every rank restores
  the whole.
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
CFG = dict(vocab=64, d_model=34, n_heads=2, n_layers=2, d_ff=64, max_seq=16,
           remat=False, use_flash=False)
TRAFFIC_STEPS = 5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _factory(p):
    return torch.optim.AdamW(p, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _batch(rows=8, seed=1):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, CFG["vocab"], size=(rows, CFG["max_seq"] + 1))
    tok = torch.from_numpy(tok.astype(np.int64))
    return tok[:, :-1], tok[:, 1:]


def _clone(sd):
    from horovod_tpu_torch.checkpoint import tree_keys
    return {k: v.clone() for k, v in tree_keys(sd)
            if isinstance(v, torch.Tensor)}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _zero1(rank, d, out):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import CheckpointEngine, sharded_layout
    from horovod_tpu_torch.elastic import ElasticState
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    cfg = TransformerConfig(dtype=torch.float32, **CFG)
    step = build_train_step(cfg, _factory, mesh=create_mesh(dp=WORLD),
                            device="cpu")
    tok, tgt = _batch()
    batch = step.shard_batch(tok), step.shard_batch(tgt)

    def fresh(seed):
        model = step.make_model(generator=torch.Generator().manual_seed(seed))
        return model, step.make_optimizer(model, zero1=True)

    zdir = os.path.join(d, "zero1")
    model, opt = fresh(0)
    for _ in range(2):
        step(model, opt, *batch)
    ElasticState(directory=zdir, backend="sharded", model=model,
                 optimizer=opt).commit(2, block=True)
    out["zero1_blocks"] = _clone(opt.state_dict())
    out["zero1_held"] = {k: (ll.shape, ll.held) for k, ll in
                         opt.checkpoint_layouts().items()}
    loss = float(step(model, opt, *batch))
    want_p, want_o = _clone(model.state_dict()), _clone(opt.state_dict())

    model2, opt2 = fresh(1)
    assert not opt2.state
    st = ElasticState(directory=zdir, backend="sharded", model=model2,
                      optimizer=opt2)
    st.restore()
    out["zero1_restored_step"] = st.step
    out["zero1_resumed"] = (float(step(model2, opt2, *batch)) == loss,
                            _same(_clone(model2.state_dict()), want_p),
                            _same(_clone(opt2.state_dict()), want_o))
    if rank == 0:
        eng = CheckpointEngine(zdir)
        man = eng.restore_manifest()
        split = {e["key"]: e for e in man["leaves"] if len(e["shards"]) > 1}
        out["zero1_split_keys"] = sorted(split)
        out["zero1_reassembled"] = {}
        for procs in (2, 1):
            layouts = {}
            for key, e in split.items():
                n = e["shape"][0] // procs
                layouts[key] = sharded_layout(
                    e["shape"], e["dtype"],
                    [(((k * n, (k + 1) * n),), k) for k in range(procs)])
            got = {k: np.full(e["shape"], np.nan, np.float32)
                   for k, e in split.items()}
            for p in range(procs):
                for key, blocks in eng.restore_addressable(
                        layouts, process_index=p).items():
                    for shard, arr in blocks:
                        got[key][shard.slices] = arr
            out["zero1_reassembled"][procs] = got
    # A ZeRO-1 optimizer over dp = 2 refuses the state padded for 4.
    step2 = build_train_step(cfg, _factory, mesh=create_mesh(dp=2, tp=2),
                             device="cpu")
    model3 = step2.make_model(generator=torch.Generator().manual_seed(1))
    opt3 = step2.make_optimizer(model3, zero1=True)
    try:
        ElasticState(directory=zdir, backend="sharded", model=model3,
                     optimizer=opt3).restore()
        out["zero1_dp2_error"] = None
    except ValueError as e:
        out["zero1_dp2_error"] = str(e)
    hvd.allreduce(torch.zeros(1), name="zero1.done")


def _tp(rank, d, out):
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    from horovod_tpu_torch.elastic import ElasticState
    from horovod_tpu_torch.models import transformer as ttfm
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import build_train_step
    cfg = ttfm.TransformerConfig(dtype=torch.float32, tp_axis="tp", **CFG)
    step = build_train_step(cfg, _factory, mesh=create_mesh(dp=2, tp=2),
                            device="cpu")
    tdir = os.path.join(d, "tp")
    model = step.make_model(generator=torch.Generator().manual_seed(0))
    out["tp_split"] = len(model.checkpoint_layouts())
    ElasticState(directory=tdir, backend="sharded",
                 model=model).commit(1, block=True)
    model2 = step.make_model(generator=torch.Generator().manual_seed(1))
    ElasticState(directory=tdir, backend="sharded", model=model2).restore()
    out["tp_in_place"] = _same(_clone(model2.state_dict()),
                               _clone(model.state_dict()))
    if rank == 0:
        whole = CheckpointEngine(tdir).restore()["model"]
        plain = ttfm.TransformerConfig(dtype=torch.float32, **CFG)
        ref = ttfm.Transformer(plain, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        out["tp_whole"] = _same(
            _clone({k: torch.from_numpy(v) for k, v in whole.items()}),
            _clone(ref.state_dict()))


def _traffic(rank, d, out):
    from horovod_tpu_torch.checkpoint import CheckpointEngine
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.parallel.train import build_train_step
    cfg = TransformerConfig(dtype=torch.float32, **CFG)
    step = build_train_step(cfg, _factory, device="cpu")
    tok, tgt = _batch(rows=2 * WORLD, seed=2)
    mine = slice(2 * rank, 2 * rank + 2)
    os.environ["HOROVOD_TPU_TORCH_BUCKET_MB"] = "0.02"
    runs = {}
    for commit in (False, True):
        model = step.make_model(generator=torch.Generator().manual_seed(0))
        opt = step.make_optimizer(model)
        eng = CheckpointEngine(os.path.join(d, "traffic"), keep_last=0) \
            if commit else None
        losses, snaps, overlapped = [], {}, 0
        for i in range(TRAFFIC_STEPS):
            overlapped += bool(eng is not None and eng.busy)
            losses.append(float(step(model, opt, tok[mine], tgt[mine])))
            if eng is not None:
                eng.save({"model": model.state_dict(),
                          "optimizer": opt.state_dict()}, i + 1)
                snaps[i + 1] = _clone(model.state_dict())
        if eng is not None:
            eng.wait()
            out["traffic_commits"] = all(
                _same(_clone({n: torch.from_numpy(v) for n, v in
                              eng.restore(step=k)["model"].items()}),
                      snaps[k])
                for k in snaps)
            out["traffic_overlapped"] = overlapped
            out["traffic_buckets"] = len(opt._buckets)
        runs[commit] = losses, _clone(model.state_dict())
    os.environ.pop("HOROVOD_TPU_TORCH_BUCKET_MB")
    out["traffic_same_bits"] = (runs[True][0] == runs[False][0]
                                and _same(runs[True][1], runs[False][1]))


def _pickle(rank, d, out):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ElasticState
    from horovod_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    path = os.path.join(d, "mp_pickle")
    if rank == 0:
        save_checkpoint({"params": {"w": torch.arange(6.0)}, "step": 7},
                        path)
    hvd.allreduce(torch.zeros(1), name="pickle.written")
    state = restore_checkpoint(path)
    out["pickle"] = (int(state["step"]), float(state["params"]["w"].sum()))
    try:
        restore_checkpoint(os.path.join(d, "missing"))
        out["pickle_error"] = None
    except RuntimeError as e:
        out["pickle_error"] = str(e)
    edir = os.path.join(d, "es")
    es = ElasticState(directory=edir, params={"w": torch.full((3,),
                                                              float(rank))})
    es.restore()
    out["es_initial"] = es.params["w"].tolist()
    es.params = {"w": torch.full((3,), 5.0 + rank)}
    es.commit(1)
    es2 = ElasticState(directory=edir, params={"w": torch.zeros(3)})
    es2.restore()
    out["es_restored"] = (es2.step, es2.params["w"].tolist())


def _sharded_leaf(rank, d, out):
    from horovod_tpu_torch.checkpoint import CheckpointEngine, read_manifest
    from horovod_tpu_torch.parallel.mesh import create_mesh, spec_layout
    ll = spec_layout((16,), "float32", ("dp",), create_mesh(dp=WORLD))
    (a, b), = ll.held
    path = os.path.join(d, "mp_sharded")
    eng = CheckpointEngine(path)
    eng.save({"x": torch.arange(16.0)[a:b], "rep": torch.full((3,), 2.0)},
             7, layouts={"['x']": ll})
    eng.wait()
    man = read_manifest(path, 7)
    restored = eng.restore()
    out["sharded_leaf"] = {
        "latest": eng.latest_step(), "held": ll.held,
        "procs": sorted({s["process"] for e in man["leaves"]
                         for s in e["shards"]}),
        "x": restored["x"].tolist(), "rep": restored["rep"].tolist()}


def _worker(rank, port, d, outdir):
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=WORLD)
    out = {}
    for part in (_zero1, _tp, _traffic, _pickle, _sharded_leaf):
        try:
            part(rank, d, out)
        except Exception as e:   # reported per part, read by its test
            out[part.__name__] = f"error: {type(e).__name__}: {e}"
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_mp")
    ctx = mp.spawn(_worker, args=(_free_port(), str(d), str(d)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _no_error(ranks, part):
    for r, out in enumerate(ranks):
        assert part not in out, f"rank {r}: {out[part]}"


def test_zero1_resumes_in_place_bit_for_bit(ranks):
    _no_error(ranks, "_zero1")
    for out in ranks:
        assert out["zero1_restored_step"] == 2
        assert out["zero1_resumed"] == (True, True, True)


@pytest.mark.parametrize("procs", [2, 1])
def test_zero1_reassembles_at_other_process_counts(ranks, procs):
    """Every sharded leaf, at its saved padded length, equals the dp = 4
    ranks' own blocks laid side by side, bit for bit."""
    _no_error(ranks, "_zero1")
    got = ranks[0]["zero1_reassembled"][procs]
    keys = ranks[0]["zero1_split_keys"]
    held = ranks[0]["zero1_held"]
    assert len(keys) == len(held) > 0
    n_params = sum(k.startswith("['optimizer']['shadows']") for k in keys)
    assert n_params > 0 and len(keys) == 3 * n_params  # + exp_avg(_sq)
    for key in keys:
        local = key[len("['optimizer']"):]
        shape, _ = held[local]
        want = np.full(shape, np.nan, np.float32)
        for out in ranks:
            (a, b), = out["zero1_held"][local][1]
            want[a:b] = out["zero1_blocks"][local].numpy()
        np.testing.assert_array_equal(got[key], want)
        assert not np.isnan(got[key]).any()
    norm = [k for k in keys if "shadows" in k
            and held[k[len("['optimizer']"):]][0] == (36,)]
    assert norm, "the norms' 34 elements are padded to 36 over dp = 4"


def test_zero1_refuses_another_dp(ranks):
    _no_error(ranks, "_zero1")
    for out in ranks:
        err = out["zero1_dp2_error"]
        assert err is not None and "'dp' size" in err


def test_tp_blocks_restore_in_place_and_whole(ranks):
    _no_error(ranks, "_tp")
    for out in ranks:
        assert out["tp_split"] > 0 and out["tp_in_place"]
    assert ranks[0]["tp_whole"]


def test_writer_barrier_under_gradient_traffic(ranks):
    _no_error(ranks, "_traffic")
    for out in ranks:
        assert out["traffic_buckets"] > 1
        assert out["traffic_same_bits"]
        assert out["traffic_commits"]
    assert sum(out["traffic_overlapped"] for out in ranks) > 0


def test_pickle_convention_across_ranks(ranks):
    _no_error(ranks, "_pickle")
    for out in ranks:
        assert out["pickle"] == (7, 15.0)
        assert "rank 0 failed to load checkpoint" in out["pickle_error"]
        assert out["es_initial"] == [0.0, 0.0, 0.0]
        assert out["es_restored"] == (1, [5.0, 5.0, 5.0])


def test_every_rank_writes_its_block_and_restores_the_whole(ranks):
    _no_error(ranks, "_sharded_leaf")
    for r, out in enumerate(ranks):
        got = out["sharded_leaf"]
        assert got["latest"] == 7
        assert got["held"] == ((4 * r, 4 * r + 4),)
        assert got["procs"] == [0, 1, 2, 3]
        assert got["x"] == list(np.arange(16.0))
        assert got["rep"] == [2.0] * 3
