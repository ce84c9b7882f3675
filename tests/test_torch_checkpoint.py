"""The port's sharded checkpoint engine (``horovod_tpu_torch/checkpoint``)
and its rank-0 pickle helpers against the JAX package's.

- Byte identity: the same tree saved through JAX's ``CheckpointEngine``
  and through the port's (fp32, int32 and bf16 leaves, a 0-d leaf,
  nested dicts with unsorted keys, an ``OrderedDict``, a list) gives the
  same file names, shard bytes, crc32 sidecars and ``manifest.json``;
  the port restores JAX's commit bit for bit, JAX restores the port's
  exactly as it restores its own. The key strings and their order are
  ``jax.tree_util.keystr`` over ``tree_flatten_with_path``.
- ``ml_dtypes`` hidden (a subprocess whose ``sys.modules`` maps it to
  None): the port reads a JAX-written bf16 leaf into a
  ``torch.bfloat16`` tensor with its bits, and writes one whose shard
  JAX reads back with the same bits.
- The torch shim's ``checkpoint_hook`` as the oracle of the port's: the
  same manifest and shard bytes for an fp32 ``nn.Linear`` under SGD
  with momentum.
- Cross-package logits: the JAX flagship's params committed by JAX
  restore through ``interop.params_from_jax`` into the port's
  ``Transformer``, and ``interop.params_to_jax`` of the port's
  state_dict committed by the port restores into JAX's ``apply``; the
  logits agree at rtol 1e-5 / atol 1e-5 (``test_torch_transformer``'s
  fp32 tolerance).
- Ports of ``tests/test_checkpoint.py`` and
  ``tests/test_checkpoint_engine.py`` (less the JAX-only bench case): a
  multi-process layout is saved from this process by one engine per
  simulated rank, each with its own blocks and the shared layouts; the
  real multi-process cases run on 4 gloo ranks
  (``test_torch_checkpoint_mp.py``).
"""

import collections
import glob
import json
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

from horovod_tpu_torch.checkpoint import (CheckpointEngine,
                                          CorruptShardError, read_latest,
                                          read_manifest, sharded_layout,
                                          tree_keys, tree_layout)
from horovod_tpu_torch.checkpoint import engine as _engine_mod
from horovod_tpu_torch.checkpoint import layout as _layout
from horovod_tpu_torch.checkpoint import reader as _reader
from horovod_tpu_torch.checkpoint.writer import AsyncWriter
from horovod_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _none(name):
    return None


def _files(d, step):
    sdir = os.path.join(d, f"step-{step}")
    return {f: open(os.path.join(sdir, f), "rb").read()
            for f in sorted(os.listdir(sdir))}


# --------------------------------------------------------------------------
# Key strings and byte identity with the JAX engine
# --------------------------------------------------------------------------

class _Pair(NamedTuple):
    a: object
    b: object


KEY_TREES = {
    "nested": {"z": {"y": 1.0, "x": [1, None, (2, 3)]}, "a": np.ones(2)},
    "ordered": collections.OrderedDict([("z", 1), ("a", {"q": 2, "b": 3})]),
    "int_keys": {"state": {3: {"m": 1}, 1: {"m": 2}}, "groups": [{"lr": 1}]},
    "named_tuple": {"t": _Pair(a=[1, 2], b={"c": 3}), "n": None},
    "quoted": {"it's": 1, "plain": [[1], [2, [3]]]},
}


@pytest.mark.parametrize("name", sorted(KEY_TREES))
def test_tree_keys_are_jax_keystr(name):
    import jax
    tree = KEY_TREES[name]
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = list(tree_keys(tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))


def _mixed_trees():
    """(JAX's numpy tree, the port's tree with tensors) of one value."""
    import ml_dtypes
    rng = np.random.RandomState(0)
    w = rng.randn(5, 3).astype(np.float32)
    h = (rng.randn(4, 6) * 3).astype(ml_dtypes.bfloat16)
    ids = rng.randint(-50, 50, size=(7,)).astype(np.int32)
    jax_tree = {
        "zeta": {"w": w, "count": np.int64(9), "ids": ids},
        "alpha": [h, np.float32(0.25)],
        "mid": collections.OrderedDict([("q", np.arange(4.0)),
                                        ("b", np.float16(1.5))]),
        "bf0": np.asarray(ml_dtypes.bfloat16(2.75)),
    }
    port_tree = {
        "zeta": {"w": torch.from_numpy(w.copy()), "count": np.int64(9),
                 "ids": torch.from_numpy(ids.copy())},
        "alpha": [torch.from_numpy(h.view(np.int16).copy()).view(
            torch.bfloat16), np.float32(0.25)],
        "mid": collections.OrderedDict([("q", np.arange(4.0)),
                                        ("b", np.float16(1.5))]),
        "bf0": torch.tensor(2.75, dtype=torch.bfloat16),
    }
    return jax_tree, port_tree


def _jax_engine(d):
    from horovod_tpu.checkpoint import CheckpointEngine as JaxEngine
    return JaxEngine(d, barrier=_none)


@pytest.fixture(scope="module")
def commits(tmp_path_factory):
    d = tmp_path_factory.mktemp("bytes")
    jax_tree, port_tree = _mixed_trees()
    _jax_engine(str(d / "jax")).save(jax_tree, 4, block=True)
    CheckpointEngine(str(d / "port")).save(port_tree, 4, block=True)
    return str(d / "jax"), str(d / "port"), jax_tree, port_tree


def test_same_files_bytes_and_manifest_as_jax(commits):
    jdir, pdir, _, _ = commits
    jfiles, pfiles = _files(jdir, 4), _files(pdir, 4)
    assert sorted(jfiles) == sorted(pfiles)
    assert any(f.endswith(".crc32") for f in jfiles)
    assert "manifest.json" in jfiles
    for name in jfiles:
        assert jfiles[name] == pfiles[name], name
    man = json.loads(pfiles["manifest.json"])
    assert {e["dtype"] for e in man["leaves"]} >= {
        "float32", "int32", "bfloat16", "int64", "float16", "float64"}
    assert open(os.path.join(jdir, "LATEST")).read() == \
        open(os.path.join(pdir, "LATEST")).read()


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    else:
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            x = x.view(np.int16)
    return x


def test_port_restores_jax_commit_bit_for_bit(commits):
    jdir, _, jax_tree, port_tree = commits
    got = CheckpointEngine(jdir).restore()
    want = dict(tree_keys(jax_tree))
    flat = dict(tree_keys(got))
    assert sorted(flat) == sorted(want)
    for key, value in flat.items():
        a, b = _bits(value), _bits(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b)
    assert flat["['alpha'][0]"].dtype == torch.bfloat16
    templated = CheckpointEngine(jdir).restore(template=port_tree)
    assert isinstance(templated["zeta"]["w"], torch.Tensor)
    assert torch.equal(templated["alpha"][0], port_tree["alpha"][0])
    assert isinstance(templated["mid"], collections.OrderedDict)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:   # the JAX engine's own error, compared
        return ("raised", type(e).__name__, str(e).split(":")[0])


def test_jax_restores_port_commit_as_its_own(commits, tmp_path):
    """JAX restores a commit the port wrote exactly as it restores the
    one it wrote itself. (JAX's ``read_block`` cannot assemble a bf16
    leaf: numpy has no cast from the ``'<V2'`` payload to
    ``bfloat16``, for its own commits too; so a tree without one
    restores, and the bf16 shard is read through ``load_shard``.)"""
    from horovod_tpu.checkpoint import reader as jreader
    jdir, pdir, jax_tree, port_tree = commits
    mine = _outcome(lambda: _jax_engine(pdir).restore())
    theirs = _outcome(lambda: _jax_engine(jdir).restore())
    assert mine[0] == theirs[0]
    if mine[0] == "raised":
        assert mine[1:] == theirs[1:]
    else:
        for (k, a), (_, b) in zip(tree_keys(mine[1]), tree_keys(theirs[1])):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    # Without the bf16 leaves JAX restores the port's commit in full.
    plain_j = {k: v for k, v in jax_tree.items() if k in ("zeta", "mid")}
    plain_p = {k: v for k, v in port_tree.items() if k in ("zeta", "mid")}
    CheckpointEngine(str(tmp_path / "p")).save(plain_p, 1, block=True)
    got = _jax_engine(str(tmp_path / "p")).restore()
    for key, want in tree_keys(plain_j):
        value = dict(tree_keys(got))[key]
        np.testing.assert_array_equal(np.asarray(value), np.asarray(want))
    # The bf16 shard the port wrote, as JAX loads it.
    man = read_manifest(pdir, 4)
    entry = {e["key"]: e for e in man["leaves"]}["['alpha'][0]"]
    raw = jreader.load_shard(os.path.join(pdir, "step-4"),
                             entry["shards"][0])
    np.testing.assert_array_equal(raw.view(np.int16),
                                  _bits(jax_tree["alpha"][0]))


_HIDDEN = r"""
import os, sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy still knows bfloat16")
except TypeError:
    pass
from horovod_tpu_torch.checkpoint import CheckpointEngine
src, dst = sys.argv[1], sys.argv[2]
tree = CheckpointEngine(src).restore()
got = tree["h"]
assert got.dtype == torch.bfloat16, got.dtype
np.save(os.path.join(dst, "read_bits.npy"), got.view(torch.int16).numpy())
bits = np.load(os.path.join(src, "bits.npy"))
out = torch.from_numpy(bits[::-1].copy()).view(torch.bfloat16)
CheckpointEngine(os.path.join(dst, "ck")).save({"h": out}, 2, block=True)
assert "ml_dtypes" not in {m for m in sys.modules if sys.modules[m]}
print("ok")
"""


def test_bf16_without_ml_dtypes(tmp_path):
    import ml_dtypes
    from horovod_tpu.checkpoint import reader as jreader
    src = tmp_path / "src"
    rng = np.random.RandomState(1)
    h = (rng.randn(3, 5) * 7).astype(ml_dtypes.bfloat16)
    _jax_engine(str(src)).save({"h": h}, 1, block=True)
    np.save(src / "bits.npy", h.view(np.int16))
    proc = subprocess.run(
        [sys.executable, "-c", _HIDDEN, str(src), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "read_bits.npy"),
                                  h.view(np.int16))
    man = json.load(open(tmp_path / "ck" / "step-2" / "manifest.json"))
    (entry,) = man["leaves"]
    assert entry["dtype"] == "bfloat16"
    raw = jreader.load_shard(str(tmp_path / "ck" / "step-2"),
                             entry["shards"][0])
    np.testing.assert_array_equal(raw.view(np.int16),
                                  h.view(np.int16)[::-1])
    assert raw.view(ml_dtypes.bfloat16).shape == (3, 5)


# --------------------------------------------------------------------------
# The torch shim's checkpoint_hook as the oracle
# --------------------------------------------------------------------------

def _linear_sgd(seed):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(6, 4)
    model(x).square().mean().backward()
    opt.step()
    return model, opt


def test_hook_matches_the_torch_shim(tmp_path):
    import horovod_tpu.torch as shim
    from horovod_tpu_torch.checkpoint import checkpoint_hook
    model, opt = _linear_sgd(0)
    theirs = shim.checkpoint_hook(str(tmp_path / "shim"), model=model,
                                  optimizer=opt, every=2)
    mine = checkpoint_hook(str(tmp_path / "port"), model=model,
                           optimizer=opt, every=2)
    assert theirs(3) is None and mine(3) is None
    assert theirs(4, block=True).committed
    assert mine(4, block=True).committed
    a, b = _files(str(tmp_path / "shim"), 4), _files(str(tmp_path / "port"), 4)
    assert sorted(a) == sorted(b) and len(a) > 4
    for name in a:
        assert a[name] == b[name], name
    restored = mine.engine.restore()
    assert torch.equal(torch.from_numpy(restored["model"]["weight"]),
                       model.weight.detach())


def test_hook_takes_bf16_and_fp16(tmp_path):
    from horovod_tpu_torch.checkpoint import checkpoint_hook
    model = torch.nn.Linear(4, 3).to(torch.bfloat16)
    model.bias.data = model.bias.data.to(torch.float16)
    save = checkpoint_hook(str(tmp_path / "h"), model=model, every=1)
    save(1, block=True)
    restored = save.engine.restore()["model"]
    assert restored["weight"].dtype == torch.bfloat16
    assert torch.equal(restored["weight"], model.weight.detach())
    assert restored["bias"].dtype == np.float16
    with pytest.raises(ValueError, match="exactly one"):
        checkpoint_hook(model=model)


# --------------------------------------------------------------------------
# Cross-package flagship logits
# --------------------------------------------------------------------------

SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=32, remat=False)


def test_flagship_params_cross_both_ways(tmp_path):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models import transformer as ttfm
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **SMALL)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **SMALL)
    tok = np.random.RandomState(3).randint(0, 64, size=(2, 32)).astype(
        np.int32)
    # JAX writes, the port reads.
    tree = jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    _jax_engine(str(tmp_path / "j")).save(tree, 1, block=True)
    restored = CheckpointEngine(str(tmp_path / "j")).restore()
    model = ttfm.Transformer(tcfg, device="cpu")
    model.load_state_dict(interop.params_from_jax(restored))
    got = model.apply(torch.from_numpy(tok).long()).detach().numpy()
    want = np.asarray(jtfm.apply(tree, jnp.asarray(tok), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The port writes, JAX reads.
    other = ttfm.Transformer(tcfg, device="cpu",
                             generator=torch.Generator().manual_seed(5))
    CheckpointEngine(str(tmp_path / "p")).save(
        interop.params_to_jax(other.state_dict()), 2, block=True)
    jtree = _jax_engine(str(tmp_path / "p")).restore()
    want = np.asarray(jtfm.apply(jtree, jnp.asarray(tok), jcfg))
    got = other.apply(torch.from_numpy(tok).long()).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# tests/test_checkpoint.py: the rank-0 pickle convention
# --------------------------------------------------------------------------

def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3)},
            "step": 7, "np": np.arange(3)}


def test_save_restore_roundtrip(tmp_path):
    out = save_checkpoint(_state(), str(tmp_path / "ckpt"))
    assert out is not None   # a single process is rank 0
    restored = restore_checkpoint(str(tmp_path / "ckpt"))
    assert int(restored["step"]) == 7
    assert torch.equal(restored["params"]["w"],
                       torch.arange(6.0).reshape(2, 3))
    assert isinstance(restored["np"], np.ndarray)


def test_stepped_checkpoints(tmp_path):
    state = _state()
    save_checkpoint(state, str(tmp_path / "run"), step=3)
    state["step"] = 9
    save_checkpoint(state, str(tmp_path / "run"), step=4)
    r3 = restore_checkpoint(str(tmp_path / "run"), step=3)
    r4 = restore_checkpoint(str(tmp_path / "run"), step=4)
    assert int(r3["step"]) == 7 and int(r4["step"]) == 9
    with pytest.raises(ValueError, match="directory"):
        save_checkpoint(state, str(tmp_path / "x.pkl"), step=1)


def test_pickle_holds_host_copies(tmp_path):
    w = torch.arange(4.0)
    save_checkpoint({"w": w}, str(tmp_path / "c"))
    w.add_(1)
    assert torch.equal(restore_checkpoint(str(tmp_path / "c"))["w"],
                       torch.arange(4.0))


# --------------------------------------------------------------------------
# tests/test_checkpoint_engine.py
# --------------------------------------------------------------------------

N = 64


def _split(shape, n_blocks):
    """``n_blocks`` contiguous blocks of dim 0, block k on process k."""
    per = shape[0] // n_blocks
    return [(((k * per, (k + 1) * per),) + tuple((0, d) for d in shape[1:]),
             k) for k in range(n_blocks)]


def _sim_layout(world, p, shape=(N,), dtype="float64"):
    """Process ``p``'s layout of a leaf split over ``world`` processes,
    one block each (one process drives one device)."""
    blocks = _split(shape, world)
    return sharded_layout(shape, dtype, blocks, held=blocks[p][0])


def _sim_save(directory, value, step, world, extra_tree=None, **kw):
    """Save ``{"moments": value (split over the processes), **extra}``
    as a ``world``-process job: every simulated rank's engine writes its
    block, rank 0 last (it assembles the manifest after the shard
    barrier, a no-op in simulation)."""
    for p in list(range(1, world)) + [0]:
        ll = _sim_layout(world, p, value.shape)
        (a, b), = ll.held
        eng = CheckpointEngine(directory, process_index=p,
                               process_count=world, barrier=_none, **kw)
        eng.save({"moments": value[a:b], **(extra_tree or {})}, step,
                 block=True, layouts={"['moments']": ll})
    return eng


def _moments(scale=1.0):
    return np.arange(float(N)) * scale


class TestLayout:
    def test_sharded_vs_replicated_leaves(self):
        ll = _sim_layout(4, 1)
        assert not ll.replicated and len(ll.shards) == 4
        assert {s.process for s in ll.shards} == {0, 1, 2, 3}
        spans = sorted(s.index[0] for s in ll.shards)
        assert spans[0][0] == 0 and spans[-1][1] == N
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c
        assert ll.held == ((16, 32),)
        assert ll.shards_of(1) == (_layout.Shard(((16, 32),), 1),)
        layouts = tree_layout({"m": np.zeros(N), "p": torch.ones(3, 4),
                               "count": np.int64(3)}, {"['m']": ll})
        assert layouts["['p']"].replicated
        assert layouts["['p']"].shards[0].process == 0
        assert layouts["['p']"].dtype == "float32"
        assert layouts["['count']"].shape == ()

    def test_replica_dedup_single_writer(self):
        """A block held by several processes is written once, by the
        lowest of them — never once per replica."""
        ll = sharded_layout((4, 2), "float32",
                            [(((0, 4), (0, 2)), p) for p in (3, 1, 2)])
        assert len(ll.shards) == 1 and ll.shards[0].process == 1

    def test_intersect_and_relative(self):
        a = ((0, 16),)
        b = ((8, 32),)
        assert _layout.intersect_spans(a, b) == ((8, 16),)
        assert _layout.intersect_spans(((0, 4),), ((4, 8),)) is None
        assert _layout.relative_slices(b, ((8, 16),)) == (slice(0, 8),)


class TestCommitProtocol:
    def test_manifest_schema_and_latest(self, tmp_path):
        d = str(tmp_path / "ck")
        _sim_save(d, _moments(), 7, world=4,
                  extra_tree={"params": np.arange(12.0).reshape(3, 4),
                              "count": np.int64(3)})
        assert read_latest(d) == 7
        man = read_manifest(d, 7)
        assert man["format"] == "horovod_tpu.checkpoint/1"
        assert man["step"] == 7 and man["process_count"] == 4
        keys = {e["key"] for e in man["leaves"]}
        assert keys == {"['moments']", "['params']", "['count']"}
        for entry in man["leaves"]:
            for shard in entry["shards"]:
                assert set(shard) == {"file", "index", "process",
                                      "crc32", "nbytes"}
                path = os.path.join(d, "step-7", shard["file"])
                assert os.path.getsize(path) == shard["nbytes"]
                with open(path + ".crc32") as f:
                    crc, nbytes = f.read().split()
                assert crc == shard["crc32"]
                assert int(nbytes) == shard["nbytes"]

    def test_crash_between_shards_and_manifest(self, tmp_path, monkeypatch):
        """Shards of step 2 on disk but no manifest: LATEST stays on
        step 1 and restore returns step 1's data."""
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, barrier=_none)
        eng.save({"w": torch.arange(4.0)}, 1, block=True)

        def boom(self, handle, layouts, pcount, extra, fps=None):
            raise RuntimeError("simulated crash before manifest")

        monkeypatch.setattr(CheckpointEngine, "_commit_rank0", boom)
        eng2 = CheckpointEngine(d, barrier=_none)
        eng2.save({"w": torch.arange(4.0) * 2}, 2)
        with pytest.raises(RuntimeError, match="checkpoint write"):
            eng2.wait()
        monkeypatch.undo()
        assert glob.glob(os.path.join(d, "step-2", "*.npy"))
        assert not os.path.exists(os.path.join(d, "step-2",
                                               "manifest.json"))
        assert read_latest(d) == 1
        restored = CheckpointEngine(d, barrier=_none).restore()
        assert torch.equal(torch.from_numpy(restored["w"]),
                           torch.arange(4.0))

    def test_latest_flip_is_ordered(self, tmp_path):
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, barrier=_none)
        for step in (1, 2, 3):
            eng.save({"w": torch.full((8,), float(step))}, step, block=True)
            latest = read_latest(d)
            assert latest == step
            assert os.path.exists(os.path.join(
                d, f"step-{latest}", "manifest.json"))

    def test_async_save_returns_before_commit(self, tmp_path):
        d = str(tmp_path / "ck")
        gate = threading.Event()
        entered = threading.Event()

        def slow_barrier(name):
            if name.startswith("ckpt.shards."):
                entered.set()
                assert gate.wait(10)

        eng = CheckpointEngine(d, barrier=slow_barrier)
        w = torch.arange(32.0)
        handle = eng.save({"w": w}, 5)
        w.add_(100)        # the next step: the snapshot is already taken
        assert not handle.committed
        assert entered.wait(10)
        assert read_latest(d) is None
        gate.set()
        eng.wait()
        assert handle.committed and read_latest(d) == 5
        assert torch.equal(torch.from_numpy(eng.restore()["w"]),
                           torch.arange(32.0))

    def test_blocked_vs_total_seconds_reported(self, tmp_path):
        d = str(tmp_path / "ck")

        def slow_barrier(name):
            time.sleep(0.05)

        eng = CheckpointEngine(d, barrier=slow_barrier)
        t0 = time.perf_counter()
        eng.save({"w": torch.arange(1024.0)}, 1)
        foreground = time.perf_counter() - t0
        eng.wait()
        # the loop never paid the two slow barriers (>= 0.1 s)
        assert foreground < 0.1
        assert eng.blocked_s <= foreground + 0.01
        assert eng.save_s >= 0.1

    def test_write_failure_surfaces_on_wait(self, tmp_path, monkeypatch):
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, barrier=_none)
        eng.save({"w": torch.arange(4.0)}, 1, block=True)

        def dead_disk(directory, filename, arr):
            raise IOError("No space left on device")

        monkeypatch.setattr(_engine_mod, "write_shard", dead_disk)
        eng.save({"w": torch.arange(4.0) * 2}, 2)
        with pytest.raises(RuntimeError, match="checkpoint write"):
            eng.wait()
        monkeypatch.undo()
        assert read_latest(d) == 1


class TestReshardedRestore:
    def test_ws4_to_ws2_ws1_and_reverse(self, tmp_path):
        """A world-size-4 commit restores bit for bit into world sizes 2
        and 1 through the manifest overlap path (and a ws-2 commit into
        4 and 1)."""
        ref = _moments(3.0)
        params = np.arange(12.0).reshape(3, 4) * 3
        for save_ws, restore_ws in [(4, 2), (4, 1), (2, 4), (2, 1)]:
            d = str(tmp_path / f"ck{save_ws}to{restore_ws}")
            eng = _sim_save(d, ref, 11, world=save_ws,
                            extra_tree={"params": params})
            if restore_ws == 1:
                restored = eng.restore()
                np.testing.assert_array_equal(restored["moments"], ref)
                np.testing.assert_array_equal(restored["params"], params)
                continue
            new = _sim_layout(restore_ws, 0)
            got = np.full(N, np.nan)
            for p in range(restore_ws):
                blocks = eng.restore_addressable(
                    {"['moments']": new,
                     "['params']": _layout.leaf_layout(params)},
                    process_index=p)
                for shard, arr in blocks["['moments']"]:
                    got[shard.slices] = arr
                np.testing.assert_array_equal(blocks["['params']"][0][1],
                                              params)
            np.testing.assert_array_equal(got, ref)

    def test_resharded_reads_only_overlapping_files(self, tmp_path):
        d = str(tmp_path / "ck")
        _sim_save(d, _moments(), 4, world=4)
        man = read_manifest(d, 4)
        entry = {e["key"]: e for e in man["leaves"]}["['moments']"]
        upper = _layout.Shard(index=((32, 64),), process=1)
        needed = {s["file"] for s in
                  _reader.shards_overlapping(entry, upper.index)}
        all_files = {s["file"] for s in entry["shards"]}
        assert needed < all_files and len(needed) == 2
        for fname in all_files - needed:
            os.remove(os.path.join(d, "step-4", fname))
        block = _reader.read_block(os.path.join(d, "step-4"), entry,
                                   upper.index)
        np.testing.assert_array_equal(block, np.arange(32.0, 64.0))
        with pytest.raises(CorruptShardError, match="missing"):
            _reader.read_block(os.path.join(d, "step-4"), entry,
                               ((0, 32),))

    def test_sharded_template_leaf_reads_its_block(self, tmp_path):
        """A leaf ``layouts`` names is read as this process's block, and
        a saved shape other than the layout's is refused."""
        d = str(tmp_path / "ck")
        eng = _sim_save(d, _moments(2.0), 3, world=4)
        ll = sharded_layout((N,), "float64", _split((N,), 8),
                            held=((40, 48),))
        got = eng.restore(template={"moments": torch.zeros(8)},
                          layouts={"['moments']": ll})
        assert torch.equal(got["moments"],
                           torch.arange(40.0, 48.0, dtype=torch.float64) * 2)
        wrong = sharded_layout((N + 4,), "float64", _split((N + 4,), 4),
                               held=((0, 17),))
        with pytest.raises(ValueError, match="padded for its 'dp' size"):
            eng.restore(template={"moments": torch.zeros(17)},
                        layouts={"['moments']": wrong})

    def test_templateless_restore_dict_tree(self, tmp_path):
        d = str(tmp_path / "ck")
        tree = {"a": {"b": np.arange(6.0).reshape(2, 3)},
                "c": [np.ones(2), torch.zeros(3)]}
        eng = CheckpointEngine(d, barrier=_none)
        eng.save(tree, 1, block=True)
        restored = eng.restore()
        np.testing.assert_array_equal(restored["a"]["b"], tree["a"]["b"])
        np.testing.assert_array_equal(restored["c"][0], 1.0)
        np.testing.assert_array_equal(restored["c"][1], 0.0)

    def test_namedtuple_tree_needs_template(self, tmp_path):
        d = str(tmp_path / "ck")
        state = _Pair(a=torch.ones(8), b={"n": 8})
        eng = CheckpointEngine(d, barrier=_none)
        eng.save(state, 1, block=True)
        with pytest.raises(ValueError, match="template"):
            eng.restore()
        restored = eng.restore(template=state)
        assert type(restored).__name__ == "_Pair"
        assert torch.equal(restored.a, torch.ones(8))
        assert restored.b["n"] == 8 and type(restored.b["n"]) is int


class TestCorruptionAndFallback:
    def _commit(self, d, step, scale):
        eng = CheckpointEngine(d, barrier=_none)
        eng.save({"w": torch.arange(16.0) * scale,
                  "b": np.ones(3) * scale}, step, block=True)
        return eng

    def test_corrupt_shard_falls_back_to_previous_commit(self, tmp_path,
                                                         caplog):
        d = str(tmp_path / "ck")
        self._commit(d, 1, 1.0)
        eng = self._commit(d, 2, 2.0)
        target = sorted(glob.glob(os.path.join(d, "step-2", "*.npy")))[0]
        with open(target, "r+b") as f:
            f.seek(80)
            f.write(b"\x13\x37\x13\x37")
        with caplog.at_level("WARNING"):
            restored = eng.restore()        # falls back to step 1
        assert "falling back" in caplog.text
        assert eng.restored_step == 1
        np.testing.assert_array_equal(restored["w"], np.arange(16.0))
        with pytest.raises(CorruptShardError):
            eng.restore(strict=True)

    def test_truncated_and_missing_shard_are_typed(self, tmp_path):
        d = str(tmp_path / "ck")
        eng = self._commit(d, 1, 1.0)
        files = sorted(glob.glob(os.path.join(d, "step-1", "*.npy")))
        with open(files[0], "r+b") as f:
            f.truncate(10)
        with pytest.raises(CorruptShardError, match="size"):
            eng.restore(strict=True)
        os.remove(files[0])
        with pytest.raises(CorruptShardError, match="missing"):
            eng.restore(strict=True)

    def test_value_fingerprint_mismatch_is_corruption(self, tmp_path):
        """The bytes match their crc, the values not what was saved: the
        manifest's fingerprint catches it."""
        d = str(tmp_path / "ck")
        eng = self._commit(d, 1, 1.0)
        man_path = os.path.join(d, "step-1", "manifest.json")
        man = json.load(open(man_path))
        man["fingerprints"]["['w']"][0] += 1.0
        open(man_path, "w").write(json.dumps(man))
        with pytest.raises(CorruptShardError, match="fingerprint"):
            eng.restore(strict=True)


class TestRetentionGC:
    def test_keep_last_n_never_latest(self, tmp_path):
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, keep_last=3, barrier=_none)
        for step in range(1, 8):
            eng.save({"w": torch.full((4,), float(step))}, step, block=True)
        assert eng.steps() == [5, 6, 7]
        assert read_latest(d) == 7
        assert not os.path.exists(os.path.join(d, "step-1"))
        restored = eng.restore(step=5)
        np.testing.assert_array_equal(restored["w"], 5.0)

    def test_keep_zero_is_unlimited(self, tmp_path):
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, keep_last=0, barrier=_none)
        for step in range(1, 6):
            eng.save({"w": np.zeros(2)}, step, block=True)
        assert eng.steps() == [1, 2, 3, 4, 5]

    def test_env_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_CHECKPOINT_KEEP", "2")
        d = str(tmp_path / "ck")
        eng = CheckpointEngine(d, barrier=_none)
        assert eng.keep_last == 2
        for step in range(1, 5):
            eng.save({"w": np.zeros(2)}, step, block=True)
        assert eng.steps() == [3, 4]


class TestAsyncWriter:
    def test_fifo_and_wait(self):
        w = AsyncWriter()
        out = []
        for i in range(5):
            w.submit(lambda i=i: out.append(i))
        w.wait()
        assert out == [0, 1, 2, 3, 4]
        w.close()

    def test_error_poisons_until_waited(self):
        w = AsyncWriter()
        w.submit(lambda: (_ for _ in ()).throw(IOError("disk gone")))
        with pytest.raises(RuntimeError, match="checkpoint write"):
            w.wait()
        w.submit(lambda: None)
        w.wait()
        w.close()


def test_live_module_and_optimizer_as_template(tmp_path):
    """A live module or optimizer as the template: the result is what its
    ``load_state_dict`` takes, a fresh optimizer's state grown from the
    manifest."""
    model, opt = _linear_sgd(0)
    eng = CheckpointEngine(str(tmp_path / "t"))
    eng.save({"m": model.state_dict(), "o": opt.state_dict()}, 1,
             block=True)
    fresh = torch.nn.Linear(4, 3)
    fopt = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    tree = eng.restore(template={"m": fresh, "o": fopt})
    fresh.load_state_dict(tree["m"])
    fopt.load_state_dict(tree["o"])
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(fopt.state[p]["momentum_buffer"],
                           opt.state[q]["momentum_buffer"])
    assert fopt.param_groups[0]["momentum"] == 0.9


def test_torch_checkpoint_hook(tmp_path):
    """``TestShimHooks``: the port's hook on its own."""
    from horovod_tpu_torch import checkpoint_hook
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    save = checkpoint_hook(str(tmp_path / "pt"), model=model, optimizer=opt,
                           every=2)
    assert save(1) is None
    handle = save(2, block=True)
    assert handle is not None and handle.committed
    restored = save.engine.restore()
    np.testing.assert_array_equal(restored["model"]["weight"],
                                  model.state_dict()["weight"].numpy())
    assert "optimizer" in restored
