"""The port's input pipeline (``horovod_tpu_torch/data``) against the
JAX package's ``horovod_tpu/data``: the counterpart of
``tests/test_data.py``'s loader, source, cursor and prefetch cases.

- The epoch plan byte for byte JAX's: ``epoch_permutation`` and every
  rank's delivered ids and batches over a grid of (n, batch, world,
  epoch, seed), and the synthetic samples (image and tokens) byte for
  byte JAX's for the same seed and ids.
- ``TestEpochPermutation``, ``TestSources``, ``TestShardedLoader`` (but
  its metric families, which wait for the port's observability),
  ``TestCursorResume``'s cases that touch neither the elastic state nor
  the checkpoint engine (round trip, exactly once across a world shrink
  and regrow, a mismatched plan refused) and ``TestPrefetch`` on the CPU
  device, with a duck-typed timer in place of ``StepTimer``.
- ``build_loader`` takes rank and world size from the port's topology.
"""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu.data import sharding as jshd

import horovod_tpu_torch as thvd
from horovod_tpu_torch import data
from horovod_tpu_torch.data import sharding as shd

# (n, batch, world, epoch, seed) of the byte-for-byte plan comparisons.
PLANS = [(70, 4, 1, 0, 0), (70, 4, 2, 1, 11), (100, 8, 3, 2, 7),
         (257, 16, 4, 0, 123), (64, 4, 8, 3, 9), (33, 5, 2, 5, 2 ** 31),
         (12, 4, 2, 0, 1), (1000, 32, 4, 7, 1234)]


# ---------------------------------------------------------------------------
# Byte for byte the JAX package's plan and samples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch,world,epoch,seed", PLANS)
def test_epoch_plan_is_jax_byte_for_byte(n, batch, world, epoch, seed):
    got = shd.epoch_permutation(n, seed, epoch)
    want = jshd.epoch_permutation(n, seed, epoch)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert shd.usable_samples(n, batch) == jshd.usable_samples(n, batch)
    total = shd.total_microbatches(n, batch)
    assert total == jshd.total_microbatches(n, batch)
    for offset in range(0, total + world, max(1, world)):
        for r in range(world):
            assert shd.rank_microbatch(offset, r, world, total) == \
                jshd.rank_microbatch(offset, r, world, total)
        assert shd.advance(offset, world, total) == \
            jshd.advance(offset, world, total)
    src = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    for r in range(world):
        ours = data.build_loader(src, batch_size=batch, rank=r,
                                 world_size=world, seed=seed,
                                 epochs=epoch + 1)
        theirs = jdata.build_loader(src, batch_size=batch, rank=r,
                                    world_size=world, seed=seed,
                                    epochs=epoch + 1)
        for a, b in zip(ours, theirs, strict=True):
            assert (a.weight, a.epoch) == (b.weight, b.epoch)
            assert a.ids.tobytes() == b.ids.tobytes()
            assert a.data[0].tobytes() == b.data[0].tobytes()


@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("kind", ["image", "tokens"])
def test_synthetic_samples_are_jax_byte_for_byte(kind, seed):
    kw = (dict(image_size=8, num_classes=5) if kind == "image"
          else dict(seq_len=16, vocab=100))
    ids = np.array([0, 7, 3, 7, 41, 2 ** 20])
    got = data.synthetic(kind, n=50, seed=seed, **kw).take(ids)
    want = jdata.synthetic(kind, n=50, seed=seed, **kw).take(ids)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Epoch plan determinism (TestEpochPermutation)
# ---------------------------------------------------------------------------

def test_pure_function_of_seed_and_epoch():
    np.testing.assert_array_equal(shd.epoch_permutation(100, 7, 3),
                                  shd.epoch_permutation(100, 7, 3))


def test_epochs_and_seeds_differ():
    base = shd.epoch_permutation(100, seed=7, epoch=0)
    assert not np.array_equal(base, shd.epoch_permutation(100, 7, 1))
    assert not np.array_equal(base, shd.epoch_permutation(100, 8, 0))


def test_is_a_permutation():
    p = shd.epoch_permutation(257, seed=0, epoch=5)
    np.testing.assert_array_equal(np.sort(p), np.arange(257))


def test_no_shuffle_is_sequential():
    np.testing.assert_array_equal(
        shd.epoch_permutation(10, 3, 2, shuffle=False), np.arange(10))


def test_drop_remainder_is_world_independent():
    for w in (1, 2, 4, 8):
        assert shd.usable_samples(70, 4) == 68, w


# ---------------------------------------------------------------------------
# Sources (TestSources)
# ---------------------------------------------------------------------------

def test_array_source_pairs():
    xs = np.arange(20).reshape(10, 2).astype(np.float32)
    ys = np.arange(10).astype(np.int32)
    got = data.as_source((xs, ys)).take(np.array([3, 1]))
    np.testing.assert_array_equal(got[0], xs[[3, 1]])
    np.testing.assert_array_equal(got[1], ys[[3, 1]])


def test_array_source_length_mismatch():
    with pytest.raises(ValueError, match="axis-0 length"):
        data.ArraySource(np.zeros((4, 2)), np.zeros((5,)))


def test_file_list_source(tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"s{i}.npy"
        np.save(p, np.full((3,), float(i)))
        paths.append(str(p))
    src = data.as_source(paths)
    assert len(src) == 6
    (batch,) = src.take(np.array([4, 0, 5]))
    np.testing.assert_array_equal(batch[:, 0], [4.0, 0.0, 5.0])


def test_callable_source_needs_length():
    def fn(ids):
        return np.asarray(ids, np.float32) * 2
    with pytest.raises(ValueError, match="length"):
        data.as_source(fn)
    src = data.as_source(fn, length=9)
    assert len(src) == 9
    (b,) = src.take(np.array([1, 4]))
    np.testing.assert_array_equal(b, [2.0, 8.0])


def test_synthetic_sample_is_pure_function_of_id():
    a = data.synthetic("image", n=50, image_size=4, seed=3)
    b = data.synthetic("image", n=50, image_size=4, seed=3)
    ia, la = a.take(np.array([7, 3, 7]))
    ib, lb = b.take(np.array([7]))
    np.testing.assert_array_equal(ia[0], ia[2])
    np.testing.assert_array_equal(ia[0], ib[0])
    assert la[0] == lb[0]


def test_synthetic_tokens_shape_and_range():
    (t,) = data.synthetic("tokens", n=10, seq_len=16, vocab=100,
                          seed=1).take(np.array([0, 9]))
    assert t.shape == (2, 16) and t.dtype == np.int32
    assert t.min() >= 0 and t.max() < 100


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="synthetic kind"):
        data.synthetic("video")


# ---------------------------------------------------------------------------
# Sharded loader (TestShardedLoader)
# ---------------------------------------------------------------------------

def _collect_epoch(src, *, world, batch, seed, **kw):
    """One epoch on ``world`` fresh loaders: per-rank id lists."""
    out = [[] for _ in range(world)]
    for r in range(world):
        for b in data.build_loader(src, batch_size=batch, rank=r,
                                   world_size=world, seed=seed, epochs=1,
                                   **kw):
            out[r].extend(b.ids.tolist())
    return out


def test_one_epoch_is_a_disjoint_cover():
    src = data.synthetic("image", n=70, image_size=4, seed=0)
    per_rank = _collect_epoch(src, world=2, batch=4, seed=11)
    flat = [i for ids in per_rank for i in ids]
    assert len(flat) == shd.usable_samples(70, 4) == 68
    assert len(set(flat)) == 68
    assert not (set(per_rank[0]) & set(per_rank[1]))
    ds = data.ShardedDataset(src, batch_size=4, seed=11)
    assert sorted(flat) == sorted(ds.epoch_ids(0).tolist())


def test_identical_across_launches():
    src = data.synthetic("image", n=64, image_size=4, seed=0)
    assert _collect_epoch(src, world=4, batch=4, seed=9) == \
        _collect_epoch(src, world=4, batch=4, seed=9)


def test_static_shapes_including_filler():
    src = data.synthetic("image", n=12, image_size=4, num_classes=3, seed=0)
    batches = list(data.build_loader(src, batch_size=4, rank=1,
                                     world_size=2, seed=1, epochs=1))
    assert [b.weight for b in batches] == [4, 0]
    filler = batches[-1]
    assert filler.data[0].shape == (4, 4, 4, 3)
    assert filler.ids.size == 0
    np.testing.assert_array_equal(filler.data[0], 0.0)


def test_epoch_rolls_over_with_new_permutation():
    src = data.synthetic("image", n=16, image_size=4, seed=0)
    ids = [b.ids.tolist() for b in data.build_loader(
        src, batch_size=4, rank=0, world_size=1, seed=2, epochs=2)]
    assert len(ids) == 8
    e0, e1 = sum(ids[:4], []), sum(ids[4:], [])
    assert sorted(e0) == sorted(e1) == list(range(16))
    assert e0 != e1


def test_transform_applies_per_batch():
    src = data.synthetic("image", n=16, image_size=4, seed=0)
    ld = data.build_loader(
        src, batch_size=4, rank=0, world_size=1, seed=2, epochs=1,
        transform=lambda arrs: (arrs[0] * 0 + 7.0,) + arrs[1:])
    np.testing.assert_array_equal(next(ld).data[0], 7.0)


def test_drop_remainder_false_rejected():
    with pytest.raises(ValueError, match="drop_remainder"):
        data.build_loader(np.zeros((10, 2)), batch_size=4, rank=0,
                          world_size=1, drop_remainder=False)


def test_zero_microbatches_rejected():
    with pytest.raises(ValueError, match="zero whole"):
        data.build_loader(np.zeros((3, 2)), batch_size=4, rank=0,
                          world_size=1)


def test_rank_outside_world_rejected():
    with pytest.raises(ValueError, match="outside world"):
        data.build_loader(np.zeros((8, 2)), batch_size=4, rank=2,
                          world_size=2)


def test_rank_and_world_default_to_the_topology():
    thvd.init(device="cpu")
    ld = data.build_loader(np.zeros((8, 2)), batch_size=4)
    assert (ld.rank, ld.world_size) == (thvd.rank(), thvd.size())
    assert data.build_loader(np.zeros((8, 2)), batch_size=4,
                             world_size=3, rank=2).world_size == 3


def test_steps_and_samples_per_epoch():
    ld = data.build_loader(np.zeros((70, 2)), batch_size=4, rank=0,
                           world_size=4)
    assert ld.samples_per_epoch == 68 and ld.steps_per_epoch == 5


# ---------------------------------------------------------------------------
# Cursor and exactly-once resume (TestCursorResume)
# ---------------------------------------------------------------------------

def test_cursor_roundtrip_continues_exactly():
    src = data.synthetic("image", n=40, image_size=4, seed=0)
    ld = data.build_loader(src, batch_size=4, rank=0, world_size=1, seed=5)
    for _ in range(3):
        next(ld)
    cur = ld.commit_cursor()
    assert {k: int(v) for k, v in cur.items()} == {
        "version": 1, "seed": 5, "batch_size": 4, "epoch": 0, "offset": 3}
    resumed = data.build_loader(src, batch_size=4, rank=0, world_size=1,
                                seed=5).restore(cur)
    ref = data.build_loader(src, batch_size=4, rank=0, world_size=1, seed=5)
    for _ in range(3):
        next(ref)
    for _ in range(8):    # across the epoch boundary
        a, b = next(resumed), next(ref)
        np.testing.assert_array_equal(a.ids, b.ids)
        assert a.epoch == b.epoch


def test_cursor_matches_jax_cursor():
    src = np.zeros((40, 2), np.float32)
    ours = data.build_loader(src, batch_size=4, rank=0, world_size=2, seed=5)
    theirs = jdata.build_loader(src, batch_size=4, rank=0, world_size=2,
                                seed=5)
    for _ in range(7):
        next(ours), next(theirs)
    a, b = ours.cursor(), theirs.cursor()
    assert a.keys() == b.keys()
    assert all(a[k] == b[k] and a[k].dtype == b[k].dtype for k in a)


def test_exactly_once_across_world_shrink_and_regrow():
    src = data.synthetic("image", n=100, image_size=4, seed=0)
    ds = data.ShardedDataset(src, batch_size=4, seed=21)
    consumed = []
    l2 = [data.build_loader(src, batch_size=4, rank=r, world_size=2,
                            seed=21) for r in range(2)]
    for _ in range(4):
        for ld in l2:
            consumed.extend(next(ld).ids.tolist())
    cur = l2[0].commit_cursor()
    l1 = data.build_loader(src, batch_size=4, rank=0, world_size=1,
                           seed=21).restore(cur)
    for _ in range(3):
        consumed.extend(next(l1).ids.tolist())
    cur = l1.commit_cursor()
    for r in range(2):
        for b in data.build_loader(src, batch_size=4, rank=r, world_size=2,
                                   seed=21, epochs=1).restore(cur):
            consumed.extend(b.ids.tolist())
    assert len(consumed) == ds.usable == 100
    assert sorted(consumed) == sorted(ds.epoch_ids(0).tolist())


def test_mismatched_plan_rejected():
    src = data.synthetic("image", n=40, image_size=4, seed=0)
    cur = data.build_loader(src, batch_size=4, rank=0, world_size=1,
                            seed=5).commit_cursor()
    with pytest.raises(ValueError, match="exactly-once"):
        data.build_loader(src, batch_size=4, rank=0, world_size=1,
                          seed=6).restore(cur)
    with pytest.raises(ValueError, match="exactly-once"):
        data.build_loader(src, batch_size=8, rank=0, world_size=1,
                          seed=5).restore(cur)


# ---------------------------------------------------------------------------
# Prefetch to the device (TestPrefetch), on the CPU device
# ---------------------------------------------------------------------------

class _Timer:
    """The duck type of ``StepTimer`` the prefetcher talks to."""

    def __init__(self):
        self.credits, self.marks = [], 0

    def credit_h2d(self, seconds):
        self.credits.append(seconds)

    def mark_h2d_done(self):
        self.marks += 1


def _loader(n=32, batch=4, **kw):
    src = data.synthetic("image", n=n, image_size=4, seed=0)
    return data.build_loader(src, batch_size=batch, rank=0, world_size=1,
                             seed=3, epochs=1, **kw)


def test_batches_arrive_on_device_in_order():
    ref = list(_loader())
    got = list(data.prefetch_to_device(_loader(), "cpu", depth=2))
    assert [b.ids.tolist() for b in got] == [b.ids.tolist() for b in ref]
    for a, b in zip(got, ref):
        images, labels = a.data
        assert isinstance(images, torch.Tensor) and images.device.type == \
            "cpu"
        assert images.dtype == torch.float32 and labels.dtype == torch.int32
        np.testing.assert_array_equal(images.numpy(), b.data[0])
        np.testing.assert_array_equal(labels.numpy(), b.data[1])


def test_plain_tuples_prefetch_too():
    arrays = [(np.full((2, 3), i, np.float32),) for i in range(4)]
    got = list(data.prefetch_to_device(iter(arrays), "cpu"))
    assert [float(t[0][0, 0]) for t in got] == [0.0, 1.0, 2.0, 3.0]


def test_overlaps_a_slow_source():
    delay, steps = 0.03, 6
    ld = _loader(n=steps * 4, transform=lambda a: (time.sleep(delay), a)[1])
    t0 = time.perf_counter()
    n = 0
    for _ in data.prefetch_to_device(ld, "cpu", depth=2):
        time.sleep(delay)   # the "step"
        n += 1
    wall = time.perf_counter() - t0
    assert n == steps
    assert wall < 2 * steps * delay * 0.95, wall


def test_source_exception_propagates():
    def boom(arrs):
        raise RuntimeError("bad decode")
    pf = data.prefetch_to_device(_loader(transform=boom), "cpu")
    with pytest.raises(RuntimeError, match="bad decode"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_depth_validated_and_waits_counted():
    with pytest.raises(ValueError, match="depth"):
        data.prefetch_to_device(_loader(), "cpu", depth=0)
    pf = data.prefetch_to_device(_loader(), "cpu", depth=3)
    assert len(list(pf)) == 8 and pf.depth == 3
    assert pf.waited_s > 0 and pf.h2d_s >= 0


def test_stalled_consumer_credits_the_timer():
    timer = _Timer()
    ld = _loader(n=12, transform=lambda a: (time.sleep(0.02), a)[1])
    assert len(list(data.prefetch_to_device(ld, "cpu", timer=timer))) == 3
    assert timer.credits and all(c >= 0 for c in timer.credits)


def test_stage_marks_timer():
    timer = _Timer()
    b = next(_loader())
    staged = data.stage(b, "cpu", timer=timer)
    assert timer.marks == 1
    assert isinstance(staged.data[0], torch.Tensor)
    np.testing.assert_array_equal(staged.data[0].numpy(), b.data[0])
    assert staged.ids is b.ids and staged.weight == b.weight


def test_close_stops_an_endless_loader():
    ld = data.build_loader(np.zeros((8, 2), np.float32), batch_size=4,
                           rank=0, world_size=1)
    pf = data.prefetch_to_device(ld, "cpu", depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()   # close waits for the producer
    with pytest.raises(StopIteration):
        next(pf)


def test_close_waits_for_the_batch_in_flight():
    """A producer blocked in a slow source ends once that batch arrives,
    and ``close`` returns only then."""
    release = threading.Event()

    def slow(ids):
        release.wait(10)
        return (np.zeros((len(ids), 2), np.float32),)

    ld = data.build_loader(data.CallableSource(slow, 8), batch_size=4,
                           rank=0, world_size=1)
    pf = data.prefetch_to_device(ld, "cpu", depth=1)
    threading.Timer(0.2, release.set).start()
    t0 = time.monotonic()
    pf.close()
    assert 0.15 <= time.monotonic() - t0 < 5
    assert not pf._thread.is_alive()
