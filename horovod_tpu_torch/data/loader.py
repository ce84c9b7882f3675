"""Sharded, resumable loaders: the per-rank face of the epoch plan.

Counterpart of ``horovod_tpu/data/loader.py``. ``build_loader(source,
batch_size=..., rank=..., world_size=...)`` returns a
:class:`ShardedLoader` that walks the deterministic epoch plan of
:mod:`.sharding`: each global step, rank ``r`` materializes microbatch
``offset + r`` of the current epoch permutation, or a zero-weight filler
batch when fewer than ``world_size`` microbatches remain (shapes stay
static through the epoch tail; divide masked sums by the sum of
``Batch.weight``).

Resumability is a cursor, not buffered state: ``(seed, epoch, offset,
batch_size)`` determines every sample any rank sees next. A loader
restored from a committed cursor replays no sample and skips none, at
any world size. The cursor is a plain dict of ints, so it rides an
``ElasticState`` commit beside the model on either backend (the pickle
or the sharded checkpoint engine)::

    state = ElasticState(model=model, optimizer=opt,
                         data=loader.commit_cursor())
    ...
    state.restore()
    loader.restore(state.data)

Behind ``prefetch_to_device`` the loader runs ahead of the step: commit
the prefetcher's ``commit_cursor()`` instead. The loader's metric
families and flight-recorder notes are not ported yet: :func:`_observe`
marks where they go.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

from . import sharding as _sharding
from .sources import as_source

_CURSOR_VERSION = 1


def _observe(event: str, *fields) -> None:
    """Hook for the loader's observability (the JAX loader's
    ``hvdtpu_data_*`` counters and flight-recorder notes: samples,
    batches, epochs, load seconds, cursor commits, resume skips). The
    port has no metric registry yet, so it records nothing."""


class Batch(NamedTuple):
    """One per-rank batch. ``data`` is the tuple of field arrays (static
    shapes ``[batch_size, ...]``, also for a filler), ``ids`` the sample
    ids delivered (empty for a filler), ``weight`` the number of real
    samples (0 for a filler), ``epoch`` the epoch of the batch."""

    data: Tuple[Any, ...]
    ids: np.ndarray
    weight: int
    epoch: int


class ShardedDataset:
    """A source plus the epoch-plan parameters, with no rank in sight:
    loaders over the same dataset agree on the plan at any world
    shape."""

    def __init__(self, source, *, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 length: Optional[int] = None):
        if not drop_remainder:
            raise ValueError(
                "drop_remainder=False is not supported: the epoch plan "
                "is defined in whole microbatches so its sample multiset "
                "is world-size independent (docs/data.md#sharding)")
        self.source = as_source(source, length=length)
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.n = len(self.source)
        self.usable = _sharding.usable_samples(self.n, self.batch_size)
        self.total_microbatches = _sharding.total_microbatches(
            self.n, self.batch_size)
        if self.total_microbatches == 0:
            raise ValueError(
                f"dataset of {self.n} samples yields zero whole "
                f"microbatches of {self.batch_size}")

    def permutation(self, epoch: int) -> np.ndarray:
        return _sharding.epoch_permutation(self.n, self.seed, epoch,
                                           shuffle=self.shuffle)

    def epoch_ids(self, epoch: int) -> np.ndarray:
        """The epoch's whole delivered multiset (drop-remainder
        applied)."""
        return self.permutation(epoch)[:self.usable]


class ShardedLoader:
    """Per-rank iterator over a :class:`ShardedDataset`. Not
    thread-safe; wrap it in :func:`~horovod_tpu_torch.data.
    prefetch_to_device` for background staging."""

    def __init__(self, dataset: ShardedDataset, *, rank: int,
                 world_size: int, epochs: Optional[int] = None,
                 transform=None):
        if not (0 <= rank < world_size):
            raise ValueError(
                f"rank {rank} outside world of {world_size}")
        self.dataset = dataset
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.epochs = epochs
        self.transform = transform
        self.epoch = 0
        self.offset = 0          # global microbatch cursor within epoch
        self._perm: Optional[np.ndarray] = None
        self._perm_epoch = -1
        self._template: Optional[Tuple[np.ndarray, ...]] = None
        self._epochs_done = 0

    # ------------------------------------------------------------ cursor

    def cursor(self) -> Dict[str, Any]:
        """The resume point as a dict of ints: the first unconsumed
        global microbatch."""
        return {"version": np.int64(_CURSOR_VERSION),
                "seed": np.int64(self.dataset.seed),
                "batch_size": np.int64(self.dataset.batch_size),
                "epoch": np.int64(self.epoch),
                "offset": np.int64(self.offset)}

    def commit_cursor(self) -> Dict[str, Any]:
        """:meth:`cursor`, observed as a commit."""
        _observe("cursor_commit", self.epoch, self.offset, self.rank)
        return self.cursor()

    def restore(self, cursor: Dict[str, Any]) -> "ShardedLoader":
        """Adopt a committed cursor. The plan parameters must match: a
        changed seed or batch size reshuffles every epoch, so it is an
        error, not a fast-forward."""
        seed = int(cursor["seed"])
        batch = int(cursor["batch_size"])
        if seed != self.dataset.seed or batch != self.dataset.batch_size:
            raise ValueError(
                f"cursor was cut for seed={seed} batch_size={batch}; "
                f"this loader has seed={self.dataset.seed} "
                f"batch_size={self.dataset.batch_size}: the epoch plans "
                "differ and exactly-once cannot hold")
        self.epoch = int(cursor["epoch"])
        self.offset = int(cursor["offset"])
        self._epochs_done = self.epoch
        _observe("resume", self.epoch, self.offset,
                 self.offset * self.dataset.batch_size)
        return self

    # --------------------------------------------------------- iteration

    def _permutation(self) -> np.ndarray:
        if self._perm_epoch != self.epoch:
            self._perm = self.dataset.permutation(self.epoch)
            self._perm_epoch = self.epoch
        return self._perm

    def _filler(self) -> Tuple[np.ndarray, ...]:
        """Zero arrays with the batch's static shapes, resolved once from
        a real microbatch (microbatch 0 always exists)."""
        if self._template is None:
            ids = _sharding.microbatch_ids(self._permutation(), 0,
                                           self.dataset.batch_size)
            probe = self.dataset.source.take(ids)
            if self.transform is not None:
                probe = self.transform(probe)
            self._template = tuple(
                np.zeros_like(np.asarray(a)) for a in probe)
        return self._template

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        total = self.dataset.total_microbatches
        if self.offset >= total:
            # Epoch boundary: every rank derives it from the same cursor.
            self.epoch += 1
            self.offset = 0
            self._epochs_done += 1
            _observe("epoch", self.epoch, self.rank)
        if self.epochs is not None and self._epochs_done >= self.epochs:
            raise StopIteration
        m = _sharding.rank_microbatch(self.offset, self.rank,
                                      self.world_size, total)
        epoch = self.epoch
        t0 = time.perf_counter()
        if m < 0:
            arrays = self._filler()
            ids = np.empty((0,), np.int64)
            weight = 0
        else:
            ids = _sharding.microbatch_ids(self._permutation(), m,
                                           self.dataset.batch_size)
            arrays = self.dataset.source.take(ids)
            if self.transform is not None:
                arrays = self.transform(arrays)
            weight = int(ids.shape[0])
        _observe("batch", weight, time.perf_counter() - t0)
        self.offset = _sharding.advance(self.offset, self.world_size,
                                        total)
        return Batch(tuple(np.asarray(a) for a in arrays), ids, weight,
                     epoch)

    # ------------------------------------------------------- conveniences

    @property
    def samples_per_epoch(self) -> int:
        return self.dataset.usable

    @property
    def steps_per_epoch(self) -> int:
        """Global steps to finish an epoch at this world size (the last
        may hand fillers to the highest ranks)."""
        t, w = self.dataset.total_microbatches, self.world_size
        return -(-t // w)


def build_loader(source, *, batch_size: int, rank: Optional[int] = None,
                 world_size: Optional[int] = None, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 epochs: Optional[int] = None, length: Optional[int] = None,
                 transform=None) -> ShardedLoader:
    """Wrap ``source`` in a :class:`ShardedDataset` and return this
    rank's :class:`ShardedLoader`. ``rank``/``world_size`` default to
    the port's topology when ``init()`` has run, else to a world of one.
    ``transform`` runs on each materialized batch (augmentation,
    decoding)."""
    if rank is None or world_size is None:
        from .. import topology as _topo
        if _topo.is_initialized():
            t = _topo.topology()
            rank = t.rank if rank is None else rank
            world_size = t.size if world_size is None else world_size
        else:
            rank = 0 if rank is None else rank
            world_size = 1 if world_size is None else world_size
    ds = ShardedDataset(source, batch_size=batch_size, seed=seed,
                        shuffle=shuffle, drop_remainder=drop_remainder,
                        length=length)
    return ShardedLoader(ds, rank=int(rank), world_size=int(world_size),
                         epochs=epochs, transform=transform)
