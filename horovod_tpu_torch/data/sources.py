"""Data sources: anything the sharded loader can index by sample id.

The port's copy of ``horovod_tpu/data/sources.py`` (pure numpy: the
synthetic samples are byte for byte JAX's for the same seed and id).

A source is ``__len__`` plus ``take(ids) -> tuple of np.ndarray``
(arrays batched on axis 0, one per field). Sharding, shuffling, cursors
and prefetch are the loader's job, so a source stays a random-access
reader:

  - :class:`ArraySource`: in-memory array(s).
  - :class:`FileListSource`: one file per sample (``read_fn`` defaults
    to ``np.load``).
  - :class:`CallableSource`: ``fn(ids) -> arrays`` with a declared
    length.
  - :func:`synthetic`: the deterministic synthetic workloads the
    examples train on. It is a source, not a bypass: the synthetic path
    runs the same shard, cursor and prefetch machinery as real data.

Synthetic samples are a pure function of ``(seed, sample id)`` (one
PCG64 stream per id), so the same id gives the same sample whichever
rank, batch, epoch or world size asks for it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, ...]


def _as_tuple(x) -> Arrays:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class ArraySource:
    """In-memory array(s) indexed on axis 0."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("ArraySource needs at least one array")
        self._arrays = tuple(np.asarray(a) for a in arrays)
        n = self._arrays[0].shape[0]
        for a in self._arrays[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    "all arrays must share axis-0 length: "
                    f"{[a.shape[0] for a in self._arrays]}")
        self._n = n

    def __len__(self) -> int:
        return self._n

    def take(self, ids: np.ndarray) -> Arrays:
        return tuple(a[ids] for a in self._arrays)


class FileListSource:
    """One file per sample; ``read_fn(path)`` returns one sample (array
    or tuple of arrays), stacked into the batch. Paths are captured at
    construction: the list is the dataset, so its order and length are
    as stable as the manifest the caller built it from."""

    def __init__(self, paths: Sequence[str],
                 read_fn: Optional[Callable] = None):
        self._paths = list(paths)
        self._read = read_fn if read_fn is not None else np.load

    def __len__(self) -> int:
        return len(self._paths)

    def take(self, ids: np.ndarray) -> Arrays:
        samples = [_as_tuple(self._read(self._paths[int(i)]))
                   for i in ids]
        if not samples:
            return ()
        return tuple(np.stack([s[f] for s in samples])
                     for f in range(len(samples[0])))


class CallableSource:
    """``fn(ids) -> array | tuple of arrays`` with a declared length: the
    adapter for generator-backed data whose length is known."""

    def __init__(self, fn: Callable[[np.ndarray], Arrays], length: int):
        self._fn = fn
        self._n = int(length)

    def __len__(self) -> int:
        return self._n

    def take(self, ids: np.ndarray) -> Arrays:
        return _as_tuple(self._fn(ids))


class SyntheticSource:
    """Deterministic synthetic samples, one PCG64 stream per sample id
    (see module docstring). ``kind``:

      ``"image"``   (images [B,H,W,3] float32 in [0,1), labels [B] int32):
                    class-prototype blobs, addressable by id.
      ``"tokens"``  (tokens [B,S] int32 in [0, vocab)).
    """

    def __init__(self, kind: str = "image", n: int = 4096, *,
                 image_size: int = 32, num_classes: int = 10,
                 seq_len: int = 128, vocab: int = 32000, seed: int = 0):
        if kind not in ("image", "tokens"):
            raise ValueError(f"unknown synthetic kind {kind!r}; "
                             "choose 'image' or 'tokens'")
        self.kind = kind
        self._n = int(n)
        self._image_size = int(image_size)
        self._classes = int(num_classes)
        self._seq = int(seq_len)
        self._vocab = int(vocab)
        self._seed = int(seed)
        if kind == "image":
            # Class prototypes are shared across all samples (drawn from
            # the seed stream alone) so the labels are learnable.
            proto_rng = np.random.Generator(np.random.PCG64(
                np.random.SeedSequence([self._seed, 0x9E3779B9])))
            self._protos = proto_rng.random(
                (self._classes, self._image_size, self._image_size, 3),
                dtype=np.float32)

    def __len__(self) -> int:
        return self._n

    def _rng(self, sample_id: int) -> np.random.Generator:
        return np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self._seed, int(sample_id)])))

    def take(self, ids: np.ndarray) -> Arrays:
        if self.kind == "tokens":
            rows = [self._rng(i).integers(0, self._vocab, size=self._seq,
                                          dtype=np.int64)
                    for i in ids]
            stack = (np.stack(rows).astype(np.int32) if rows
                     else np.empty((0, self._seq), np.int32))
            return (stack,)
        images, labels = [], []
        for i in ids:
            rng = self._rng(i)
            label = int(rng.integers(0, self._classes))
            noise = rng.standard_normal(
                (self._image_size, self._image_size, 3),
                dtype=np.float32)
            images.append(np.clip(
                self._protos[label] + 0.3 * noise, 0.0, 1.0))
            labels.append(label)
        if not images:
            s = self._image_size
            return (np.empty((0, s, s, 3), np.float32),
                    np.empty((0,), np.int32))
        return (np.stack(images), np.asarray(labels, np.int32))


def synthetic(kind: str = "image", n: int = 4096, **kwargs
              ) -> SyntheticSource:
    """The synthetic workload as a source (see :class:`SyntheticSource`)."""
    return SyntheticSource(kind, n, **kwargs)


def as_source(obj, length: Optional[int] = None):
    """Coerce the accepted source shapes:

      - an object with ``take``/``__len__`` passes through,
      - an array or tuple/list of arrays: :class:`ArraySource`,
      - a list of path strings: :class:`FileListSource`,
      - a callable plus ``length=``: :class:`CallableSource`.
    """
    if hasattr(obj, "take") and hasattr(obj, "__len__"):
        return obj
    if callable(obj):
        if length is None:
            raise ValueError(
                "a callable source needs length= (the loader must know "
                "the dataset size to build the epoch plan)")
        return CallableSource(obj, length)
    if isinstance(obj, (tuple, list)):
        if obj and isinstance(obj[0], (str, bytes)):
            return FileListSource(obj)
        return ArraySource(*obj)
    return ArraySource(obj)
