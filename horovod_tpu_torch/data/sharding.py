"""Deterministic epoch sharding, the math the input pipeline rests on.

The port's copy of ``horovod_tpu/data/sharding.py`` (pure numpy, so the
epoch plan is byte for byte JAX's for the same ``(n, seed, epoch)``).

Every rank derives the same epoch plan from ``(seed, epoch)`` alone: no
coordinator deals samples, and a relaunched worker reconstructs the plan
a dead one followed. The unit of dealing is the microbatch: the epoch
permutation of all ``n`` sample ids is cut into consecutive chunks of
``batch_size``; drop-remainder keeps the first ``n // batch_size``
chunks. A world of ``W`` ranks consumes ``W`` microbatches per global
step (rank ``r`` takes microbatch ``offset + r``), so the epoch's sample
multiset does not depend on the world size: a job that shrinks from 4
ranks to 1 mid-epoch still consumes microbatches ``offset..total`` once
each.

The permutation comes from numpy's PCG64 seeded with
``SeedSequence([seed, epoch])``: stable across processes, launches and
platforms for a fixed numpy, different per epoch, with no carried RNG
state (the cursor needs only ``(seed, epoch, offset)``).
"""

from __future__ import annotations

import numpy as np


def epoch_permutation(n: int, seed: int, epoch: int,
                      shuffle: bool = True) -> np.ndarray:
    """The epoch's sample-id order: a pure function of
    ``(n, seed, epoch)`` — every rank, every launch, every generation
    computes the identical array. ``shuffle=False`` is sequential order
    (still epoch-plan compatible: the cursor math is order-agnostic)."""
    if n < 0:
        raise ValueError(f"dataset length must be >= 0, got {n}")
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    rng = np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([int(seed), int(epoch)])))
    return rng.permutation(n).astype(np.int64)


def usable_samples(n: int, batch_size: int) -> int:
    """Drop-remainder sample count: whole microbatches only. Defined on
    ``(n, batch_size)`` alone — NOT on the world size — so the epoch's
    sample multiset survives elastic resizes."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be > 0, got {batch_size}")
    return (n // batch_size) * batch_size


def total_microbatches(n: int, batch_size: int) -> int:
    return usable_samples(n, batch_size) // batch_size


def microbatch_ids(perm: np.ndarray, index: int,
                   batch_size: int) -> np.ndarray:
    """Sample ids of microbatch ``index`` in the epoch permutation."""
    lo = index * batch_size
    return perm[lo:lo + batch_size]


def rank_microbatch(offset: int, rank: int, world_size: int,
                    total: int) -> int:
    """Microbatch index rank ``r`` consumes at global cursor ``offset``,
    or -1 when fewer than ``rank + 1`` microbatches remain (the rank
    receives a zero-weight filler batch that global step). All ranks
    advance the cursor identically by :func:`advance`."""
    m = offset + rank
    return m if m < total else -1


def advance(offset: int, world_size: int, total: int) -> int:
    """Next global cursor after one global step: ``offset + W`` capped
    at the epoch's end (the final step may consume fewer than ``W``
    microbatches; the filler ranks consumed nothing)."""
    return min(offset + world_size, total)
