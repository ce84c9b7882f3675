"""Per-leaf value fingerprints of a checkpoint manifest.

The port's copy of ``fingerprint_leaf`` and ``_sample_indices`` of
``horovod_tpu/observability/numerics.py`` (the port has no
``observability`` package yet). A fingerprint is ``[norm, crc, n]``:
the float64 L2 norm of the leaf's values, accumulated by numpy on the
host, the crc32 of the raw bytes of a seeded ``k``-element subsample,
and the element count. Restore compares the norm with ``!=``, so it
must be numpy's own sum in numpy's order: a bf16 leaf goes exactly to
float32 and then to numpy, and its subsample's bytes are its 2-byte
bits, as numpy with ``ml_dtypes`` holds them. Never ``torch.sum``,
which adds in another order.
"""

from __future__ import annotations

import zlib
from typing import List

import numpy as np
import torch

from .writer import RAW_DTYPES

FINGERPRINT_SAMPLE = 16  # elements hashed per leaf, as in the JAX package
_BITS = {v[1]: v[2] for v in RAW_DTYPES.values()}


def _sample_indices(name: str, n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(
        (zlib.crc32(name.encode()) ^ (seed & 0xFFFFFFFF)) & 0xFFFFFFFF)
    if n <= k:
        return np.arange(n)
    idx = rng.integers(1, n, size=k - 1)
    return np.concatenate(([0], idx))  # element 0 always sampled


def _host_flat(arr):
    """(values numpy can add, raw element bytes) of a leaf, flattened."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().reshape(-1).cpu()
        if t.dtype in _BITS:
            return t.float().numpy(), t.view(_BITS[t.dtype]).numpy()
        a = t.numpy()
        return a, a
    a = np.asarray(arr).reshape(-1)
    return a, a


def fingerprint_leaf(name: str, arr, *, k: int = FINGERPRINT_SAMPLE,
                     seed: int = 0) -> List:
    """``[norm, crc, n]`` digest of one leaf (a tensor on any device, a
    numpy array or a Python scalar). Two bitwise-identical leaves give
    identical digests; a single flipped mantissa bit changes the norm
    and, for element 0 or any sampled element, the crc."""
    values, raw = _host_flat(arr)
    if values.size == 0:
        return [0.0, 0, 0]
    norm = float(np.sqrt(np.sum(np.square(values.astype(np.float64)))))
    idx = _sample_indices(name, values.size, k, seed)
    crc = zlib.crc32(np.ascontiguousarray(raw[idx]).tobytes())
    return [norm, int(crc), int(values.size)]
