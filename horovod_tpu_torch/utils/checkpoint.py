"""Checkpoint convention helpers — rank-0 save, broadcast-on-restore.

Counterpart of ``horovod_tpu/utils/checkpoint.py``: Horovod's
convention, save on rank 0 only and broadcast the state on (re)start,
as one call each. The file is one pickle of the state with every tensor
copied to the host (CPU tensors; numpy arrays stay numpy arrays), so it
reads back at any number of processes. This format is the port's own;
the sharded engine's (``checkpoint/``) is the one both packages read.

.. warning::
   Pickle executes code during deserialization. Only restore checkpoints
   you trust: loading a file from an untrusted path is arbitrary code
   execution on every rank (``restore_checkpoint`` broadcasts the loaded
   object, re-pickling it across the ranks).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from .. import topology as _topo
from ..checkpoint.writer import fsync_dir


def _file(path: str, step: Optional[int]) -> str:
    if step is not None:
        if path.endswith(".pkl"):
            raise ValueError(
                "pass a directory path with step= (a '.pkl' file path "
                "plus a step would create a directory named like a file)")
        return os.path.join(path, f"{step}.pkl")
    return path if path.endswith(".pkl") else path + ".pkl"


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to a CPU tensor and every numpy
    array copied, through dicts, lists and tuples (named tuples too);
    other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        out = tree.copy()
        for k, v in tree.items():
            out[k] = host_copy(v)
        return out
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(host_copy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _rank_and_size():
    if not _topo.is_initialized():
        return 0, 1
    return _topo.rank(), _topo.size()


def save_checkpoint(state: Any, path: str,
                    *, step: Optional[int] = None) -> Optional[str]:
    """Write ``state`` (a tree of tensors, arrays and Python values) to
    ``path`` from rank 0 only, atomically and durably.

    Returns the written file on rank 0, None elsewhere. Other ranks do
    not wait — pair a later restore with the broadcast this module does,
    or allreduce a dummy as a barrier if you need one.
    """
    if _rank_and_size()[0] != 0:
        return None
    target = _file(path, step)
    parent = os.path.dirname(os.path.abspath(target))
    if parent:
        os.makedirs(parent, exist_ok=True)
    # A crash mid-write must never truncate the previous copy, and the
    # rename alone is not enough: the data is fsynced before the
    # replace and the directory entry after.
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host_copy(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    fsync_dir(parent)
    return target


def restore_checkpoint(path: str, *, step: Optional[int] = None,
                       broadcast: bool = True) -> Any:
    """Load a checkpoint and (by default) broadcast it from rank 0 so
    every rank resumes from identical state. Only rank 0 needs the file;
    with ``broadcast=False`` every caller reads locally. A load error on
    rank 0 is shipped, so every rank raises.

    .. warning::
       The file is unpickled: restoring a checkpoint from an untrusted
       source is arbitrary code execution."""
    rank, size = _rank_and_size()
    state = None
    err: Optional[str] = None
    if rank == 0 or not broadcast:
        try:
            with open(_file(path, step), "rb") as f:
                state = pickle.load(f)
        except Exception as e:
            if not broadcast or size == 1:
                raise
            # The other ranks are (or will be) blocked in the broadcast;
            # ship the failure so the job dies loudly on EVERY rank.
            err = f"{type(e).__name__}: {e}"
    if not broadcast or size == 1:
        return state
    from ..optimizer import broadcast_object
    payload = broadcast_object({"state": state, "error": err}, root_rank=0,
                               name="restore_checkpoint")
    if payload["error"] is not None:
        raise RuntimeError(
            f"rank 0 failed to load checkpoint {path!r}: "
            f"{payload['error']}")
    return payload["state"]
