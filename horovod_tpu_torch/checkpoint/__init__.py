"""Sharded async checkpoint engine.

Counterpart of ``horovod_tpu/checkpoint``, on the same on-disk format:
per-process sharded save (ZeRO-1 state never transits one host), async
background writes, two-phase crash-atomic commit, and manifest-driven
resharded restore. A tree saved here and the same tree saved by the
JAX engine give the same files, and either package restores the
other's commits.

    engine = CheckpointEngine("/nfs/job/ckpt")
    engine.save({"model": model.state_dict()}, step)   # after the copy
    ...
    tree = engine.restore()
    model.load_state_dict(tree["model"])
"""

from .engine import CheckpointEngine, SaveHandle
from .fingerprint import fingerprint_leaf
from .hook import checkpoint_hook
from .layout import (LeafLayout, Shard, leaf_layout, sharded_layout,
                     tree_keys, tree_layout)
from .manifest import list_steps, read_latest, read_manifest
from .reader import CorruptShardError, read_block, read_tree
from .writer import AsyncWriter, atomic_write_bytes, fsync_dir

__all__ = [
    "AsyncWriter", "CheckpointEngine", "CorruptShardError", "LeafLayout",
    "SaveHandle", "Shard", "atomic_write_bytes", "checkpoint_hook",
    "fingerprint_leaf", "fsync_dir", "leaf_layout", "list_steps",
    "read_block", "read_latest", "read_manifest", "read_tree",
    "sharded_layout", "tree_keys", "tree_layout",
]
