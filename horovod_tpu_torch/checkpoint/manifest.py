"""Checkpoint manifest — the commit record that makes a step restorable.

Counterpart of ``horovod_tpu/checkpoint/manifest.py``, the same format
and schema, so that either package restores the other's commits.

A committed step is a directory ``<root>/step-<N>/`` holding shard files
plus one ``manifest.json``, and the commit *point* is the atomic flip of
``<root>/LATEST`` to that directory's name. The manifest is written by
rank 0 only, strictly after every rank's shards (and their crc32
sidecars) are durably on disk — so the existence of a manifest certifies
a complete step, and the LATEST pointer certifies a complete *commit*.
Restore never trusts anything else: shard files without a manifest are
an aborted save; a manifest LATEST does not name is merely history.

Schema (JSON, no pickle anywhere in the metadata path)::

    {
      "format": "horovod_tpu.checkpoint/1",
      "step": 70,
      "process_count": 4,            # writers at save time
      "mesh_axes": {"dp": 8},        # informational, from the engine
      "leaves": [
        {"key": "['params']['w']",   # jax.tree_util.keystr address
         "shape": [64, 64], "dtype": "float32", "replicated": false,
         "shards": [{"file": "L00000.S000.npy",
                     "index": [[0, 16], [0, 64]],
                     "process": 0, "crc32": "9a0b...", "nbytes": 4096},
                    ...]},
        ...
      ],
      "extra": {...},                # JSON-able caller payload
      "fingerprints": {              # per-leaf VALUE digests
        "['params']['w']": [12.5, 317488301, 4096],   # [norm, crc, n]
        ...                          # (docs/numerics.md#checkpoint)
      }
    }

``key`` uses the tree-path string so restore can address leaves of any
pytree via a template; trees made of dicts/lists/tuples also rebuild
without one (reader.rebuild_tree).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from .layout import Index, LeafLayout, Shard

FORMAT = "horovod_tpu.checkpoint/1"
MANIFEST = "manifest.json"
LATEST = "LATEST"
_STEP_RE = re.compile(r"^step-(\d+)$")


def step_dirname(step: int) -> str:
    return f"step-{int(step)}"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, step_dirname(step))


def shard_filename(leaf_idx: int, shard_idx: int) -> str:
    """Deterministic per-(leaf, shard) name every process computes
    identically from the shared layout — no naming coordination."""
    return f"L{leaf_idx:05d}.S{shard_idx:03d}.npy"


def list_steps(root: str) -> List[int]:
    """Committed steps (directories with a manifest), ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def read_latest(root: str) -> Optional[int]:
    """Step the LATEST pointer names, or None before any commit."""
    path = os.path.join(root, LATEST)
    try:
        with open(path) as f:
            content = f.read().strip()
    except FileNotFoundError:
        return None
    m = _STEP_RE.match(content)
    if m:
        return int(m.group(1))
    return int(content)


def manifest_dict(step: int, process_count: int,
                  layouts: Dict[str, LeafLayout],
                  shard_meta: Dict[str, List[dict]],
                  mesh_axes: Optional[Dict[str, int]] = None,
                  extra: Optional[dict] = None,
                  fingerprints: Optional[Dict[str, list]] = None) -> dict:
    """Assemble the manifest from layouts + per-shard file metadata
    (``shard_meta[key][shard_idx]`` = {"file", "crc32", "nbytes"}).

    ``fingerprints`` maps leaf key -> ``[norm, crc, n]`` value digests
    (``fingerprint.fingerprint_leaf``, docs/numerics.md#checkpoint):
    where the per-shard crc32 certifies the BYTES of each file, the
    fingerprint certifies the assembled leaf VALUES — restore recomputes
    and raises CorruptShardError on mismatch, catching corruption that
    happened before serialization (e.g. an in-memory bitflip the shard
    crc faithfully preserved)."""
    leaves = []
    for key, ll in layouts.items():
        shards = []
        for j, shard in enumerate(ll.shards):
            meta = shard_meta[key][j]
            shards.append({
                "file": meta["file"],
                "index": [[a, b] for a, b in shard.index],
                "process": shard.process,
                "crc32": meta["crc32"],
                "nbytes": meta["nbytes"],
            })
        leaves.append({"key": key, "shape": list(ll.shape),
                       "dtype": ll.dtype, "replicated": ll.replicated,
                       "shards": shards})
    man = {"format": FORMAT, "step": int(step),
           "process_count": int(process_count),
           "mesh_axes": dict(mesh_axes or {}),
           "leaves": leaves, "extra": extra if extra is not None else {}}
    if fingerprints is not None:
        man["fingerprints"] = {
            k: [float(v[0]), int(v[1]), int(v[2])]
            for k, v in fingerprints.items()}
    return man


def parse_index(entry: List[List[int]]) -> Index:
    return tuple((int(a), int(b)) for a, b in entry)


def leaf_entry_layout(entry: dict) -> LeafLayout:
    """LeafLayout back out of a manifest leaf entry (restore side)."""
    return LeafLayout(
        shape=tuple(int(d) for d in entry["shape"]),
        dtype=entry["dtype"],
        shards=tuple(Shard(index=parse_index(s["index"]),
                           process=int(s["process"]))
                     for s in entry["shards"]),
        replicated=bool(entry["replicated"]))


def read_manifest(root: str, step: int) -> dict:
    path = os.path.join(step_dir(root, step), MANIFEST)
    with open(path) as f:
        data = json.load(f)
    if data.get("format") != FORMAT:
        raise ValueError(
            f"unsupported checkpoint manifest format "
            f"{data.get('format')!r} at {path}")
    return data


def dumps(manifest: dict) -> bytes:
    return (json.dumps(manifest, indent=1, sort_keys=True) + "\n").encode()
