"""Restore side — checksum-verified shard reads and manifest resharding.

Counterpart of ``horovod_tpu/checkpoint/reader.py``. The core restore
primitive is :func:`read_block`: give it a manifest leaf entry and any
index block of that leaf, and it reads exactly the shard files whose
saved spans overlap the block, verifies each against its manifest
crc32, and assembles the requested region. That one function is what
makes restore *layout-free*: a rank restoring into a different process
count or mesh asks for its new blocks and the overlap math fetches the
right spans.

A block comes back as a numpy array, or as a CPU tensor for a dtype
numpy lacks without ``ml_dtypes`` (``bfloat16``: its ``'<V2'`` payload
viewed as 16-bit integers, then as ``torch.bfloat16``), so that the
port reads JAX's bf16 leaves with their bits and never asks numpy for a
bfloat16 dtype.

Corruption surfaces as the typed :exc:`CorruptShardError` (missing
file, byte-count mismatch, crc mismatch, undecodable payload) — the
engine catches it and falls back to the previous committed step.
"""

from __future__ import annotations

import io
import os
import re
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import manifest as _manifest
from .layout import (Index, LeafLayout, _children, full_index,
                     intersect_spans, relative_slices)
from .writer import RAW_DTYPES


class CorruptShardError(RuntimeError):
    """A shard file failed integrity verification against the manifest."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint shard {path}: {reason}")
        self.path = path
        self.reason = reason

    def __reduce__(self):
        return (type(self), (self.path, self.reason))


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of manifest dtype ``name`` is assembled
    in: itself, or for a dtype numpy lacks the integer type of its
    width."""
    if name in RAW_DTYPES:
        return np.dtype(RAW_DTYPES[name][3])
    return np.dtype(name)


def _finish(arr: np.ndarray, name: str):
    if name in RAW_DTYPES:
        return torch.from_numpy(arr).view(RAW_DTYPES[name][1])
    return arr


def load_shard(step_dir: str, shard_entry: dict) -> np.ndarray:
    """One shard file, crc32-verified against its manifest entry."""
    path = os.path.join(step_dir, shard_entry["file"])
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise CorruptShardError(path, "shard file missing")
    if len(data) != int(shard_entry["nbytes"]):
        raise CorruptShardError(
            path, f"size {len(data)} != manifest {shard_entry['nbytes']}")
    crc = f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    if crc != shard_entry["crc32"]:
        raise CorruptShardError(
            path, f"crc32 {crc} != manifest {shard_entry['crc32']}")
    try:
        return np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:
        raise CorruptShardError(path, f"undecodable payload: {e}")


def shards_overlapping(leaf_entry: dict, block: Index) -> List[dict]:
    """Manifest shard entries whose saved spans intersect ``block`` —
    the exact file set a resharded restore of that block must read."""
    out = []
    for shard_entry in leaf_entry["shards"]:
        if intersect_spans(_manifest.parse_index(shard_entry["index"]),
                           block) is not None:
            out.append(shard_entry)
    return out


def read_block(step_dir: str, leaf_entry: dict,
               block: Optional[Index] = None):
    """Assemble one index block of a leaf from overlapping shard files.

    ``block=None`` means the full leaf. Raises CorruptShardError on any
    bad shard, and ValueError if the saved shards do not cover the
    requested block (a manifest from an incompatible layout)."""
    shape = tuple(int(d) for d in leaf_entry["shape"])
    if block is None:
        block = full_index(shape)
    name = leaf_entry["dtype"]
    dtype = storage_dtype(name)
    out = np.empty(tuple(b - a for a, b in block), dtype=dtype)
    covered = 0
    for shard_entry in leaf_entry["shards"]:
        src_index = _manifest.parse_index(shard_entry["index"])
        inter = intersect_spans(src_index, block) if block else src_index
        if block and inter is None:
            continue
        data = load_shard(step_dir, shard_entry)
        if tuple(data.shape) != tuple(b - a for a, b in src_index):
            raise CorruptShardError(
                os.path.join(step_dir, shard_entry["file"]),
                f"shape {data.shape} != manifest span {src_index}")
        if data.dtype != dtype:
            if data.dtype.itemsize != dtype.itemsize:
                raise CorruptShardError(
                    os.path.join(step_dir, shard_entry["file"]),
                    f"payload dtype {data.dtype} is not {name}")
            data = data.view(dtype)
        if not block:  # 0-d leaf: single full shard
            return _finish(np.array(data, dtype=dtype).reshape(()), name)
        out[relative_slices(block, inter)] = \
            data[relative_slices(src_index, inter)]
        n = 1
        for a, b in inter:
            n *= b - a
        covered += n
    want = int(np.prod([b - a for a, b in block], dtype=np.int64)) \
        if block else 1
    if covered < want:
        raise ValueError(
            f"checkpoint shards cover {covered} of {want} elements of "
            f"{leaf_entry['key']!r} block {block} — incomplete layout")
    return _finish(out, name)


def as_tensor(value) -> torch.Tensor:
    """A block as a CPU tensor (a numpy block without a copy when it is
    writable)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _like(value, tmpl):
    """A restored leaf in the kind of its template leaf: a tensor on the
    template's device, a Python scalar of its type, else as read."""
    if isinstance(tmpl, torch.Tensor):
        return as_tensor(value).to(tmpl.device)
    if type(tmpl) in (bool, int, float, complex, str):
        return type(tmpl)(value.item())
    return value


def state_template(obj: Any) -> Any:
    """The restore template of a module's or optimizer's state: its
    ``state_dict()``, less an optimizer's per-parameter ``state`` (made
    at its first step: a commit's is taken whole, whatever the object
    holds now, through ``read_tree(..., grow=True)``)."""
    sd = obj.state_dict()
    if isinstance(sd, dict) and "state" in sd and "param_groups" in sd:
        sd = dict(sd, state={})
    return sd


def _parts(key: str) -> List[str]:
    return [m.group(0) for m in _PART_RE.finditer(key)]


def read_tree(step_dir: str, man: dict, template: Any = None, *,
              layouts: Optional[Dict[str, LeafLayout]] = None,
              grow: bool = False,
              verify: Optional[Callable[[str, Any], None]] = None) -> Any:
    """Restore every leaf, rebuilt into a tree.

    With ``template`` (a tree of dicts, lists, tuples and named tuples,
    such as a ``state_dict``), leaves are matched by key string and the
    result has the template's structure, each leaf in its template
    leaf's kind (a tensor on its device, a Python scalar). A live
    module or optimizer stands for its :func:`state_template` (with
    ``grow``): the result is what its ``load_state_dict`` takes.
    Without a template, the structure is rebuilt from the manifest keys
    (dicts and lists).

    ``layouts`` names the leaves sharded across processes: each is read
    as this process's block (``LeafLayout.held``), and its saved global
    shape must be the layout's. ``grow=True`` adds the manifest's
    subtrees that a dict of the template lacks, as CPU tensors: a fresh
    ``torch.optim`` optimizer has no state until its first step.
    ``verify(key, value)`` sees every leaf read whole."""
    entries = {e["key"]: e for e in man["leaves"]}
    layouts = layouts or {}

    def value(key):
        entry = entries[key]
        ll = layouts.get(key)
        block = None
        if ll is not None and not ll.replicated:
            saved = tuple(int(d) for d in entry["shape"])
            if saved != tuple(ll.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} was saved with global shape "
                    f"{saved}; this layout expects {tuple(ll.shape)} "
                    "(it was sharded for another layout: a ZeRO-1 state's "
                    "flat leaves are padded for its 'dp' size)")
            block = ll.held
        out = read_block(step_dir, entry, block or None)
        if verify is not None and (block is None
                                   or block == full_index(ll.shape)):
            verify(key, out)
        return out

    if template is None:
        return rebuild_tree({k: value(k) for k in entries})
    used = set()

    def fill(node, key, grow):
        if hasattr(node, "state_dict"):
            node, grow = state_template(node), True
        kids = _children(node)
        if kids is None:
            if key not in entries:
                raise KeyError(
                    f"checkpoint has no leaf {key!r}; manifest holds "
                    f"{sorted(entries)[:8]}...")
            used.add(key)
            return _like(value(key), node)
        if node is None:
            return None
        if isinstance(node, dict):
            out = node.copy()
            for k, child in node.items():
                out[k] = fill(child, key + f"[{k!r}]", grow)
            if grow:
                own = {part for part, _ in kids}
                extra: Dict[Any, Dict[str, Any]] = {}
                for k in entries:
                    if k in used or not k.startswith(key):
                        continue
                    parts = _parts(k[len(key):])
                    if not parts or parts[0] in own:
                        continue
                    m = _PART_RE.match(parts[0])
                    name = m.group(1) if m.group(1) is not None \
                        else int(m.group(2))
                    extra.setdefault(name, {})[
                        "".join(parts[1:])] = as_tensor(value(k))
                    used.add(k)
                for name, sub in extra.items():
                    out[name] = sub[""] if "" in sub else rebuild_tree(sub)
            return out
        values = [fill(child, key + part, grow) for part, child in kids]
        if hasattr(type(node), "_fields"):
            return type(node)(*values)
        return type(node)(values)

    out = fill(template, "", grow)
    left = set(entries) - used
    if left:
        raise KeyError(
            f"checkpoint leaves {sorted(left)[:8]} missing from the "
            "restore template")
    return out


_PART_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def rebuild_tree(by_key: Dict[str, np.ndarray]) -> Any:
    """Rebuild nested dicts/lists from tree-path keys (templateless
    restore). Attribute paths (``.field`` — NamedTuples, custom nodes)
    need a template: the manifest records no class to rebuild."""
    root: Dict[Any, Any] = {}
    for key, value in by_key.items():
        parts = []
        pos = 0
        for m in _PART_RE.finditer(key):
            if m.start() != pos:
                raise ValueError(
                    f"cannot rebuild pytree node for leaf {key!r} "
                    "without a template (pass template= to restore — "
                    "required for NamedTuple/custom-node states)")
            parts.append(m.group(1) if m.group(1) is not None
                         else int(m.group(2)))
            pos = m.end()
        if pos != len(key) or not parts:
            raise ValueError(
                f"cannot rebuild pytree node for leaf {key!r} without "
                "a template (pass template= to restore)")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node: Any) -> Any:
    """Integer-keyed dicts back into lists (list/tuple tree nodes round-
    trip as lists — tuple-ness is not recorded in the manifest)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) == list(range(len(out))):
            return [out[i] for i in range(len(out))]
    return out
