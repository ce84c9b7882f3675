"""Checkpoint -> serving loader: the "save" half of train -> save -> serve.

Counterpart of ``horovod_tpu/serving/loader.py``, on the port's
``CheckpointEngine.restore_addressable``. A trainer commits its
parameters through the sharded checkpoint engine with
``extra=transformer_extra(cfg)``, and the server rebuilds the config
from the manifest (:func:`config_from_manifest`) and reads only the
shard-file spans of this rank's blocks under the *serving* layout
(:func:`load_params`), whatever mesh the commit was saved from.

The manifest's ``extra`` is the same JSON in both packages (the 19
``TransformerConfig`` fields, ``dtype`` by its numpy name), so a commit
of either package serves in the other: JAX's params tree at the root
(``key_prefix=""``), and a torch save hook's ``{"model": ...}`` commit
under :data:`TORCH_MODEL_PREFIX`. Under the prefix the port reads the
tree's keys (``['model']['layers'][0]['wq']``, what JAX's loader reads
too) or, for a commit of ``Transformer.state_dict()``, its dotted keys
(``['model']['layers.0.wq']``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..checkpoint import CheckpointEngine
from ..checkpoint.layout import LeafLayout, Shard, full_index
from ..checkpoint.reader import as_tensor
from ..models import transformer as tfm
from ..parallel.collectives import axis_size
from ..parallel.mesh import spec_layout
from ..topology import resolve_device

# Manifest ``extra`` key under which trainers record the architecture.
CONFIG_EXTRA_KEY = "transformer_config"

# Where a torch save hook roots the model tree in its checkpoint: leaf
# keys ``['model']['embed']...``; the optimizer subtree is skipped.
TORCH_MODEL_PREFIX = "['model']"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def transformer_extra(cfg: tfm.TransformerConfig) -> dict:
    """The JSON ``extra`` of ``CheckpointEngine.save`` from which the
    server rebuilds ``cfg`` (``n_heads`` explicit; ``dtype`` by numpy
    name, as the JAX package writes it)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return {CONFIG_EXTRA_KEY: d}


def config_from_manifest(man: dict, **overrides: Any
                         ) -> tfm.TransformerConfig:
    """The training ``TransformerConfig`` from a manifest saved with
    :func:`transformer_extra` (by either package); ``overrides`` replace
    fields."""
    extra = man.get("extra") or {}
    if CONFIG_EXTRA_KEY not in extra:
        raise KeyError(
            f"manifest extra has no {CONFIG_EXTRA_KEY!r} entry — save "
            "with extra=transformer_extra(cfg) (docs/serving.md) or "
            "pass the config explicitly")
    d = dict(extra[CONFIG_EXTRA_KEY])
    name = d.get("dtype", "float32")
    if name not in _DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {name!r}")
    d["dtype"] = _DTYPES[name]
    d.update(overrides)
    return tfm.TransformerConfig(**d)


def serving_config(cfg: tfm.TransformerConfig,
                   mesh: Optional[DeviceMesh] = None
                   ) -> tfm.TransformerConfig:
    """The inference variant of a training config: tensor parallelism
    follows the serving mesh's 'tp' axis (none without a mesh),
    sequence and expert axes are dropped, remat is off."""
    tp = None
    if mesh is not None and "tp" in mesh.mesh_dim_names \
            and axis_size(mesh, "tp") > 1:
        tp = "tp"
    return dataclasses.replace(cfg, tp_axis=tp, sp_axis=None,
                               ep_axis=None, num_experts=0, remat=False)


def _spec_by_key(cfg: tfm.TransformerConfig) -> Dict[str, tuple]:
    """``{leaf keystr: partition spec}`` of the parameter tree, keyed as
    JAX's ``keystr`` names the leaves of a tree."""
    out: Dict[str, tuple] = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{key}[{k!r}]")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}[{i}]")
        else:
            out[key] = node

    walk(tfm.param_specs(cfg), "")
    return out


def _dotted(spec_key: str) -> str:
    """``['layers'][0]['wq']`` as a ``state_dict`` key's leaf key,
    ``['layers.0.wq']``."""
    parts = spec_key[1:-1].split("][")
    return "[" + repr(".".join(p.strip("'") for p in parts)) + "]"


def target_layouts(cfg: tfm.TransformerConfig, man: dict,
                   mesh: Optional[DeviceMesh] = None, *,
                   key_prefix: str = ""
                   ) -> Tuple[Dict[str, LeafLayout], Dict[str, str]]:
    """``(layouts, names)``: the target :class:`LeafLayout` of each
    parameter on the serving mesh, keyed by its manifest key, from
    ``param_specs`` and the manifest's shapes (no tensor made), and the
    parameter tree key each manifest key fills.

    ``key_prefix`` selects a subtree (:data:`TORCH_MODEL_PREFIX`); other
    leaves are skipped. Without a prefix an unknown leaf raises: this
    is not the flagship's parameter tree."""
    by_key = _spec_by_key(cfg)
    wanted = {}
    for spec_key in by_key:
        wanted[key_prefix + spec_key] = spec_key
        if key_prefix:
            wanted[key_prefix + _dotted(spec_key)] = spec_key
    layouts: Dict[str, LeafLayout] = {}
    names: Dict[str, str] = {}
    for entry in man["leaves"]:
        key = entry["key"]
        if key not in wanted:
            if key_prefix:
                continue   # outside the model subtree (optimizer...)
            raise KeyError(
                f"checkpoint leaf {key!r} has no param_specs entry — "
                "is this checkpoint the flagship transformer's params "
                f"tree? (specs hold {sorted(by_key)[:4]}...)")
        spec_key = wanted[key]
        shape = tuple(int(d) for d in entry["shape"])
        spec = by_key[spec_key]
        if mesh is None or not any(spec):
            layouts[key] = LeafLayout(
                shape=shape, dtype=entry["dtype"],
                shards=(Shard(index=full_index(shape), process=0),),
                replicated=True)
        else:
            layouts[key] = spec_layout(shape, entry["dtype"], spec, mesh)
        names[key] = spec_key
    return layouts, names


def load_params(directory: str, cfg: tfm.TransformerConfig,
                mesh: Optional[DeviceMesh] = None, *,
                step: Optional[int] = None,
                engine: Optional[CheckpointEngine] = None,
                key_prefix: str = "",
                device: Union[str, torch.device, None] = None) -> Dict:
    """This rank's parameter tree (``init_params``' structure) on
    ``device`` (CUDA unless "cpu" is passed), read from a committed
    sharded checkpoint by span-overlap reads only (under a tp ``mesh``,
    this rank's column and row blocks), so the save-time mesh never has
    to match the serving one. Pass it to ``Transformer(cfg,
    params=..., mesh=mesh)``.

    ``engine`` keeps the caller's fallback and process settings (one is
    built over ``directory`` by default); ``key_prefix`` roots the read
    in a subtree (:data:`TORCH_MODEL_PREFIX` for a torch save hook's
    commit)."""
    dev = resolve_device(device)
    eng = engine if engine is not None else CheckpointEngine(directory)
    man = eng.restore_manifest(step)
    layouts, names = target_layouts(cfg, man, mesh, key_prefix=key_prefix)
    missing = sorted(set(_spec_by_key(cfg)) - set(names.values()))
    if missing:
        raise KeyError(
            f"checkpoint step {man['step']} is missing param leaves "
            f"{[key_prefix + k for k in missing[:4]]}"
            f"{'...' if len(missing) > 4 else ''}")
    blocks = eng.restore_addressable(layouts, man["step"])
    flat = {}
    for key, ll in layouts.items():
        for shard, arr in blocks[key]:
            if ll.replicated or shard.index == ll.held:
                flat[names[key]] = as_tensor(arr).to(dev)
    return _fill(tfm.param_specs(cfg), "", flat)


def _fill(node, key, flat):
    """The spec tree's structure with each spec replaced by its tensor."""
    if isinstance(node, dict):
        return {k: _fill(v, f"{key}[{k!r}]", flat) for k, v in node.items()}
    if isinstance(node, list):
        return [_fill(v, f"{key}[{i}]", flat) for i, v in enumerate(node)]
    return flat[key]
