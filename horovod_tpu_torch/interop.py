"""Carry weights between the JAX package and the port.

The flagship transformer keeps the JAX ``x @ W`` layout, so each leaf is
a copy, never a transpose. The JAX side is a tree of numpy arrays
(``jax.device_get`` of ``init_params``'s output): ``{"embed", "pos",
"ln_f", "layers": [...]}``, a MoE layer with a ``moe`` subtree
(``router``, ``wi``, ``wo``). Under tensor or expert parallelism
:func:`shard_from_jax` gives one rank's slice of it, the block that
JAX's ``NamedSharding`` under ``param_specs`` puts on the device at the
same mesh coordinate. A tree in JAX's pipeline layout (its
``to_pipeline_params``) gives each 'pp' rank's ``PipelineModel`` state
(:func:`pipeline_from_jax`), and every rank's state gathers back into it
bit for bit (:func:`pipeline_to_jax`).

The ResNet takes PyTorch's layouts: a conv kernel goes from HWIO to
OIHW, the head's Dense kernel from ``[in, out]`` to ``[out, in]``; BN
``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats) are
copied as they are. The nested flax names join with dots
(``stage1_block1/conv1/kernel`` is ``stage1_block1.conv1.weight``).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from .parallel.mesh import shard_tensor, spec_of

_TOP = ("embed", "pos", "ln_f")


def params_from_jax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """A ``Transformer`` state_dict from a JAX parameter tree; a layer's
    subtree (a MoE's ``moe``) joins its names with dots
    (``layers.1.moe.wi``)."""
    sd = OrderedDict()
    for name in _TOP:
        sd[name] = torch.from_numpy(np.array(tree[name], dtype=np.float32))
    for i, layer in enumerate(tree["layers"]):
        for name, arr in _flat(layer, f"layers.{i}."):
            sd[name] = torch.from_numpy(np.array(arr))
    return sd


def shard_from_jax(tree: Dict, cfg, sizes: Dict[str, int],
                   coords: Dict[str, int]
                   ) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of the ``Transformer`` shard at mesh coordinate
    ``coords`` (axis sizes ``sizes``; ``parallel.mesh.place(mesh)`` gives
    both for this rank) from a global JAX parameter tree, cut under
    ``param_specs(cfg)``."""
    from .models.transformer import param_specs
    specs = param_specs(cfg)
    return OrderedDict(
        (key, shard_tensor(t, spec_of(specs, key), sizes, coords))
        for key, t in params_from_jax(tree).items())


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The inverse: a JAX-shaped tree of fp32 numpy arrays."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree = {name: arr(state_dict[name]) for name in _TOP}
    layers: Dict[int, Dict] = {}
    for key, t in state_dict.items():
        if key.startswith("layers."):
            _, idx, *path, leaf = key.split(".")
            node = layers.setdefault(int(idx), {})
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = arr(t)
    tree["layers"] = [layers[i] for i in sorted(layers)]
    return tree


def pipeline_from_jax(tree: Dict, rank: int
                      ) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of rank ``rank``'s ``PipelineModel``
    (``parallel.train``) from a tree in JAX's pipeline layout (JAX's
    ``to_pipeline_params``: ``{"embed", "pos", "ln_f", "stages"}``, each
    stages leaf ``[n_pp, V, layers_per_chunk, ...]``):
    ``chunks.{v}.{i}.{key}`` is ``stages[key][rank, v, i]``."""
    sd = OrderedDict()
    for name in _TOP:
        sd[name] = torch.from_numpy(np.array(tree[name], dtype=np.float32))
    stages = {k: np.asarray(a, dtype=np.float32)
              for k, a in tree["stages"].items()}
    _, n_virtual, lpc = next(iter(stages.values())).shape[:3]
    for v in range(n_virtual):
        for i in range(lpc):
            for key, arr in stages.items():
                sd[f"chunks.{v}.{i}.{key}"] = torch.from_numpy(
                    np.array(arr[rank, v, i]))
    return sd


def pipeline_to_jax(state_dicts) -> Dict:
    """The inverse: JAX's pipeline layout (fp32 numpy) from every rank's
    ``PipelineModel`` state_dict, in rank order; ``embed``, ``pos`` and
    ``ln_f`` from rank 0's."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree = {name: arr(state_dicts[0][name]) for name in _TOP}
    blocks: Dict[str, Dict] = {}
    for key, t in state_dicts[0].items():
        if key.startswith("chunks."):
            _, v, i, leaf = key.split(".")
            blocks.setdefault(leaf, {})[(int(v), int(i))] = key
    stages = {}
    for leaf, keys in blocks.items():
        n_virtual = 1 + max(v for v, _ in keys)
        lpc = 1 + max(i for _, i in keys)
        stages[leaf] = np.stack([
            np.stack([np.stack([arr(sd[keys[(v, i)]]) for i in range(lpc)])
                      for v in range(n_virtual)])
            for sd in state_dicts])
    tree["stages"] = stages
    return tree


def _flat(tree: Dict, prefix: str = ""):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(val, dtype=np.float32)


def resnet_variables_from_jax(params: Dict, batch_stats: Dict
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A ``ResNet`` state_dict from the JAX model's ``params`` and
    ``batch_stats`` trees."""
    sd = OrderedDict()
    for key, arr in itertools.chain(_flat(params), _flat(batch_stats)):
        if key.endswith(".kernel"):
            key = key[:-len("kernel")] + "weight"
            arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
        sd[key] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def resnet_variables_to_jax(state_dict: Dict[str, torch.Tensor]):
    """The inverse: ``(params, batch_stats)`` trees of fp32 numpy arrays."""
    params: Dict = {}
    batch_stats: Dict = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        *path, leaf = key.split(".")
        tree = batch_stats if leaf in ("mean", "var") else params
        if leaf == "weight":
            leaf = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = np.ascontiguousarray(arr)
    return params, batch_stats
