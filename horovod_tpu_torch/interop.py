"""Carry flagship-transformer weights between the JAX package and the port.

The port keeps the JAX ``x @ W`` layout, so each leaf is a copy, never a
transpose. The JAX side is a tree of numpy arrays (``jax.device_get`` of
``init_params``'s output): ``{"embed", "pos", "ln_f", "layers": [...]}``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

_TOP = ("embed", "pos", "ln_f")


def params_from_jax(tree: Dict) -> "OrderedDict[str, torch.Tensor]":
    """A ``Transformer`` state_dict from a JAX parameter tree."""
    sd = OrderedDict()
    for name in _TOP:
        sd[name] = torch.from_numpy(np.array(tree[name], dtype=np.float32))
    for i, layer in enumerate(tree["layers"]):
        for name, leaf in layer.items():
            if isinstance(leaf, dict):
                raise NotImplementedError(
                    f"layer {i} holds a {name!r} subtree (MoE); not ported")
            sd[f"layers.{i}.{name}"] = torch.from_numpy(
                np.array(leaf, dtype=np.float32))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The inverse: a JAX-shaped tree of fp32 numpy arrays."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree = {name: arr(state_dict[name]) for name in _TOP}
    layers: Dict[int, Dict] = {}
    for key, t in state_dict.items():
        if key.startswith("layers."):
            _, idx, name = key.split(".", 2)
            layers.setdefault(int(idx), {})[name] = arr(t)
    tree["layers"] = [layers[i] for i in sorted(layers)]
    return tree
