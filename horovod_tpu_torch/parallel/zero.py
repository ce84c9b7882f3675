"""ZeRO-1: the optimizer's state sharded over the data axis.

Counterpart of ``horovod_tpu/parallel/zero.py``. Each parameter's
optimizer state lives as 1/dp flat shards over 'dp': the gradients
arrive by ``psum_scatter`` (the sum over 'dp' and the cut in one
collective), each rank's inner optimizer steps only its shard, and the
updated shards come back to every rank by ``all_gather``.

Layout, JAX's. A parameter whose spec splits it over model axes of
combined size m (tp or ep blocks) holds ``local = numel / m`` elements
on each rank, padded to ``padded_local``, a multiple of dp. JAX's
state leaf is the flat vector of ``m * padded_local`` elements sharded
over ``(model axes..., 'dp')``: each model shard owns one contiguous
``padded_local`` block, split contiguously over 'dp' in the block order
of a tiled ``psum_scatter``. So this rank's shard is elements
``[i * padded_local / dp, (i + 1) * padded_local / dp)`` of its own
parameter block flattened and zero-padded, i its 'dp' coordinate: what
:class:`Zero1Optimizer` keeps, and what :func:`zero1_state_specs` gives
the shape of. (``torch.distributed.optim.ZeroRedundancyOptimizer``
gives whole parameters to ranks instead, another layout.)

The inner optimizer is any ``torch.optim`` optimizer that works element
by element per parameter (SGD, momentum, Adam, AdamW, RMSprop): it
steps fp32 flat "shadow" shards, whose ``.grad`` is the gradient shard.
A global-norm clip needs the whole gradient and goes outside.

Checkpoints: :meth:`Zero1Optimizer.state_dict` holds this rank's flat
shadow shards and the inner optimizer's state over them, and
:meth:`Zero1Optimizer.checkpoint_layouts` the layout of each flat leaf
in JAX's global form (``[m * padded_local]``, this rank's block of it
``[(b * dp + i) * w, (b * dp + i + 1) * w)``, b its model block and
``w = padded_local / dp``): the sharded checkpoint engine writes one
shard per rank and reassembles the padded leaf at any process count.
``load_state_dict`` refuses a state padded for another 'dp' size, as
JAX's step does: re-cutting it would be a feature JAX lacks.

Use (``MeshTrainStep`` takes the ZeRO-1 path when it is handed a
:class:`Zero1Optimizer`)::

    step = build_train_step(cfg, factory, mesh=create_mesh(dp=4))
    model = step.make_model()
    opt = step.make_optimizer(model, zero1=True)   # or zero1_init(...)
    loss = step(model, opt, tokens, targets)
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..checkpoint.layout import dtype_name
from .collectives import (all_gather, chunk_major, psum_scatter,
                          split_chunk_major)
from .mesh import Spec, place, spec_axes, spec_layout


def _spec_axes_ordered(spec: Spec) -> List[str]:
    """The axis names a spec splits over, in order."""
    return list(spec_axes(spec))


def _padded_size(n_elem: int, n_shards: int) -> int:
    return ((n_elem + n_shards - 1) // n_shards) * n_shards


def _model_factor(spec: Spec, mesh: DeviceMesh) -> int:
    """The product of the sizes of the axes ``spec`` splits over."""
    sizes = place(mesh)[0]
    return math.prod(sizes[a] for a in spec_axes(spec))


def _flat_pad(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, _padded_size(flat.numel(), n_shards)
                        - flat.numel()))


class Zero1Optimizer:
    """The ZeRO-1 wrapper: the inner optimizer over this rank's flat fp32
    shadow shards of ``params`` (each rank's own blocks of them).
    ``n_shards`` records the 'dp' size the layout was built for.

    :meth:`step` expects each parameter's gradient reduced over every
    mesh axis except ``axis`` (``reduce_gradients(..., skip=("dp",))``):
    it sums and cuts them over ``axis`` in one ``psum_scatter``, steps
    the inner optimizer, and writes the ``all_gather`` of the updated
    shards into the parameters."""

    def __init__(self, inner: torch.optim.Optimizer,
                 params: List[nn.Parameter], shadows: List[torch.Tensor],
                 n_shards: int, mesh: DeviceMesh, axis: str, index: int,
                 specs: Optional[Sequence[Spec]] = None):
        self.inner = inner
        self.params = params
        self.shadows = shadows
        self.n_shards = n_shards
        self.mesh = mesh
        self.axis = axis
        self.index = index
        # Each parameter's partition spec (() for a replicated one): its
        # model axes size and place its flat state leaf's blocks.
        self.specs = list(specs) if specs is not None else \
            [()] * len(params)

    @property
    def state(self):
        """The inner optimizer's state, keyed by the shadow shards."""
        return self.inner.state

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    # ------------------------------------------------------ checkpoints

    def state_dict(self) -> Dict:
        """This rank's state: the 'dp' size it was padded for, the inner
        optimizer's ``param_groups`` and per-shadow ``state`` (keyed by
        the shadow's index), and the flat shadow shards."""
        inner = self.inner.state_dict()
        return {"n_shards": self.n_shards,
                "param_groups": inner["param_groups"],
                "shadows": [s.detach() for s in self.shadows],
                "state": inner["state"]}

    def load_state_dict(self, state: Dict) -> None:
        """Load a :meth:`state_dict` of this rank's blocks, in place."""
        n = int(state["n_shards"])
        if n != self.n_shards:
            raise ValueError(
                f"the ZeRO-1 state was built for n_shards={n} but this "
                f"optimizer shards over {self.n_shards}; the flat-shard "
                "padding depends on the shard count, so a state restores "
                "only at the 'dp' size it was saved at")
        shadows = list(state["shadows"])
        blocks = [(shadows[i], i) for i in range(len(shadows))] + [
            (v, int(i)) for i, st in state["state"].items()
            for v in st.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0]
        for v, i in blocks:
            want = tuple(self.shadows[i].shape) \
                if i < len(self.shadows) else None
            if tuple(v.shape) != want:
                raise ValueError(
                    f"a ZeRO-1 state block of shape {tuple(v.shape)} for "
                    f"shadow {i} of shape {want}: the state was padded "
                    "for another layout")
        with torch.no_grad():
            for shadow, v in zip(self.shadows, shadows):
                shadow.copy_(v)
        self.inner.load_state_dict({"state": state["state"],
                                    "param_groups": state["param_groups"]})

    def _flat_layout(self, i: int, dtype: str):
        """The checkpoint layout of shadow ``i``'s flat state leaf."""
        spec = self.specs[i]
        m = _model_factor(spec, self.mesh)
        length = m * _padded_size(self.params[i].numel(), self.n_shards)
        return spec_layout((length,), dtype,
                           (tuple(spec_axes(spec)) + (self.axis,),),
                           self.mesh)

    def checkpoint_layouts(self, shapes: Optional[Dict[str, tuple]] = None
                           ) -> Dict:
        """``{key in state_dict(): LeafLayout}`` of the flat leaves split
        across ranks: each shadow and each inner state tensor of a
        shadow's shape. ``shapes`` (a commit's ``{key: global shape}``)
        adds the state leaves a fresh inner optimizer does not hold yet:
        its state is made at its first step."""
        out = {}
        for i, s in enumerate(self.shadows):
            out[f"['shadows'][{i}]"] = self._flat_layout(i, dtype_name(s))
        for i, st in self.inner.state_dict()["state"].items():
            for k, v in st.items():
                if isinstance(v, torch.Tensor) \
                        and v.shape == self.shadows[i].shape:
                    out[f"['state'][{i}][{k!r}]"] = self._flat_layout(
                        i, dtype_name(v))
        for key, shape in (shapes or {}).items():
            m = re.fullmatch(r"\['state'\]\[(\d+)\]\['[^']*'\]", key)
            if m and key not in out and int(m.group(1)) < len(self.shadows):
                ll = self._flat_layout(int(m.group(1)), "float32")
                if tuple(shape) == ll.shape:
                    out[key] = ll
        return {k: ll for k, ll in out.items() if not ll.replicated}

    def _padded(self) -> List[int]:
        return [_padded_size(p.numel(), self.n_shards) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        n, sizes = self.n_shards, self._padded()
        grads = [_flat_pad(p.grad if p.grad is not None
                           else torch.zeros_like(p), n).float()
                 for p in self.params]
        shards = split_chunk_major(
            psum_scatter(chunk_major(grads, n), self.mesh, self.axis, dim=0),
            [s // n for s in sizes], 1)
        for p, shadow, g, size in zip(self.params, self.shadows, shards,
                                      sizes):
            # This rank's slice of the parameter as it stands, so that a
            # parameter written elsewhere (a checkpoint) is what steps.
            width = size // n
            lo = self.index * width
            hi = min(lo + width, p.numel())
            if hi > lo:
                shadow[:hi - lo].copy_(p.reshape(-1)[lo:hi])
            shadow.grad = g
        self.inner.step()
        full = all_gather(torch.cat(self.shadows).reshape(1, -1), self.mesh,
                          self.axis, dim=0)
        for p, flat in zip(self.params, split_chunk_major(full, sizes, n)):
            p.copy_(flat[:p.numel()].view_as(p))


def zero1_init(optimizer_factory: Callable[[Iterable],
                                           torch.optim.Optimizer],
               model: nn.Module, n_shards: int, mesh: DeviceMesh,
               axis: str = "dp", param_specs=None) -> Zero1Optimizer:
    """The ZeRO-1 optimizer of ``model`` (this rank's shard of the
    parameters) for ``n_shards`` shards over ``axis``:
    ``optimizer_factory`` builds the inner optimizer over the fp32 flat
    shadow shards, each this rank's slice of its zero-padded
    parameter. ``param_specs`` (a spec tree, as ``param_specs(cfg)``)
    places the state's blocks in checkpoints; without it every
    parameter counts as replicated over the model axes."""
    from .mesh import spec_of
    index = (mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names
             else 0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    specs = None if param_specs is None else [spec_of(param_specs, n)
                                              for n, _ in named]
    shadows = []
    for p in params:
        width = _padded_size(p.numel(), n_shards) // n_shards
        flat = _flat_pad(p.detach(), n_shards).float()
        shadows.append(flat[index * width:(index + 1) * width].clone()
                       .requires_grad_())
    return Zero1Optimizer(optimizer_factory(shadows), params, shadows,
                          int(n_shards), mesh, axis, index, specs)


def zero1_state_specs(n_shards: int, model: nn.Module
                      ) -> Dict[str, torch.Size]:
    """The shape of this rank's shard of every parameter's optimizer
    state: ``[padded_local / n_shards]``, with ``padded_local`` the
    rank's parameter block padded to a multiple of ``n_shards``. (JAX's
    ``zero1_state_specs`` gives the specs of the global leaves, ``P((model
    axes..., 'dp'))`` over ``m * padded_local`` elements: the same
    shard.)"""
    return {name: torch.Size([_padded_size(p.numel(), n_shards)
                              // n_shards])
            for name, p in model.named_parameters() if p.requires_grad}
