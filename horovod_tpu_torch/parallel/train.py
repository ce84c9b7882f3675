"""Training steps: the flagship transformer (data parallel, or over a
mesh with tensor and sequence parallelism) and the image models.

``build_train_step`` is the counterpart of ``build_train_step`` in
``horovod_tpu/parallel/train.py`` for the 'dp' axis: each rank computes
the mean loss of its batch shard and its gradients;
``DistributedOptimizer`` averages the gradients over the ranks (the JAX
step's psum of ``loss / n_data`` gradients), in buckets its gradient
hooks fire during backward, before the inner optimizer's update; the
reported loss is the global mean. A step starts with the optimizer's
own ``zero_grad()``, which keeps gradient views (without views it sets
the gradients to None).

With a mesh (``cfg.tp_axis``/``cfg.sp_axis``, or mesh axes besides
'dp'), ``build_train_step`` builds :class:`MeshTrainStep`, the
counterpart of the JAX step itself (``horovod_tpu/parallel/train.py``):
every rank holds its shard of the parameters (``param_specs``) and of
the batch (batch over 'dp', sequence over the config's 'sp'), runs the
model's own collectives (the row-parallel psum, the ring's shifts,
Ulysses' all-to-alls), and then follows JAX's gradient rule. Each data
shard's loss is its local mean over ``n_data`` (the product of 'dp'
and 'sp'), masked to zero except at tp index 0; backward, with psum's
backward a psum; then each gradient is summed over every mesh axis its
parameter is not split over, and the inner optimizer steps. The
reported loss is the sum over all axes: the global mean. This step
does not go through the collective engine: the engine negotiates
Horovod's named requests over the whole world, while the JAX step's
reductions are in-program psums over mesh axes, which every rank of an
axis's group issues in the same order (coalesced ``all_reduce``s on the
mesh's groups).

``build_image_train_step`` is the counterpart of one step of
``bench.py``'s ``build_step`` (the ResNet-50 headline): mean softmax
cross-entropy of integer labels over fp32 logits, the BN running stats
updated from this rank's batch (no cross-rank BN), the gradients
averaged over the ranks, then the inner step.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .. import topology as _topo
from ..models.transformer import Transformer, TransformerConfig, param_specs
from ..ops import collective as _coll
from ..optimizer import DistributedOptimizer
from .collectives import axis_size, psum
from .mesh import place, shard_tensor, shard_tree, spec_axes

DATA_AXES = ("dp", "sp")
MODEL_AXES = ("tp", "ep")


class TrainStep:
    """``step(model, optimizer, tokens, targets) -> loss``.

    ``optimizer`` must come from :meth:`make_optimizer` (or be any
    :func:`DistributedOptimizer`); ``tokens``/``targets`` are this rank's
    ``[B_local, S]`` shard. The returned loss is a 0-d fp32 tensor, the
    mean over every rank's tokens."""

    def __init__(self, cfg: TransformerConfig,
                 optimizer_factory: Callable[[Iterable], torch.optim.Optimizer],
                 device: torch.device):
        self.cfg = cfg
        self.optimizer_factory = optimizer_factory
        self.device = device

    def make_model(self, **kwargs) -> Transformer:
        return Transformer(self.cfg, device=self.device, **kwargs)

    def make_optimizer(self, model: Transformer):
        return DistributedOptimizer(
            self.optimizer_factory(model.parameters()),
            named_parameters=model.named_parameters())

    def __call__(self, model: Transformer, optimizer, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        if not hasattr(optimizer, "synchronize"):
            raise TypeError("the train step needs a DistributedOptimizer "
                            "(see TrainStep.make_optimizer)")
        tokens = tokens.to(model.device, non_blocking=True)
        targets = targets.to(model.device, non_blocking=True)
        optimizer.zero_grad()
        loss = model.loss_fn(tokens, targets)
        loss.backward()
        optimizer.step()
        return _coll.allreduce(loss.detach().float(), average=True,
                               name="train_step.loss")


def _step_device(device) -> torch.device:
    if device is None:
        device = (_topo.device() if _topo.is_initialized()
                  else _topo.resolve_device(None))
    return _topo.resolve_device(device)


def _spec_of(specs: Dict, name: str):
    if name.startswith("layers."):
        _, idx, leaf = name.split(".", 2)
        return specs["layers"][int(idx)][leaf]
    return specs[name]


def reduce_gradients(model: nn.Module, specs: Dict, mesh: DeviceMesh
                     ) -> None:
    """JAX's reduction rule, in place: each parameter's gradient summed
    over every mesh axis (of size > 1) not in its spec, one coalesced
    ``all_reduce`` per axis for the gradients that share the axes
    missing from their specs."""
    groups = defaultdict(list)
    for name, p in model.named_parameters():
        have = set(spec_axes(_spec_of(specs, name)))
        missing = tuple(a for a in mesh.mesh_dim_names
                        if a not in have and axis_size(mesh, a) > 1)
        if missing and p.grad is not None:
            groups[missing].append(p.grad)
    for missing, grads in groups.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for a in missing:
            dist.all_reduce(flat, group=mesh.get_group(a))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class MeshTrainStep:
    """``step(model, optimizer, tokens, targets) -> loss`` over a mesh.

    ``model`` comes from :meth:`make_model` (this rank's shard of the
    parameters), ``optimizer`` from :meth:`make_optimizer` (the inner
    optimizer over the shard); ``tokens``/``targets`` are this rank's
    ``[B / dp, S / sp]`` block (:meth:`shard_batch` cuts it from the
    global batch). The returned loss is a 0-d fp32 tensor, the global
    mean, on every rank."""

    def __init__(self, cfg: TransformerConfig,
                 optimizer_factory: Callable[[Iterable],
                                             torch.optim.Optimizer],
                 mesh: DeviceMesh, device: torch.device):
        for axis in (cfg.tp_axis, cfg.sp_axis):
            if axis and axis not in mesh.mesh_dim_names:
                raise ValueError(f"config axis {axis!r} is not a mesh axis "
                                 f"(axes: {mesh.mesh_dim_names})")
        self.cfg = cfg
        self.optimizer_factory = optimizer_factory
        self.mesh = mesh
        self.device = device
        self.specs = param_specs(cfg)
        self.sizes, self.coords = place(mesh)
        self.n_data = math.prod(self.sizes.get(a, 1) for a in DATA_AXES)
        batch = "dp" if "dp" in self.sizes else None
        self.data_spec = (batch, cfg.sp_axis)

    def shard_params(self, params: Dict) -> Dict:
        """This rank's slice of a global parameter tree."""
        return shard_tree(params, self.specs, self.sizes, self.coords)

    def shard_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``[B, S]`` batch."""
        return shard_tensor(batch, self.data_spec, self.sizes, self.coords)

    def make_model(self, **kwargs) -> Transformer:
        return Transformer(self.cfg, device=self.device, mesh=self.mesh,
                           **kwargs)

    def make_optimizer(self, model: Transformer) -> torch.optim.Optimizer:
        return self.optimizer_factory(model.parameters())

    def __call__(self, model: Transformer, optimizer, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        tokens = tokens.to(model.device, non_blocking=True)
        targets = targets.to(model.device, non_blocking=True)
        optimizer.zero_grad()
        loss = model.loss_fn(tokens, targets) / self.n_data
        # Model ranks past index 0 hold copies of the same loss: masked,
        # each data shard counts once, and the masked ranks still get
        # their cotangents through psum's backward.
        if any(self.coords[a] for a in MODEL_AXES if a in self.coords):
            loss = torch.where(loss.new_zeros((), dtype=torch.bool), loss,
                               0.0)
        loss.backward()
        reduce_gradients(model, self.specs, self.mesh)
        optimizer.step()
        return psum(loss.detach().float(), self.mesh,
                    self.mesh.mesh_dim_names)


def build_train_step(cfg: TransformerConfig,
                     optimizer_factory: Callable[[Iterable],
                                                 torch.optim.Optimizer],
                     *, device: Union[str, torch.device, None] = None,
                     mesh: Optional[DeviceMesh] = None
                     ) -> Union[TrainStep, MeshTrainStep]:
    """The train step for ``cfg``. ``optimizer_factory(params)`` builds
    the inner ``torch.optim`` optimizer. ``device`` defaults to the one
    ``init()`` chose, else CUDA. With ``cfg.tp_axis``/``cfg.sp_axis``,
    or a ``mesh`` with axes besides 'dp', it is the mesh step over
    ``mesh`` (which then must be given); otherwise the dp step through
    ``DistributedOptimizer``."""
    dev = _step_device(device)
    axes = () if mesh is None else mesh.mesh_dim_names
    if cfg.tp_axis or cfg.sp_axis or any(a != "dp" for a in axes):
        if mesh is None:
            raise ValueError("a config with tp_axis/sp_axis needs mesh= "
                             "(parallel.mesh.create_mesh)")
        return MeshTrainStep(cfg, optimizer_factory, mesh, dev)
    return TrainStep(cfg, optimizer_factory, dev)


class ImageTrainStep:
    """``step(model, optimizer, images, labels) -> loss``.

    ``images`` are this rank's NHWC ``[B_local, H, W, 3]`` shard and
    ``labels`` its ``[B_local]`` integer classes. The model is in train
    mode during the step, so each BN normalises with this rank's batch
    statistics and updates its running ones. The returned loss is a 0-d
    fp32 tensor, the mean over every rank's images."""

    def __init__(self, model_factory: Callable[..., nn.Module],
                 optimizer_factory: Callable[[Iterable],
                                             torch.optim.Optimizer],
                 device: torch.device):
        self.model_factory = model_factory
        self.optimizer_factory = optimizer_factory
        self.device = device

    def make_model(self, **kwargs) -> nn.Module:
        return self.model_factory(device=self.device, **kwargs)

    def make_optimizer(self, model: nn.Module):
        return DistributedOptimizer(
            self.optimizer_factory(model.parameters()),
            named_parameters=model.named_parameters())

    def __call__(self, model: nn.Module, optimizer, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        if not hasattr(optimizer, "synchronize"):
            raise TypeError("the train step needs a DistributedOptimizer "
                            "(see ImageTrainStep.make_optimizer)")
        images = images.to(self.device, non_blocking=True)
        labels = labels.to(self.device, non_blocking=True)
        model.train()
        optimizer.zero_grad()
        loss = F.cross_entropy(model(images).float(), labels)
        loss.backward()
        optimizer.step()
        return _coll.allreduce(loss.detach().float(), average=True,
                               name="image_train_step.loss")


def build_image_train_step(model_factory: Callable[..., nn.Module],
                           optimizer_factory: Callable[[Iterable],
                                                       torch.optim.Optimizer],
                           *, device: Union[str, torch.device, None] = None
                           ) -> ImageTrainStep:
    """The dp train step of an image classifier such as ``ResNet50``.
    ``model_factory(device=..., **kwargs)`` builds the model (e.g.
    ``functools.partial(ResNet50, num_classes=1000, bn_impl="pallas")``);
    ``optimizer_factory(params)`` the inner optimizer, e.g.
    ``SGD(lr=0.01 * size, momentum=0.9)`` as ``bench.py`` uses. ``device``
    defaults to the one ``init()`` chose, else CUDA."""
    return ImageTrainStep(model_factory, optimizer_factory,
                          _step_device(device))
