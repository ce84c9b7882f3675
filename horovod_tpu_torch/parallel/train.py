"""Data-parallel training steps: the flagship transformer and the image
models.

``build_train_step`` is the counterpart of ``build_train_step`` in
``horovod_tpu/parallel/train.py`` for the 'dp' axis: each rank computes
the mean loss of its batch shard and its gradients;
``DistributedOptimizer`` averages the gradients over the ranks (the JAX
step's psum of ``loss / n_data`` gradients), in buckets its gradient
hooks fire during backward, before the inner optimizer's update; the
reported loss is the global mean. A step starts with the optimizer's
own ``zero_grad()``, which keeps gradient views (without views it sets
the gradients to None).

``build_image_train_step`` is the counterpart of one step of
``bench.py``'s ``build_step`` (the ResNet-50 headline): mean softmax
cross-entropy of integer labels over fp32 logits, the BN running stats
updated from this rank's batch (no cross-rank BN), the gradients
averaged over the ranks, then the inner step.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import topology as _topo
from ..models.transformer import Transformer, TransformerConfig
from ..ops import collective as _coll
from ..optimizer import DistributedOptimizer


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


def build_train_step(cfg: TransformerConfig,
                     optimizer_factory: Callable[[Iterable],
                                                 torch.optim.Optimizer],
                     *, device: Union[str, torch.device, None] = None
                     ) -> TrainStep:
    """The dp train step for ``cfg``. ``optimizer_factory(params)`` builds
    the inner ``torch.optim`` optimizer. ``device`` defaults to the one
    ``init()`` chose, else CUDA."""
    return TrainStep(cfg, optimizer_factory, _step_device(device))


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
