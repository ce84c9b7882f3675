"""Data-parallel training step of the flagship transformer.

Counterpart of ``build_train_step`` in ``horovod_tpu/parallel/train.py``
for the 'dp' axis: each rank computes the mean loss of its batch shard
and its gradients; ``DistributedOptimizer`` averages the gradients over
the ranks (the JAX step's psum of ``loss / n_data`` gradients) before
the inner optimizer's update; the reported loss is the global mean.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

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
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss_fn(tokens, targets)
        loss.backward()
        optimizer.step()
        return _coll.allreduce(loss.detach().float(), average=True,
                               name="train_step.loss")


def build_train_step(cfg: TransformerConfig,
                     optimizer_factory: Callable[[Iterable],
                                                 torch.optim.Optimizer],
                     *, device: Union[str, torch.device, None] = None
                     ) -> TrainStep:
    """The dp train step for ``cfg``. ``optimizer_factory(params)`` builds
    the inner ``torch.optim`` optimizer. ``device`` defaults to the one
    ``init()`` chose, else CUDA."""
    if device is None:
        device = (_topo.device() if _topo.is_initialized()
                  else _topo.resolve_device(None))
    return TrainStep(cfg, optimizer_factory, _topo.resolve_device(device))
