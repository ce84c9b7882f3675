"""Keras callbacks of the port — the counterparts of
``horovod_tpu/keras/callbacks.py`` (after Horovod's _keras/callbacks.py),
for Keras 3's multi-backend callback API.

- ``BroadcastGlobalVariablesCallback`` — rank-0 state sync at train start.
- ``MetricAverageCallback`` — epoch-end metric allreduce.
- ``LearningRateScheduleCallback`` — epoch/batch LR schedule with momentum
  correction.
- ``LearningRateWarmupCallback`` — gradual 1/N → 1 warmup over the first
  epochs.
- ``MetricsCallback`` — per-step step time, samples/sec and collective
  share into the metrics registry, through the port's ``StepTimer``
  (labeled ``framework=keras``).
- ``CheckpointCallback`` — asynchronous saves on the port's sharded
  checkpoint engine.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

import keras

from .. import ops as _ops
from .. import topology as _topo
from ..observability.step_metrics import StepTimer


def _get_lr(optimizer) -> float:
    return float(keras.ops.convert_to_numpy(optimizer.learning_rate))


def _set_lr(optimizer, value: float) -> None:
    optimizer.learning_rate = value


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast all model variables from ``root_rank`` when training
    begins, and optimizer slot variables as soon as they exist (after the
    first batch builds them) — consistent initialization of all workers
    when training starts or resumes from a checkpoint."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._model_done = False
        self._opt_done = False

    def on_train_begin(self, logs=None):
        from . import broadcast_variables
        if not self._model_done:
            broadcast_variables(self.model.variables, self.root_rank)
            self._model_done = True

    def on_train_batch_end(self, batch, logs=None):
        # Optimizer slots (momentum, Adam moments, iteration counter) are
        # built lazily by the first apply; sync them once available so a
        # restored rank-0 optimizer state propagates.
        from . import broadcast_variables
        if not self._opt_done and getattr(
                self.model, "optimizer", None) is not None:
            vs = self.model.optimizer.variables
            if vs:
                broadcast_variables(vs, self.root_rank)
                self._opt_done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch metrics across ranks before other callbacks (e.g.
    checkpointing or LR plateau schedules) consume them. Place it before
    them in the callback list."""

    def _average_metrics_in_place(self, logs):
        logs = logs or {}
        reduced = {}
        for metric, value in sorted(logs.items()):
            if isinstance(value, (int, float, np.floating, np.integer)):
                out = _ops.allreduce_async(
                    torch.tensor(float(value), dtype=torch.float32,
                                 device=_topo.device()),
                    average=True, name=f"metric.{metric}").wait()
                reduced[metric] = float(out)
        logs.update(reduced)

    def on_epoch_end(self, epoch, logs=None):
        self._average_metrics_in_place(logs)


class MetricsCallback(keras.callbacks.Callback):
    """Report per-step training telemetry into the metrics registry
    (``hvdtpu_step_seconds``, ``hvdtpu_samples_per_second``,
    ``hvdtpu_collective_step_share`` — labeled ``framework=keras``)
    and optionally into the Keras logs dict.

    ``batch_size`` enables the samples/sec series (Keras 3 batch logs
    do not carry the batch size). ``log_metrics=True`` also writes
    ``samples_per_sec`` / ``collective_share`` (and the deprecated
    ``allreduce_share``) into each batch's ``logs``. ``device``: whose
    memory the HBM gauges read (default: this process's)."""

    def __init__(self, batch_size: Optional[int] = None,
                 log_metrics: bool = False,
                 flops_per_step: Optional[float] = None, device=None):
        super().__init__()
        self._timer = StepTimer("keras", batch_size=batch_size,
                                flops_per_step=flops_per_step,
                                device=device)
        self._log_metrics = log_metrics

    def on_train_batch_begin(self, batch, logs=None):
        self._timer.begin()

    def on_train_batch_end(self, batch, logs=None):
        self._timer.end()
        if self._log_metrics and logs is not None:
            if self._timer.batch_size:
                logs["samples_per_sec"] = self._timer.last_samples_per_s
            logs["collective_share"] = self._timer.last_collective_share
            logs["allreduce_share"] = self._timer.last_collective_share


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply the initial LR by ``multiplier`` (a constant or a
    function of epoch) between ``start_epoch`` and ``end_epoch``.

    ``staircase=True`` adjusts once per epoch; ``staircase=False``
    interpolates per batch using ``steps_per_epoch`` (from
    ``self.params['steps']`` when not given). When the optimizer has
    momentum and ``momentum_correction`` is on, momentum is scaled by
    ``new_lr/old_lr`` for the batches where the LR changed and restored
    after (horovod/_keras/callbacks.py:103-117).
    """

    def __init__(self, multiplier: Union[float, Callable[[float], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None):
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.initial_lr = None
        self.restore_momentum = None
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = None
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _autodetect_steps_per_epoch(self) -> int:
        if self.params and self.params.get("steps"):
            return self.params["steps"]
        raise ValueError(
            f"Could not autodetect steps per epoch; pass steps_per_epoch "
            f"to {self.__class__.__name__}()")

    def _adjust_learning_rate(self, epoch: float) -> None:
        old_lr = _get_lr(self.model.optimizer)
        new_lr = self.initial_lr * self.multiplier(epoch)
        _set_lr(self.model.optimizer, new_lr)
        if (self.momentum_correction
                and hasattr(self.model.optimizer, "momentum")
                and old_lr > 0):
            self.restore_momentum = self.model.optimizer.momentum
            self.model.optimizer.momentum = (
                self.restore_momentum * new_lr / old_lr)

    def _restore_momentum_if_needed(self) -> None:
        if self.restore_momentum:
            self.model.optimizer.momentum = self.restore_momentum
            self.restore_momentum = None

    def on_train_begin(self, logs=None):
        self.initial_lr = _get_lr(self.model.optimizer)
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = self._autodetect_steps_per_epoch()

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_train_batch_begin(self, batch, logs=None):
        if (self.current_epoch is None
                or self.current_epoch < self.start_epoch
                or (self.end_epoch is not None
                    and self.current_epoch >= self.end_epoch)):
            return
        if self.staircase and batch == 0:
            self._adjust_learning_rate(self.current_epoch)
        elif not self.staircase:
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            self._adjust_learning_rate(epoch)

    def on_train_batch_end(self, batch, logs=None):
        self._restore_momentum_if_needed()

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _get_lr(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradually scale the LR from ``initial_lr/size`` up to ``initial_lr``
    over the first ``warmup_epochs`` ('Accurate, Large Minibatch SGD')."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        def multiplier(epoch):
            epoch += 1.0 / self.steps_per_epoch
            size = _topo.size()
            return 1.0 / size * (epoch * (size - 1) / warmup_epochs + 1)

        super().__init__(multiplier, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {_get_lr(self.model.optimizer):g}.")


class CheckpointCallback(keras.callbacks.Callback):
    """Asynchronous checkpoint saves on the port's sharded engine
    (docs/checkpoint.md).

    Every ``every_epochs`` epoch end, the model's weights (a list of
    host arrays — replicated state, which rank 0 writes) are handed to a
    :class:`horovod_tpu_torch.checkpoint.CheckpointEngine`; serialization
    and the atomic commit run on the engine's thread, so ``model.fit``
    waits only for the snapshot. The write in flight is joined at train
    end (and by the next save). The checkpoint's ``step`` is the epoch
    number; restore with ``engine.restore(template=model.get_weights())``
    and ``model.set_weights``.
    """

    def __init__(self, directory=None, *, engine=None,
                 every_epochs: int = 1):
        super().__init__()
        if (directory is None) == (engine is None):
            raise ValueError(
                "pass exactly one of directory= or engine=")
        if engine is None:
            from ..checkpoint import CheckpointEngine
            engine = CheckpointEngine(directory)
        self.engine = engine
        self.every_epochs = max(1, int(every_epochs))

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.every_epochs == 0:
            self.engine.save(list(self.model.get_weights()),
                             step=epoch + 1)

    def on_train_end(self, logs=None):
        self.engine.wait()
