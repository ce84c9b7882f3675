"""The safe online apply plane: knob -> live-subsystem mechanism.

Counterpart of ``horovod_tpu/autotune/apply.py``. In the port
``set_wire``/``set_fusion``/``set_engine_param`` are
``ops.collective.engine().tuner_move`` (rank 0's coordinator
arbitrates) and ``set_bucket_mb`` is
``DistributedOptimizer.set_bucket_cap_mb``.

The tuner never pokes a subsystem directly — it hands a (knob, value)
pair to this plane, which routes by ``knob.apply_via`` to a callable
the integration layer injected (docs/autotune.md):

  ``wire_epoch``         set_wire(spec)       coordinator-stamped wire
                                              epoch (the ladder's) so
                                              every rank requantizes at
                                              the same group seq.
  ``fusion_epoch``       set_fusion(mb)       coordinator-stamped fusion
                                              epoch — all ranks regroup
                                              at the same seq.
  ``bucket_repartition`` set_bucket_mb(mb)    torch bucket re-partition
                                              at a step boundary.
  ``train_step_rebuild`` rebuild(config)      scored per-trial only —
                                              the plane refuses it as an
                                              ONLINE move.
  ``serving_slot``       (per-slot)           adapts from its own live
                                              signal (spec_adapt.py);
                                              never a driver move.
  ``engine_param``       set_engine_param(name, value)

A mechanism the integration did not inject is simply unsupported: the
tuner skips the knob rather than guessing at a side door. That is the
safety contract — every path to a live job goes through exactly one
named, injected hook.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .knobs import Knob


@dataclasses.dataclass
class ApplyPlane:
    """Injected mechanism callables, keyed by ``Knob.apply_via``."""

    set_wire: Optional[Callable[[str], Any]] = None
    set_fusion: Optional[Callable[[int], Any]] = None
    set_bucket_mb: Optional[Callable[[int], Any]] = None
    rebuild: Optional[Callable[[dict], Any]] = None
    set_engine_param: Optional[Callable[[str, Any], Any]] = None

    def supports(self, knob: Knob) -> bool:
        """Can this plane flip ``knob`` as an ONLINE move? Rebuild and
        per-slot knobs are never online moves regardless of injection."""
        return self._hook(knob) is not None and knob.apply_via not in (
            "train_step_rebuild", "serving_slot")

    def _hook(self, knob: Knob):
        return {
            "wire_epoch": self.set_wire,
            "fusion_epoch": self.set_fusion,
            "bucket_repartition": self.set_bucket_mb,
            "train_step_rebuild": self.rebuild,
            "engine_param": self.set_engine_param,
        }.get(knob.apply_via)

    def apply(self, knob: Knob, value) -> None:
        if knob.apply_via == "serving_slot":
            raise ValueError(
                f"knob {knob.name!r} adapts per serving slot "
                "(spec_adapt.SpecTokensController), not via the driver")
        if knob.apply_via == "train_step_rebuild":
            raise ValueError(
                f"knob {knob.name!r} needs a train-step rebuild; score "
                "it per-trial via AutoTuner.tune_rebuild, never as an "
                "online move")
        hook = self._hook(knob)
        if hook is None:
            raise ValueError(
                f"no mechanism injected for knob {knob.name!r} "
                f"(apply_via={knob.apply_via!r})")
        if knob.apply_via == "engine_param":
            hook(knob.name, value)
        else:
            hook(value)
