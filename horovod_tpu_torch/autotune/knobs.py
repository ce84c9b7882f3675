"""Typed knob registry — the global autotuner's search space.

Counterpart of ``horovod_tpu/autotune/knobs.py``, the same seven knobs
with the same domains, defaults and safety classes.

Every performance knob the framework grew — DCN wire spec, fusion
threshold, torch bucket size, pipeline schedule/microbatch count,
serving spec_tokens — is declared here ONCE, with its domain, the
mechanism that applies it safely to a live job, and a safety class that
tells the tuner how disruptive a move is (docs/autotune.md):

``safety`` classes
    ``epoch``      — must flip through the coordinator-stamped
                     wire-epoch mechanism so every rank switches at the
                     same group seq (wire spec, fusion threshold).
    ``boundary``   — applies only at a step boundary while no gradient
                     reductions are in flight (torch bucket size).
    ``rebuild``    — needs a ``build_train_step`` rebuild and is scored
                     per-trial, never flipped under a running program
                     (pipeline schedule, microbatch count).
    ``slot``       — adapts online per serving slot from its own live
                     signal (spec_tokens).
    ``live``       — safe to change between any two engine cycles
                     (cycle time).

``kind`` is ``discrete`` (successive halving owns it) or ``continuous``
(the legacy Bayesian tuner's GP seeds and refines it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

KINDS = ("discrete", "continuous")
SAFETY_CLASSES = ("live", "epoch", "boundary", "rebuild", "slot")
APPLY_VIAS = ("wire_epoch", "fusion_epoch", "bucket_repartition",
              "train_step_rebuild", "serving_slot", "engine_param")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable: its domain, apply mechanism, and safety class."""

    name: str
    kind: str                    # "discrete" | "continuous"
    domain: Tuple                # values (discrete) or (lo, hi) bounds
    default: Any
    safety: str                  # see SAFETY_CLASSES
    apply_via: str               # see APPLY_VIAS
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"knob {self.name!r}: kind {self.kind!r} "
                             f"not in {KINDS}")
        if self.safety not in SAFETY_CLASSES:
            raise ValueError(f"knob {self.name!r}: safety "
                             f"{self.safety!r} not in {SAFETY_CLASSES}")
        if self.apply_via not in APPLY_VIAS:
            raise ValueError(f"knob {self.name!r}: apply_via "
                             f"{self.apply_via!r} not in {APPLY_VIAS}")
        if self.kind == "continuous":
            if len(self.domain) != 2 or self.domain[0] >= self.domain[1]:
                raise ValueError(
                    f"knob {self.name!r}: continuous domain must be "
                    f"(lo, hi) with lo < hi, got {self.domain!r}")
        elif not self.domain:
            raise ValueError(f"knob {self.name!r}: empty domain")
        if self.kind == "discrete" and self.default not in self.domain:
            raise ValueError(f"knob {self.name!r}: default "
                             f"{self.default!r} outside its domain")

    def clamp(self, value):
        """Continuous values clamp to bounds; discrete values must be
        members of the domain."""
        if self.kind == "continuous":
            lo, hi = self.domain
            return min(max(value, lo), hi)
        if value not in self.domain:
            raise ValueError(f"{value!r} is not in knob {self.name!r}'s "
                             f"domain {self.domain!r}")
        return value


class KnobRegistry:
    """Ordered name -> Knob map; the tuner iterates it to build the
    joint search space."""

    def __init__(self):
        self._knobs: Dict[str, Knob] = {}

    def register(self, knob: Knob) -> Knob:
        if knob.name in self._knobs:
            raise ValueError(f"knob {knob.name!r} already registered")
        self._knobs[knob.name] = knob
        return knob

    def get(self, name: str) -> Knob:
        return self._knobs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def __iter__(self):
        return iter(self._knobs.values())

    def __len__(self) -> int:
        return len(self._knobs)

    def names(self):
        return list(self._knobs)

    def discrete(self):
        return [k for k in self if k.kind == "discrete"]

    def continuous(self):
        return [k for k in self if k.kind == "continuous"]

    def defaults(self) -> Dict[str, Any]:
        return {k.name: k.default for k in self}


def default_registry(include: Optional[Tuple[str, ...]] = None
                     ) -> KnobRegistry:
    """The stock search space over every subsystem's perf knob. The
    domains are the hand-tuned values the benches sweep
    (BENCH_PIPELINE/BENCH_SHIMS/BENCH_SPEED baselines); ``include``
    filters to a subset by name (the bench tuner scopes to what its
    workload can express)."""
    reg = KnobRegistry()
    all_knobs = (
        Knob("dcn_wire_spec", "discrete",
             ("", "bf16", "int8x256", "fp8x256"), "", "epoch",
             "wire_epoch",
             "Cross-slice gradient wire format (docs/compression.md); "
             "'' is raw fp32. Flips via a coordinator-stamped wire "
             "epoch so every rank requantizes at the same group seq."),
        Knob("fusion_threshold_mb", "discrete", (16, 32, 64, 128), 64,
             "epoch", "fusion_epoch",
             "Fusion-buffer cap (docs/fusion.md). Grouping never "
             "changes numerics, but all ranks must agree per group — "
             "stamped as a fusion epoch in coordinator params."),
        Knob("torch_bucket_mb", "discrete", (8, 16, 32, 64, 128), 64,
             "boundary", "bucket_repartition",
             "torch DistributedOptimizer gradient-bucket cap "
             "(docs/torch.md); re-partitions at a step boundary."),
        Knob("pipeline_schedule", "discrete",
             ("gpipe", "1f1b", "interleaved", "zb-h1"), "1f1b",
             "rebuild", "train_step_rebuild",
             "Pipeline schedule (docs/pipeline.md) — scored per trial "
             "via build_train_step rebuilds; zb-h1 is the zero-bubble "
             "point the search should find at scale."),
        Knob("num_microbatches", "discrete", (4, 8, 16, 32), 8,
             "rebuild", "train_step_rebuild",
             "Pipeline microbatch count; more microbatches shrink the "
             "bubble but pay per-tick overheads."),
        Knob("spec_tokens", "discrete", (1, 2, 3, 4, 6, 8), 4, "slot",
             "serving_slot",
             "Speculative-decode draft length k; adapts per slot from "
             "the live draft-acceptance rate (cold drafter backs off "
             "to k=1)."),
        Knob("cycle_time_ms", "continuous", (1.0, 100.0), 10.0, "live",
             "engine_param",
             "Engine cycle time — the legacy Bayesian tuner's "
             "continuous axis; its GP log seeds this knob."),
    )
    for k in all_knobs:
        if include is None or k.name in include:
            reg.register(k)
    return reg
