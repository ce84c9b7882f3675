"""The numerics plane: the plane that watches the values.

Counterpart of ``horovod_tpu/observability/numerics.py``, with JAX's
names, metric families and alerts:

  - **Step telemetry**: the global gradient norm, the update/param norm
    ratio and each rank's nonfinite gradient count, computed on the
    device by the train steps (``parallel/train.py``) and reduced in one
    small ``all_reduce``, then read one step late by :class:`StepStats`:
    the step's values are copied into pinned memory behind a CUDA event
    and read once the next step is on its way, so the host never waits
    on the step it just launched. They land in the
    ``hvdtpu_numerics_*`` families the history store samples.
  - **Nonfinite sentinels**: the engine counts the nonfinite elements
    of each fused group's LOCAL buffer before the reduction (after it a
    NaN is on every rank and the producer cannot be named), the
    optimizer its buckets' (``torch_bucket``); :func:`note_nonfinite`
    fires a same-step ``nonfinite_rate`` alert through the health
    plane's fan-out.
  - **Divergence fingerprints**: :func:`fingerprint_tree` reduces a
    parameter tree (or a module) to per-leaf ``[norm, crc, n]`` digests
    keyed by JAX's keypath of the same leaf; each rank's digests ride
    its next negotiation round to rank 0 (``ops/collective.py``), whose
    :func:`record_fingerprint` majority-compares a step's set and fires
    ``rank_divergence`` naming the leaf and the rank.
  - **Quantization drift**: the error feedback's residual norm per
    bucket, :func:`note_ef_residual`.

Off by default (``HOROVOD_TPU_NUMERICS=1`` at ``init``, or
:func:`set_enabled`): every hook site is then one flag check.

The leaf names are what ``jax.tree_util.keystr`` renders for the leaf of
``interop.params_to_jax(model.state_dict())``: a module's state_dict key
``layers.3.wq`` is ``['layers'][3]['wq']``, so one ``leaf=`` substring
of ``HOROVOD_TPU_FAULT_SPEC`` picks the same leaf in both packages.

A fingerprint's norm is numpy's float64 sum in numpy's order on the
host, as JAX's is: a bf16 leaf goes exactly to float32 and then to
numpy, and its subsample's bytes are its 2-byte bits (as numpy with
``ml_dtypes`` holds them). :func:`fingerprint_leaf` is the checkpoint
manifest's (``checkpoint/fingerprint.py``), imported from there.

``flip_mantissa_bit`` on a CUDA tensor flips the bit in place, through
an integer view of the same width, under ``no_grad``; JAX returns a
copy. :func:`maybe_bitflip` on a module writes the flip into the
parameter itself, so the parameter objects, their hooks and the
optimizer's references survive (deviation 43).
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.fingerprint import (FINGERPRINT_SAMPLE,  # noqa: F401
                                      fingerprint_leaf)
from ..utils import env as _env
from . import registry as _reg

_log = logging.getLogger(__name__)

_UINT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

# The name of the dp train step's numerics vector in the engine, whose
# group the payload sentinel leaves alone (its NaN norms report a NaN
# that is counted where it was made).
AUX_NAME = "train_step.numerics"

_enabled = False
_armed_by_init = False


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


def maybe_enable_from_env() -> bool:
    """Arm the plane from ``HOROVOD_TPU_NUMERICS`` (``init`` calls it;
    idempotent). ``shutdown`` disarms a plane ``init`` armed."""
    global _armed_by_init
    if _env.numerics_enabled() and not _enabled:
        set_enabled(True)
        _armed_by_init = True
    return _enabled


def disarm_from_shutdown() -> None:
    global _armed_by_init
    if _armed_by_init:
        set_enabled(False)
        _armed_by_init = False


# --------------------------------------------------------------------------
# Metric families
# --------------------------------------------------------------------------

_fams: Optional[dict] = None
_fams_lock = threading.Lock()


def _families() -> dict:
    global _fams
    if _fams is None:
        with _fams_lock:
            if _fams is None:
                r = _reg.registry()
                _fams = {
                    "nonfinite": r.counter(
                        "hvdtpu_numerics_nonfinite_total",
                        "Nonfinite (NaN/Inf) elements observed in local "
                        "pre-reduction payloads, by source "
                        "(docs/numerics.md)"),
                    "grad_norm": r.gauge(
                        "hvdtpu_numerics_grad_norm",
                        "Global (post-reduction) gradient L2 norm of the "
                        "last completed training step"),
                    "loss": r.gauge(
                        "hvdtpu_numerics_loss",
                        "Loss value of the last completed training step"),
                    "update_ratio": r.gauge(
                        "hvdtpu_numerics_update_ratio",
                        "Update-norm / param-norm ratio of the last "
                        "completed training step (learning-rate "
                        "sanity signal)"),
                    "ef_residual": r.gauge(
                        "hvdtpu_numerics_ef_residual_norm",
                        "Error-feedback residual L2 norm per quantized "
                        "group — the live quantization-drift signal, "
                        "by group"),
                    "fingerprints": r.counter(
                        "hvdtpu_numerics_fingerprints_total",
                        "Cross-rank param fingerprint events, by event "
                        "(computed/compared/mismatch)"),
                }
    return _fams


# --------------------------------------------------------------------------
# Immediate alerts: the health plane's fan-out without a detector
# --------------------------------------------------------------------------

_monitor = None
_monitor_lock = threading.Lock()


def _alert_monitor():
    """The history sampler's live monitor when one runs (so its
    ``alerts`` see these too), else a private spec-less one."""
    global _monitor
    from . import history as _history
    s = _history.sampler()
    if s is not None and s.monitor is not None:
        return s.monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                from . import health as _health
                _monitor = _health.HealthMonitor(
                    specs=[], rank=_process_rank_world()[0],
                    alert_sink=_health._coordinator_alert_sink)
    return _monitor


def fire_alert(kind: str, severity: str, series: str, value: float, *,
               baseline: float = 0.0, evidence: Optional[dict] = None):
    """Fire a typed health alert now, refire-suppressed per (kind,
    series) as the detector plane's. Returns the Alert or None."""
    try:
        return _alert_monitor().fire(kind, severity, series, value,
                                     baseline=baseline, evidence=evidence)
    except Exception as e:  # telemetry must never kill the step
        _log.warning("numerics alert failed: %s", e)
        return None


# --------------------------------------------------------------------------
# Nonfinite sentinels
# --------------------------------------------------------------------------

def count_nonfinite(buf) -> int:
    """Nonfinite element count of a buffer: a numpy array (JAX's fast
    path: one dot product, since a finite sum of squares proves every
    element finite) or a tensor. Integer dtypes count 0."""
    if isinstance(buf, torch.Tensor):
        if not buf.is_floating_point():
            return 0
        return int(buf.numel() - torch.isfinite(buf).sum())
    a = np.asarray(buf)
    if a.dtype.kind != "f":
        return 0
    if a.ndim == 1 and math.isfinite(float(np.dot(a, a))):
        return 0
    return int(a.size - np.count_nonzero(np.isfinite(a)))


def note_nonfinite(count: int, *, source: str, step: int = -1,
                   rank: Optional[int] = None, detail: str = "") -> None:
    """Nonfinite elements seen in a local payload: the counter, a flight
    recorder ``numerics`` event and a same-step ``nonfinite_rate``
    alert. A count <= 0 does nothing."""
    if count <= 0 or not _enabled:
        return
    who = rank if rank is not None else _process_rank_world()[0]
    _families()["nonfinite"].labels(source=source).inc(count)
    from . import flight_recorder as _flight
    _flight.recorder().note("numerics", (
        "nonfinite", step, who, count, (detail or source)[:120]))
    fire_alert(
        "nonfinite_rate", "critical",
        f'hvdtpu_numerics_nonfinite_total{{source="{source}"}}',
        float(count),
        evidence={"step": step, "rank": who, "source": source,
                  "detail": detail})


# One tick per scanned fusion buffer, as JAX's sentinel counts them.
_scan_tick = 0
_scan_lock = threading.Lock()


def next_scan_tick() -> int:
    """The tick of the next scanned buffer (the engine takes one per
    fused group when the plane is armed)."""
    global _scan_tick
    with _scan_lock:
        t = _scan_tick
        _scan_tick = t + 1
    return t


def scan_payload(buf, *, source: str = "collective") -> int:
    """The engine's sentinel on a packed LOCAL buffer (on the host, or
    on the CPU): count its nonfinite elements and alert if any. Returns
    the count; 0 with the plane off."""
    if not _enabled:
        return 0
    t = next_scan_tick()
    c = count_nonfinite(buf)
    if c:
        note_nonfinite(c, source=source, step=t)
    return c


def note_loss(step: int, loss: float) -> None:
    """A completed step's loss; a nonfinite loss is itself a sentinel."""
    if not _enabled:
        return
    if math.isfinite(loss):
        _families()["loss"].set(loss)
    else:
        note_nonfinite(1, source="loss", step=step, detail="loss")


def note_ef_residual(group: str, norm: float) -> None:
    """The error feedback's residual norm of one group."""
    if not _enabled or not math.isfinite(norm):
        return
    _families()["ef_residual"].labels(group=str(group)[:60]).set(norm)


# --------------------------------------------------------------------------
# Deferred step stats
# --------------------------------------------------------------------------

class Deferred:
    """Values to read later without waiting on the card: the CUDA
    tensors among them are copied, as one float64 vector, into pinned
    memory behind an event recorded on the current stream; :meth:`read`
    waits only for that event (long passed when read a step late) and
    returns each value as a 1-D float64 array. Host values and CPU
    tensors are read as they are."""

    def __init__(self, values):
        self.sizes = [int(np.size(v)) if not isinstance(v, torch.Tensor)
                      else int(v.numel()) for v in values]
        self.event = None
        cuda = next((v for v in values if isinstance(v, torch.Tensor)
                     and v.is_cuda), None)
        if cuda is None:
            self.vals = [np.asarray(v.detach().cpu().double()
                                    if isinstance(v, torch.Tensor) else v,
                                    dtype=np.float64).reshape(-1)
                         for v in values]
            return
        flat = torch.cat([torch.as_tensor(v, device=cuda.device)
                          .detach().reshape(-1).double() for v in values])
        self.host = torch.empty(flat.shape, dtype=torch.float64,
                                pin_memory=True)
        self.host.copy_(flat, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        self.vals = None

    def read(self) -> List[np.ndarray]:
        if self.vals is None:
            self.event.synchronize()
            self.vals = np.split(self.host.numpy().copy(),
                                 np.cumsum(self.sizes)[:-1])
        return self.vals


_AUX = ("grad_norm", "update_ratio", "nonfinite_by_rank")


class StepStats:
    """The host's sink of the train steps' numerics aux.

    ``note(step, loss, aux)`` stages the current step's values and
    reads the previous step's, whose work has long been queued ahead of
    the current one: the plane adds no wait on the step just launched.
    ``flush()`` reads the last pending step."""

    def __init__(self):
        self._pending: Optional[Tuple[int, tuple]] = None
        self._lock = threading.Lock()

    def note(self, step: int, loss, aux: dict) -> None:
        if not _enabled:
            return
        keys = [k for k in _AUX if aux.get(k) is not None]
        staged = (keys, Deferred([loss] + [aux[k] for k in keys]))
        with self._lock:
            prev, self._pending = self._pending, (step, staged)
        if prev is not None:
            self._materialize(*prev)

    def flush(self) -> None:
        with self._lock:
            prev, self._pending = self._pending, None
        if prev is not None:
            self._materialize(*prev)

    def _materialize(self, step: int, staged) -> None:
        # Unguarded, unlike JAX's: a failed read (the event, the pinned
        # copy) or update raises into the step that reads it. Only
        # fire_alert's fan-out is guarded.
        keys, deferred = staged
        loss, *vals = deferred.read()
        aux = dict(zip(keys, vals))
        fams = _families()
        note_loss(step, float(loss[0]))
        for key in ("grad_norm", "update_ratio"):
            v = aux.get(key)
            if v is not None and math.isfinite(float(v[0])):
                fams[key].set(float(v[0]))
        nf = aux.get("nonfinite_by_rank")
        if nf is not None:
            for r in np.nonzero(nf)[0]:
                note_nonfinite(int(nf[r]), source="grad", step=step,
                               rank=int(r), detail="train_step")


_step_stats = StepStats()


def step_stats() -> StepStats:
    """The process-global sink the train steps feed."""
    return _step_stats


# --------------------------------------------------------------------------
# Fingerprints
# --------------------------------------------------------------------------

def _keystr(parts) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys (str) and list
    indices (int)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in parts)


def _module_path(key: str) -> list:
    """A state_dict key as the path ``interop.params_to_jax`` gives its
    leaf: dotted names, an all-digit segment a list index."""
    return [int(s) if s.isdigit() else s for s in key.split(".")]


def _walk(tree, prefix, out) -> None:
    if isinstance(tree, dict):
        for k in tree:
            _walk(tree[k], prefix + [k], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, prefix + [i], out)
    elif tree is not None:
        out.append((_keystr(prefix), tree))


def _leaf_paths(tree) -> List[Tuple[str, object]]:
    """``(keypath, leaf)`` pairs sorted by path, so every rank lists them
    alike. A module gives its state_dict's tensors under their
    ``params_to_jax`` paths."""
    out: List[Tuple[str, object]] = []
    if isinstance(tree, torch.nn.Module):
        for key, t in tree.state_dict(keep_vars=True).items():
            out.append((_keystr(_module_path(key)), t))
    else:
        _walk(tree, [], out)
    out.sort(key=lambda kv: kv[0])
    return out


def fingerprint_tree(tree, *, seed: int = 0) -> Dict[str, List]:
    """Per-leaf digests of a parameter tree or a module, keyed by
    keypath. Pulls every leaf to the host: a probe, not a hot path."""
    out = {name: fingerprint_leaf(name, leaf, seed=seed)
           for name, leaf in _leaf_paths(tree)}
    if _enabled:
        _families()["fingerprints"].labels(event="computed").inc()
    return out


def compare_fingerprints(by_rank: Dict[int, Dict[str, List]]
                         ) -> List[Tuple[str, int]]:
    """Majority-compare one step's digests: ``(leaf, rank)`` for every
    rank whose digest of a leaf is not the majority's, leaves in path
    order."""
    if len(by_rank) < 2:
        return []
    leaves = sorted({leaf for d in by_rank.values() for leaf in d})
    out: List[Tuple[str, int]] = []
    for leaf in leaves:
        votes: Dict[tuple, List[int]] = {}
        for rank, digests in by_rank.items():
            votes.setdefault(tuple(digests.get(leaf, [])), []).append(rank)
        if len(votes) <= 1:
            continue
        majority = max(votes.values(), key=len)
        for ranks in votes.values():
            if ranks is not majority:
                out.extend((leaf, r) for r in sorted(ranks))
    return out


_fp_lock = threading.Lock()
_fp_pending: Dict[int, Dict[int, Dict[str, List]]] = {}  # step -> rank -> d


def record_fingerprint(rank: int, step: int, digests: Dict[str, List],
                       world: int) -> List[Tuple[str, int]]:
    """Rank 0's side: keep one rank's digests of a step; once ``world``
    ranks reported (or more than 4 steps wait, when the oldest is
    compared with what arrived), compare and fire one
    ``rank_divergence`` per divergent (leaf, rank). Returns the
    mismatches."""
    ready: Optional[Dict[int, Dict[str, List]]] = None
    ready_step = step
    with _fp_lock:
        _fp_pending.setdefault(step, {})[rank] = digests
        if len(_fp_pending[step]) >= max(world, 2):
            ready = _fp_pending.pop(step)
        elif len(_fp_pending) > 4:
            ready_step = min(_fp_pending)
            ready = _fp_pending.pop(ready_step)
    if ready is None:
        return []
    mismatches = compare_fingerprints(ready)
    fams = _families()
    fams["fingerprints"].labels(event="compared").inc()
    if not mismatches:
        return []
    fams["fingerprints"].labels(event="mismatch").inc(len(mismatches))
    from . import flight_recorder as _flight
    for leaf, bad_rank in mismatches:
        _flight.recorder().note("numerics", (
            "divergence", ready_step, bad_rank, 1, leaf[:120]))
        fire_alert(
            "rank_divergence", "critical",
            f"hvdtpu_numerics_fingerprint:{leaf}", 1.0,
            evidence={"step": ready_step, "rank": bad_rank, "leaf": leaf,
                      "ranks_reporting": sorted(ready)})
    first_leaf, first_rank = mismatches[0]
    _log.error("rank_divergence at step %d: leaf %s on rank %d disagrees "
               "with the majority fingerprint (%d mismatch(es) total)",
               ready_step, first_leaf, first_rank, len(mismatches))
    return mismatches


def reset_fingerprints() -> None:
    """Forget the digests waiting for a compare."""
    with _fp_lock:
        _fp_pending.clear()


def maybe_send_fingerprint(tree, step: int) -> Optional[Dict[str, List]]:
    """Every ``HOROVOD_TPU_NUMERICS_FP_INTERVAL`` steps (50; 0 never):
    digest the tree and send it to rank 0 in the engine's next round
    (rank 0 records its own). Returns the digests when a probe ran."""
    if not _enabled:
        return None
    interval = _env.numerics_fp_interval()
    if interval <= 0 or step % interval != 0:
        return None
    digests = fingerprint_tree(tree)
    rank, world = _process_rank_world()
    eng = _engine()
    if eng is not None and rank > 0:
        eng.note_fingerprint(step, digests)
    else:
        record_fingerprint(rank, step, digests, world)
    return digests


def _engine():
    from ..ops import collective as _coll
    return _coll._engine


def _process_rank_world() -> Tuple[int, int]:
    from .. import topology as _topo
    if _topo.is_initialized():
        t = _topo._get()
        return t.rank, t.size
    return 0, 1


# --------------------------------------------------------------------------
# Deterministic corruption (the bitflip_param fault clause)
# --------------------------------------------------------------------------

@torch.no_grad()
def flip_mantissa_bit(arr, index: int = 0, bit: int = 0):
    """Flip one mantissa bit of element ``index``: a copy for a numpy
    array or a CPU tensor (as JAX returns one), in place for a CUDA
    tensor (returned), through an integer view of the same width."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach() if arr.is_cuda else arr.detach().clone()
        flat = t.view(-1).view(_UINT[t.element_size()])
        flat[index] ^= 1 << bit
        return t
    a = np.array(np.asarray(arr), copy=True)
    u = a.reshape(-1).view(f"u{a.dtype.itemsize}")
    u[index] ^= np.array(1 << bit, dtype=u.dtype)
    return a


def _flip_leaf(tree, target: str):
    """The tree with its leaf at ``target`` flipped: a module's
    parameter in place, a dict/list tree rebuilt around the copy."""
    if isinstance(tree, torch.nn.Module):
        for key, t in tree.state_dict(keep_vars=True).items():
            if _keystr(_module_path(key)) == target:
                new = flip_mantissa_bit(t.data)
                if new is not t.data:
                    with torch.no_grad():
                        t.data.copy_(new)
        return tree

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return type(node)((k, rebuild(v, prefix + [k]))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, prefix + [i])
                              for i, v in enumerate(node))
        if node is not None and _keystr(prefix) == target:
            return flip_mantissa_bit(node)
        return node
    return rebuild(tree, [])


def maybe_bitflip(tree, step: int):
    """Apply an armed ``bitflip_param`` clause at its step: element 0
    of the first leaf whose path holds the clause's ``leaf=`` substring
    (the first leaf when unnamed) gets one flipped mantissa bit. One
    ``is None`` check without an injector; returns the tree."""
    from ..adaptation import faults as _faults_mod
    inj = _faults_mod.injector()
    if inj is None:
        return tree
    patterns = inj.take_bitflips(step)
    for pattern in patterns:
        target = next((name for name, _ in _leaf_paths(tree)
                       if not pattern or pattern in name), None)
        if target is None:
            _log.warning("bitflip_param: no leaf matches %r", pattern)
            continue
        tree = _flip_leaf(tree, target)
        _log.error("fault injection: bitflip_param at step %d flipped "
                   "one mantissa bit in leaf %s", step, target)
    return tree
