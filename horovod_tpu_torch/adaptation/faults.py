"""Declarative fault injection for the training and serving paths.

Counterpart of ``horovod_tpu/adaptation/faults.py``: the same spec
(``HOROVOD_TPU_FAULT_SPEC``), parsed by the same grammar, so one spec
string drives both packages. The training clauses ``delay``,
``slow_h2d`` and ``crash_at`` act in the collective engine's enqueue
(:meth:`FaultInjector.on_enqueue`, one tick per collective submitted)
and ``drop_announce`` in the engine's announcement to rank 0's
coordinator (:meth:`FaultInjector.drop_announce_active`); the serving
clauses ``slow_decode``, ``slow_prefill``, ``replica_crash_at``,
``drop_health`` and ``long_prompt_burst`` in the inference engine's
scheduler and the HTTP front. ``nan_at`` and ``bitflip_param`` parse,
so a spec that names them is valid, but nothing of the port acts on
them yet: they wait for the numerics plane (ROADMAP Queue 1 item 5d).

Grammar (clauses separated by ``;``, fields by ``:``)::

    spec   := clause (';' clause)*
    clause := field (':' field)*
    field  := key ['=' value]

    rank=N | rank=*        which process (serving: replica id) the
                           clause targets (required)
    delay=80ms             sleep per collective enqueued (straggler)
    slow_h2d=2ms           the same, counted as a slow host-to-device
                           copy
    crash_at=N             SIGKILL self at enqueue tick N (after the
                           flight recorder's final dump)
    drop_announce          withhold the announcements to rank 0 while
                           active (the engine keeps joining rounds)
    gen=N                  only in elastic generation / replica
                           incarnation N (default: all)
    from_step=N            first active tick (default 0)
    until_step=N           first tick past the window (default: none)
    replica_crash_at=N     SIGKILL self at decode tick N
    slow_decode=50ms       sleep per batched decode step
    slow_prefill=200ms     sleep per prefill forward
    drop_health            /healthz and /readyz hang up unanswered
                           while active
    long_prompt_burst=NxL  once the tick enters the window, submit N
                           synthetic requests of L-token prompts
                           through the engine's admission gate (bare
                           ``=L`` means N=1); fires once per clause

The training tick is one enqueued collective; the serving tick one
batched decode step. With no spec the
process-global injector is ``None`` and each hook site is one ``is
None`` check. Every injected fault counts into
``hvdtpu_fault_injections_total{kind=}``.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import List, Optional, Tuple

from ..observability import flight_dump, flight_note
from ..observability import registry as _obs
from ..utils import env as _env

_log = logging.getLogger(__name__)

FAULT_SPEC_ENV = "HOROVOD_TPU_FAULT_SPEC"

_DURATION_UNITS = (("ms", 1e-3), ("us", 1e-6), ("s", 1.0))


def _parse_duration(value: str) -> float:
    v = value.strip().lower()
    for suffix, mult in _DURATION_UNITS:
        if v.endswith(suffix):
            return float(v[: -len(suffix)]) * mult
    return float(v)  # bare number = seconds


class FaultClause:
    """One parsed clause of the spec — a set of faults targeted at one
    rank (or ``*``) over one tick window (and optionally one elastic
    generation)."""

    __slots__ = ("rank", "gen", "from_step", "until_step", "delay_s",
                 "slow_h2d_s", "crash_at", "drop_announce",
                 "replica_crash_at", "slow_decode_s", "slow_prefill_s",
                 "drop_health", "long_prompt_burst", "nan_at",
                 "bitflip_param", "leaf")

    def __init__(self):
        self.rank: Optional[int] = None        # None == '*'
        self.gen: Optional[int] = None
        self.from_step = 0
        self.until_step: Optional[int] = None
        self.delay_s = 0.0
        self.slow_h2d_s = 0.0
        self.crash_at: Optional[int] = None
        self.drop_announce = False
        self.replica_crash_at: Optional[int] = None
        self.slow_decode_s = 0.0
        self.slow_prefill_s = 0.0
        self.drop_health = False
        self.long_prompt_burst: Optional[Tuple[int, int]] = None  # (N, L)
        self.nan_at: Optional[int] = None
        self.bitflip_param: Optional[int] = None
        self.leaf = ""                         # bitflip target substring

    def matches(self, rank: int, generation: int) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        if self.gen is not None and self.gen != generation:
            return False
        return True

    def in_window(self, tick: int) -> bool:
        if tick < self.from_step:
            return False
        return self.until_step is None or tick < self.until_step

    def __repr__(self):  # readable in logs/tests
        parts = [f"rank={'*' if self.rank is None else self.rank}"]
        if self.gen is not None:
            parts.append(f"gen={self.gen}")
        if self.delay_s:
            parts.append(f"delay={self.delay_s * 1e3:g}ms")
        if self.slow_h2d_s:
            parts.append(f"slow_h2d={self.slow_h2d_s * 1e3:g}ms")
        if self.crash_at is not None:
            parts.append(f"crash_at={self.crash_at}")
        if self.drop_announce:
            parts.append("drop_announce")
        if self.replica_crash_at is not None:
            parts.append(f"replica_crash_at={self.replica_crash_at}")
        if self.slow_decode_s:
            parts.append(f"slow_decode={self.slow_decode_s * 1e3:g}ms")
        if self.slow_prefill_s:
            parts.append(f"slow_prefill={self.slow_prefill_s * 1e3:g}ms")
        if self.drop_health:
            parts.append("drop_health")
        if self.long_prompt_burst is not None:
            n, plen = self.long_prompt_burst
            parts.append(f"long_prompt_burst={n}x{plen}")
        if self.nan_at is not None:
            parts.append(f"nan_at={self.nan_at}")
        if self.bitflip_param is not None:
            parts.append(f"bitflip_param={self.bitflip_param}")
            if self.leaf:
                parts.append(f"leaf={self.leaf}")
        if self.from_step:
            parts.append(f"from_step={self.from_step}")
        if self.until_step is not None:
            parts.append(f"until_step={self.until_step}")
        return ":".join(parts)


def parse_spec(text: str) -> List[FaultClause]:
    """Parse a full ``HOROVOD_TPU_FAULT_SPEC`` value. Malformed specs
    raise ``ValueError`` naming the offending field — a typo'd fault
    harness must fail loudly at startup, not silently inject nothing."""
    clauses: List[FaultClause] = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        c = FaultClause()
        saw_rank = False
        for field in raw.split(":"):
            field = field.strip()
            if not field:
                continue
            key, sep, value = field.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "rank":
                saw_rank = True
                c.rank = None if value == "*" else int(value)
            elif key == "gen":
                c.gen = int(value)
            elif key == "from_step":
                c.from_step = int(value)
            elif key == "until_step":
                c.until_step = int(value)
            elif key == "delay":
                c.delay_s = _parse_duration(value)
            elif key == "slow_h2d":
                c.slow_h2d_s = _parse_duration(value)
            elif key == "crash_at":
                c.crash_at = int(value)
            elif key == "drop_announce":
                if sep and value not in ("", "1", "true"):
                    raise ValueError(
                        f"drop_announce takes no value, got {value!r}")
                c.drop_announce = True
            elif key == "replica_crash_at":
                c.replica_crash_at = int(value)
            elif key == "slow_decode":
                c.slow_decode_s = _parse_duration(value)
            elif key == "slow_prefill":
                c.slow_prefill_s = _parse_duration(value)
            elif key == "drop_health":
                if sep and value not in ("", "1", "true"):
                    raise ValueError(
                        f"drop_health takes no value, got {value!r}")
                c.drop_health = True
            elif key == "long_prompt_burst":
                # "NxL" (N prompts of L tokens) or bare "L" (one).
                n_s, x, l_s = value.partition("x")
                try:
                    n, plen = (int(n_s), int(l_s)) if x \
                        else (1, int(n_s))
                except ValueError:
                    raise ValueError(
                        f"long_prompt_burst wants NxL or L (prompt "
                        f"tokens), got {value!r}") from None
                if n < 1 or plen < 1:
                    raise ValueError(
                        f"long_prompt_burst counts must be >= 1, "
                        f"got {value!r}")
                c.long_prompt_burst = (n, plen)
            elif key == "nan_at":
                c.nan_at = int(value)
            elif key == "bitflip_param":
                c.bitflip_param = int(value)
            elif key == "leaf":
                c.leaf = value
            else:
                raise ValueError(
                    f"unknown fault-spec field {key!r} in clause {raw!r} "
                    "(expected rank/gen/from_step/until_step/delay/"
                    "slow_h2d/crash_at/drop_announce/replica_crash_at/"
                    "slow_decode/slow_prefill/drop_health/"
                    "long_prompt_burst/nan_at/bitflip_param/leaf)")
        if not saw_rank:
            raise ValueError(
                f"fault-spec clause {raw!r} is missing the required "
                "rank= field (use rank=* to target every rank)")
        clauses.append(c)
    return clauses


class FaultInjector:
    """Per-process injector: the clauses of the spec that target this
    (rank, generation), and the serving tick their windows are evaluated
    against. Hook points:

      - :meth:`on_enqueue` — the collective engine's enqueue (delay,
        slow_h2d, crash_at; every enqueued collective is one tick);
      - :meth:`drop_announce_active` — the engine, before it sends a
        round's announcements to rank 0 (mute-worker fault);
      - :meth:`on_serving_decode` / :meth:`on_serving_prefill` — the
        inference engine's scheduler (slow_decode / slow_prefill /
        replica_crash_at; decode steps drive the tick);
      - :meth:`take_long_prompt_bursts` — the scheduler, at the top of
        every step;
      - :meth:`drop_health_active` — the HTTP front, before answering
        /healthz and /readyz.
    """

    def __init__(self, clauses: List[FaultClause], rank: int,
                 generation: int = 0):
        self.rank = int(rank)
        self.generation = int(generation)
        self.clauses = [c for c in clauses
                        if c.matches(self.rank, self.generation)]
        self._tick = 0
        self._serving_tick = 0
        fam = _obs.registry().counter(
            "hvdtpu_fault_injections_total",
            "Faults injected by the HOROVOD_TPU_FAULT_SPEC harness, "
            "by kind")
        self._m = {k: fam.labels(kind=k)
                   for k in ("delay", "slow_h2d", "crash",
                             "drop_announce", "replica_crash", "slow_decode",
                             "slow_prefill", "drop_health",
                             "long_prompt_burst")}
        self._bursts_fired: set = set()  # clause indices already fired
        if self.clauses:
            _log.warning("fault injection ARMED for rank %d gen %d: %s",
                         self.rank, self.generation,
                         "; ".join(map(repr, self.clauses)))

    def _note_fault(self, kind: str, tick: int) -> None:
        """Flight-recorder breadcrumb, once per 50 ticks of an active
        fault."""
        if tick % 50 == 0 or tick == 0:
            flight_note("fault", (kind, tick))

    # ------------------------------------------------ training hook points

    @property
    def tick(self) -> int:
        return self._tick

    def on_enqueue(self) -> None:
        """One collective enqueued: advance the tick and apply the active
        delay / slow_h2d / crash_at clauses. The crash is a SIGKILL after
        the flight recorder's final dump (a real kill leaves no such
        window; the injector knows it is about to die)."""
        t = self._tick
        self._tick = t + 1
        for c in self.clauses:
            if c.crash_at is not None and t == c.crash_at:
                self._m["crash"].inc()
                _log.error("fault injection: crash_at=%d reached on rank "
                           "%d — SIGKILL self", t, self.rank)
                flight_note("fault", ("crash", t))
                flight_dump("fault_crash")
                os.kill(os.getpid(), signal.SIGKILL)
            if not c.in_window(t):
                continue
            if c.delay_s > 0.0:
                self._m["delay"].inc()
                self._note_fault("delay", t)
                time.sleep(c.delay_s)
            if c.slow_h2d_s > 0.0:
                self._m["slow_h2d"].inc()
                self._note_fault("slow_h2d", t)
                time.sleep(c.slow_h2d_s)

    def drop_announce_active(self) -> bool:
        """True while a drop_announce clause's window covers the current
        tick: the engine then withholds this round's announcements (it
        still joins the round, so only the coordinator's stall report
        can name this mute-but-breathing rank)."""
        for c in self.clauses:
            if c.drop_announce and c.in_window(self._tick):
                self._m["drop_announce"].inc()
                return True
        return False

    # ------------------------------------------------- serving hook points

    @property
    def serving_tick(self) -> int:
        return self._serving_tick

    def _sigkill_self(self, kind: str, tick: int) -> None:
        self._m[kind].inc()
        _log.error("fault injection: %s reached at serving tick %d on "
                   "replica %d — SIGKILL self", kind, tick, self.rank)
        flight_note("fault", (kind, tick))
        flight_dump("fault_crash")
        os.kill(os.getpid(), signal.SIGKILL)

    def on_serving_decode(self) -> None:
        """One batched decode step: advance the serving tick and apply
        slow_decode / replica_crash_at faults. The crash is a SIGKILL
        with the same final-gasp blackbox dump as crash_at — the
        postmortem tool names the replica from it."""
        t = self._serving_tick
        self._serving_tick = t + 1
        for c in self.clauses:
            if c.replica_crash_at is not None and t == c.replica_crash_at:
                self._sigkill_self("replica_crash", t)
            if not c.in_window(t):
                continue
            if c.slow_decode_s > 0.0:
                self._m["slow_decode"].inc()
                self._note_fault("slow_decode", t)
                time.sleep(c.slow_decode_s)

    def on_serving_prefill(self) -> None:
        """One prefill forward: apply slow_prefill (windowed on the
        serving tick; the tick itself only advances on decode steps, so
        a prefill burst cannot skip a replica_crash_at point)."""
        for c in self.clauses:
            if c.slow_prefill_s > 0.0 and c.in_window(self._serving_tick):
                self._m["slow_prefill"].inc()
                self._note_fault("slow_prefill", self._serving_tick)
                time.sleep(c.slow_prefill_s)

    def take_long_prompt_bursts(self) -> List[int]:
        """Prompt lengths to inject right now: each long_prompt_burst
        clause fires ONCE, at the first scheduler step whose serving
        tick falls in its window (the engine consults this at the top
        of every step and submits the synthetic requests itself — the
        injector has no engine handle). Windowed on the decode-driven
        serving tick like every other serving fault."""
        out: List[int] = []
        for i, c in enumerate(self.clauses):
            if c.long_prompt_burst is None or i in self._bursts_fired:
                continue
            if not c.in_window(self._serving_tick):
                continue
            self._bursts_fired.add(i)
            n, plen = c.long_prompt_burst
            self._m["long_prompt_burst"].inc(n)
            self._note_fault("long_prompt_burst", self._serving_tick)
            out.extend([plen] * n)
        return out

    def drop_health_active(self) -> bool:
        """True while a drop_health clause covers the current serving
        tick — the HTTP front then hangs up on /healthz and /readyz
        without a response, so only a probing supervisor can tell this
        replica from a healthy one."""
        for c in self.clauses:
            if c.drop_health and c.in_window(self._serving_tick):
                self._m["drop_health"].inc()
                return True
        return False


# ---------------------------------------------------------------------------
# Process-global resolution — once, lazily, off by default.
# ---------------------------------------------------------------------------

_resolved = False
_injector: Optional[FaultInjector] = None


def injector() -> Optional[FaultInjector]:
    """The process's injector, or None when HOROVOD_TPU_FAULT_SPEC is
    unset / targets other ranks. Resolved once; callers cache the result
    so the disabled path is a single ``is None`` check."""
    global _resolved, _injector
    if _resolved:
        return _injector
    text = _env.fault_spec()
    if not text:
        _resolved = True
        return None
    clauses = parse_spec(text)
    replica = _env.replica_id()
    if replica is not None:
        # A serving replica: the fleet exports its id (and its restart
        # incarnation as the generation).
        rank = replica
    else:
        from .. import topology as _topo
        rank = _topo.rank() if _topo.is_initialized() else 0
    gen = int(os.environ.get("HOROVOD_TPU_ELASTIC_GENERATION", "0") or 0)
    inj = FaultInjector(clauses, rank=rank, generation=gen)
    _injector = inj if inj.clauses else None
    _resolved = True
    return _injector


def reset() -> None:
    """Test hook: forget the resolved injector so the next ``injector()``
    call re-reads the env (mirrors reset_engine())."""
    global _resolved, _injector
    _resolved = False
    _injector = None
