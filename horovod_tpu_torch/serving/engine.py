"""Continuous-batching inference engine — iteration-level scheduling
over a block-sliced KV cache.

Counterpart of ``horovod_tpu/serving/engine.py``: the scheduler is the
JAX engine's host Python, copied, and gives the same tokens from the
same logits. What differs: the engine takes the port's ``Transformer``
(and a drafter ``Transformer``) where JAX's takes ``(params, cfg,
mesh)``; each forward is ``Transformer.apply_decode`` on the engine's
pool, written in place, under ``torch.inference_mode()``; and a tp mesh
of more than one rank is refused (one process drives one card here, so
a tp engine needs rank 0 to schedule and broadcast every step: ROADMAP
Queue 1 item 4c).

The scheduling unit is one *decode step*, not one batch (Orca's
iteration-level scheduling, OSDI '22): every step the engine

  1. **admits** requests from the bounded queue into free batch slots —
     as many as the KV pool can cover (all-or-nothing block
     reservation, kv_cache.py) — running each one's prefill and
     sampling its first token (TTFT ends here);
  2. runs **one batched decode step** for every live slot through the
     tensor-parallel ``apply_decode`` (models/transformer.py), samples
     one token per slot;
  3. **evicts** finished slots (EOS or max-tokens) immediately, freeing
     their blocks for the next admit.

A request therefore joins and leaves the batch mid-flight of everyone
else's generation — no batch-boundary barrier.

Three raw-speed levers ride on top, each independently switchable
(docs/serving.md#speed-levers):

  - **Quantized KV blocks** (``kv_quant="int8"|"fp8"``): the pool holds
    wire-dtype payload + fp32 channel-block scales (quantization.py's
    absmax format at rest), about 2x the resident sequences per byte
    of a bf16 pool; dequant happens on read inside the forward, and prefill
    attends this chunk at full precision so a from-empty prefill is
    bit-identical to the fp32 pool.
  - **Speculative decoding** (``spec_tokens=k`` + a drafter model): a
    small drafter proposes ``k-1`` greedy tokens per step; the flagship
    verifies them in ONE batched ``[slots, k]`` decode forward and
    emits the accepted prefix plus its own correction — up to ``k``
    tokens per flagship call, token-identical to non-speculative greedy
    decode. Rollback of a rejected suffix is free: lengths rewind on
    the host and the garbage K/V is overwritten before it is ever
    visible (the next chunk's scatter covers it).
  - **Shared prefix cache** (``prefix_cache=True``): full prompt blocks
    are indexed by chained hash; a matching prefix reuses the resident
    blocks (refcounted, read-only) and prefill runs only over the
    suffix — a fleet-shared system prompt prefills once per replica,
    not once per request.

Shape discipline: exactly ONE shape per bucket — decode is always
``[slots, 1]``, prefill is ``[1, L]`` with L a power-of-two bucket — so
the shapes a serve runs are bounded by the bucket count. Eager PyTorch
compiles nothing; ``hvdtpu_serving_compiles_total`` counts the first use
of each ``(phase, shape)`` bucket, where JAX counts its compiles.

Correctness invariant the scheduler edge-tests pin down: per-slot
computation is independent (causal mask + disjoint block tables), so a
request's greedy output does not depend on what else is in flight, and
pool exhaustion can only delay *admission* — live sequences always
hold every block they will ever need.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models import transformer as tfm
from ..observability import flight_note
from ..observability import registry as _obs
from ..parallel.collectives import axis_size
from ..topology import resolve_device
from ..utils import env as _env
from . import qos as _qos
from . import reqtrace as _rt
from . import slo as _slo
from .kv_cache import (SCRATCH_BLOCK, BlockAllocator, PrefixCache,
                       SessionLeaseTable, blocks_needed, prefix_hashes)

_log = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """The bounded admission queue is at capacity (HTTP 429)."""


class DrainingError(RuntimeError):
    """The engine is draining (SIGTERM received); no new admissions."""


# Error string a request fails with when its deadline passes before it
# could be served; the HTTP front maps it to 504 (and the router never
# retries an expired request).
DEADLINE_ERROR = "deadline exceeded"


def _metrics():
    r = _obs.registry()
    return {
        "requests": r.counter(
            "hvdtpu_serving_requests_total",
            "Requests by terminal status: completed, rejected (queue "
            "full), failed (draining/validation)"),
        "queue_depth": r.gauge(
            "hvdtpu_serving_queue_depth",
            "Requests waiting for admission").labels(),
        "active": r.gauge(
            "hvdtpu_serving_active_requests",
            "Requests currently holding a batch slot").labels(),
        "occupancy": r.gauge(
            "hvdtpu_serving_batch_occupancy",
            "Fraction of decode batch slots live (the continuous-"
            "batching utilization number)").labels(),
        "kv_total": r.gauge(
            "hvdtpu_serving_kv_blocks_total",
            "Allocatable KV pool blocks (scratch excluded)").labels(),
        "kv_used": r.gauge(
            "hvdtpu_serving_kv_blocks_in_use",
            "KV pool blocks held by live sequences").labels(),
        "tokens": r.counter(
            "hvdtpu_serving_tokens_total",
            "Tokens processed, kind=prompt (prefilled) or "
            "kind=generated"),
        # queue_wait/ttft/tpot are stored as FAMILIES: tenanted
        # requests observe into their {tenant=...} child, untenanted
        # ones into the unlabeled child (_observe_latency), so legacy
        # consumers of the "" series see exactly the pre-tenant shape.
        "queue_wait": r.histogram(
            "hvdtpu_serving_queue_wait_seconds",
            "Submit → admission wait — the queue share of the "
            "per-request latency budget (exemplar: trace id of the "
            "worst recent wait; tenanted requests carry a tenant "
            "label)", buckets=_obs.LATENCY_BUCKETS),
        "ttft": r.histogram(
            "hvdtpu_serving_ttft_seconds",
            "Time to first token: submit → first sampled token "
            "(includes queue wait; exemplar: trace id of the worst "
            "recent request; tenanted requests carry a tenant label)",
            buckets=_obs.LATENCY_BUCKETS),
        "tpot": r.histogram(
            "hvdtpu_serving_tpot_seconds",
            "Time per output token after the first (per live slot per "
            "decode step; tenanted requests carry a tenant label)",
            buckets=_obs.LATENCY_BUCKETS),
        "prefill": r.histogram(
            "hvdtpu_serving_prefill_seconds",
            "Prefill forward duration (per admitted request)",
            buckets=_obs.LATENCY_BUCKETS).labels(),
        "decode_step": r.histogram(
            "hvdtpu_serving_decode_step_seconds",
            "Batched decode step duration (all live slots)",
            buckets=_obs.LATENCY_BUCKETS).labels(),
        "decode_steps": r.counter(
            "hvdtpu_serving_decode_steps_total",
            "Batched decode steps executed"),
        "compiles": r.counter(
            "hvdtpu_serving_compiles_total",
            "Shape buckets first used, phase=prefill (per length "
            "bucket) or phase=decode (once per serve): the shapes JAX's "
            "engine compiles a program for"),
        "slots": r.gauge(
            "hvdtpu_serving_batch_slots",
            "Decode batch width (max concurrent generations) — the "
            "denominator the fleet router's load score divides by"
        ).labels(),
        "qps": r.gauge(
            "hvdtpu_serving_requests_per_second",
            "Completed requests per second over the last 10 s").labels(),
        "kv_bytes": r.gauge(
            "hvdtpu_serving_kv_bytes_resident",
            "KV-pool bytes held by live sequences and the prefix "
            "cache (payload + scales, drafter pool included) — the "
            "number the quantized pool divides by ~4").labels(),
        "prefix_hits": r.counter(
            "hvdtpu_serving_prefix_cache_hits_total",
            "Prompt blocks served from the shared prefix cache "
            "(each hit skips block_size prefill positions)"),
        "prefix_misses": r.counter(
            "hvdtpu_serving_prefix_cache_misses_total",
            "Full prompt blocks that had no cached prefix entry"),
        "draft_proposed": r.counter(
            "hvdtpu_serving_draft_proposed_tokens_total",
            "Tokens proposed by the speculative drafter"),
        "draft_accepted": r.counter(
            "hvdtpu_serving_draft_accepted_tokens_total",
            "Drafter tokens accepted by the flagship's batched "
            "verification (acceptance rate = accepted/proposed)"),
        "decode_tick": r.histogram(
            "hvdtpu_serving_decode_tick_seconds",
            "Gap between consecutive batched decode ticks (start to "
            "start) while slots are decoding — the TPOT-tail bound "
            "chunked prefill holds: with interleaving, at most one "
            "prefill chunk fits in a gap, so its p99 tracks the chunk "
            "budget instead of the longest prompt",
            buckets=_obs.LATENCY_BUCKETS).labels(),
        "prefill_chunks": r.counter(
            "hvdtpu_serving_prefill_chunks_total",
            "Prefill chunks executed by the interleaved chunked-"
            "prefill path (monolithic prefills don't count here)"),
        "session_leases": r.counter(
            "hvdtpu_serving_session_leases_total",
            "Session KV leases formed at request completion "
            "(docs/serving.md#session-affinity)"),
        "session_evictions": r.counter(
            "hvdtpu_serving_session_evictions_total",
            "Session leases sacrificed under pool pressure or the "
            "lease-table cap (demoted to the prefix cache when one "
            "is configured)"),
        "session_hits": r.counter(
            "hvdtpu_serving_session_hits_total",
            "Admissions that resumed from a live session lease "
            "(prefill skipped the stored conversation context)"),
        "shed": r.counter(
            "hvdtpu_serving_shed_total",
            "Requests shed by the QoS plane before prefill, by reason "
            "(quota: over the tenant token-rate quota; deadline_pred: "
            "remaining deadline cannot cover predicted prefill + one "
            "decode step) (docs/serving.md#qos)"),
        "class_queue": r.gauge(
            "hvdtpu_serving_class_queue_depth",
            "Queued requests per QoS priority class "
            "(docs/serving.md#qos)"),
        "class_active": r.gauge(
            "hvdtpu_serving_class_active",
            "Batch slots held per QoS priority class "
            "(docs/serving.md#qos)"),
    }


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Scheduler knobs (docs/serving.md)."""

    block_size: int = 16          # tokens per KV block
    kv_blocks: int = 128          # pool size, scratch block included
    max_batch_slots: int = 8      # decode batch width
    max_queue: int = 32           # bounded admission queue (429 past it)
    max_new_tokens: int = 64      # per-request default
    eos_id: Optional[int] = None  # stop token (None: max-tokens only)
    temperature: float = 0.0      # 0 = greedy; >0 = seeded sampling
    seed: int = 0                 # sampling PRNG seed (deterministic)
    max_blocks_per_seq: Optional[int] = None  # table width; None: from
    #                                           the model's max_seq
    min_prefill_bucket: int = 16  # smallest padded prompt length
    # --- speed levers (docs/serving.md#speed-levers) ---
    kv_quant: Optional[str] = None  # "int8"/"fp8": quantized KV pool
    spec_tokens: int = 0          # speculative verify width k (the
    #                               drafter proposes k-1 tokens/step);
    #                               0 = off, requires a drafter model
    spec_adapt: bool = False      # adapt k per slot from the live
    #                               draft-acceptance rate (AIMD,
    #                               autotune.spec_adapt); spec_tokens
    #                               becomes the CAP, and a cold drafter
    #                               backs off to k=1 (plain decode)
    prefix_cache: bool = False    # shared prompt-prefix block cache
    prefix_cache_entries: Optional[int] = None  # LRU cap (None: pool-
    #                                             pressure eviction only
    prefill_chunk: Optional[int] = None  # chunked prefill: cap on the
    #                               per-chunk bucket (rounded to a
    #                               power-of-two bucket); the step loop
    #                               interleaves one chunk per decode
    #                               tick. None = monolithic prefill.
    session_leases: int = 8       # max session KV leases held between
    #                               conversation turns; 0 disables
    #                               session affinity on this replica
    reserved_slots: int = 0       # batch slots only the top QoS
    #                               priority class (interactive) may
    #                               occupy (docs/serving.md#qos);
    #                               0 = no reservation


class Request:
    """One generation request and its lifecycle record.

    ``deadline`` is an absolute ``time.monotonic()`` instant (or None):
    a queued request past it is failed with ``DEADLINE_ERROR`` instead
    of being admitted — the router's per-request deadline propagation
    maps that to HTTP 504 without retry (docs/serving.md#fleet).

    Tokens are observable *incrementally*: the engine notifies
    :meth:`next_tokens` waiters after every appended token, which is
    what the streaming HTTP path (and through it the router's
    mid-stream failover) consumes.
    """

    def __init__(self, rid: int, prompt: Sequence[int],
                 max_new_tokens: int, temperature: float,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 session_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 slo: Optional["_slo.SloTargets"] = None):
        self.id = rid
        # One trace id end-to-end (docs/serving.md#request-tracing):
        # the router mints it and ships it via X-Request-Id, so the
        # same id names this request in the router, every replica it
        # touches (failover re-dispatch included), the flight
        # recorder, and the metric exemplars. Locally-submitted
        # requests mint a pid-tagged one.
        self.trace_id = str(trace_id) if trace_id else \
            f"{os.getpid():x}.{rid:x}"
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.deadline = deadline          # absolute monotonic, or None
        self.tokens: List[int] = []       # generated tokens
        self.status = "queued"            # queued|active|completed|failed
        self.error: Optional[str] = None
        self.t_submit = time.perf_counter()
        self.t_submit_m = time.monotonic()   # trace-clock twin
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.slot: Optional[int] = None
        self.blocks: List[int] = []
        self.cached_tokens = 0    # prompt tokens resident via shared
        #                           prefix blocks or a session lease
        #                           (prefill skips them)
        self.session_id = str(session_id) if session_id else None
        # SLO attribution (docs/serving.md#slo): ``tenant`` is the
        # RESOLVED bounded-cardinality label (slo.resolve_tenant), or
        # None for untenanted requests (legacy metric shape); ``slo``
        # the resolved targets; ``slo_verdict`` is stamped at _finish.
        self.tenant = tenant
        self.slo = slo
        self.slo_verdict: Optional[dict] = None
        # QoS plane (docs/serving.md#qos): admission class, and
        # whether a DEADLINE_ERROR came from the predictive shed
        # (counted under reason="shed") vs an expiry in queue.
        self.qos_class = _qos.DEFAULT_CLASS
        self.shed = False
        self.prefill_pos: Optional[int] = None  # chunked prefill
        #                           cursor: next prompt position to
        #                           prefill; None = not mid-prefill
        self._prefill_s = 0.0     # accumulated chunk prefill seconds
        self._chunks = 0          # prefill chunks run so far
        self._hashes: List[bytes] = []  # prefix hashes pending insert
        self._n_shared = 0        # leading hashes already cached
        self._done = threading.Event()
        self._progress = threading.Condition()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def _notify(self) -> None:
        """Wake next_tokens() waiters (engine-side, after appending
        tokens or reaching a terminal state)."""
        with self._progress:
            self._progress.notify_all()

    def next_tokens(self, start: int,
                    timeout: Optional[float] = None) -> List[int]:
        """Block until tokens beyond index ``start`` exist (or the
        request is terminal); returns the new slice — empty only once
        terminal. Raises :exc:`TimeoutError` if nothing happens within
        ``timeout``. The consumer side of token streaming."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._progress:
            while len(self.tokens) <= start and not self._done.is_set():
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"request {self.id}: no token progress in "
                        f"{timeout}s")
                self._progress.wait(remaining)
        # list.append is atomic; len() then slice is safe outside the
        # engine lock.
        return self.tokens[start:len(self.tokens)]

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; the generated tokens, or raises the
        failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.status != "completed":
            raise RuntimeError(
                f"request {self.id} {self.status}: {self.error}")
        return list(self.tokens)


def _host(t: torch.Tensor) -> np.ndarray:
    """Logits to host numpy (fp32): the scheduler samples there, with
    numpy's generator, as JAX's engine does."""
    return t.float().cpu().numpy()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class InferenceEngine:
    """Continuous-batching engine over one model.

    ``model`` is the port's ``Transformer`` with the *serving* config
    (``loader.serving_config``: sp, ep and MoE off); ``drafter`` an
    optional smaller ``Transformer`` sharing its vocab, for speculative
    decoding. The engine runs on ``device`` (CUDA unless "cpu" is
    passed), where both models must already be. Thread-safe: ``submit``
    may be called from any thread (the HTTP handlers); ``step`` is the
    single scheduler entry point, driven by one loop thread (or directly
    by tests).
    """

    def __init__(self, model: "tfm.Transformer",
                 config: Optional[ServingConfig] = None, *,
                 drafter: Optional["tfm.Transformer"] = None,
                 device: Union[str, torch.device, None] = None):
        cfg = model.cfg
        if cfg.sp_axis or cfg.ep_axis or cfg.num_experts:
            raise ValueError(
                "serving supports dense tensor-parallel decode only; "
                "build cfg via serving.loader.serving_config()")
        if cfg.tp_axis and axis_size(model.mesh, cfg.tp_axis) > 1:
            raise ValueError(
                "the port's engine serves on one rank: a tp mesh of more "
                "than one rank needs rank 0 to schedule and broadcast each "
                "step (ROADMAP Queue 1 item 4c)")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for m in (model, drafter):
            if m is not None and m.device != self.device:
                raise ValueError(
                    f"the model is on {m.device}, the engine on "
                    f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.config = config or ServingConfig()
        c = self.config
        bs = int(c.block_size)
        self._m = _metrics()

        from .. import quantization as _q
        self._kv_spec = _q.parse(c.kv_quant)

        if c.spec_tokens and drafter is None:
            raise ValueError(
                "spec_tokens is set but no drafter model was given — "
                "pass drafter= (docs/serving.md)")
        self._drafter = drafter
        draft_cfg = drafter.cfg if drafter is not None else None
        self._spec_k = 0
        if drafter is not None:
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"drafter vocab ({draft_cfg.vocab}) must equal the "
                    f"flagship's ({cfg.vocab}) — they share the "
                    "tokenizer")
            if draft_cfg.tp_axis != cfg.tp_axis:
                raise ValueError(
                    "drafter and flagship must agree on tp_axis (both "
                    "run on the engine's one mesh)")
            self._spec_k = int(c.spec_tokens) if c.spec_tokens else 4
            if self._spec_k < 2:
                raise ValueError(
                    f"spec_tokens ({self._spec_k}) must be >= 2: the "
                    "verify chunk holds the last token plus at least "
                    "one draft")
        # Per-slot adaptive draft length (docs/autotune.md#serving):
        # spec_tokens is the cap, each slot's effective k follows its
        # own live acceptance rate.
        self._spec_ctl = None
        if c.spec_adapt:
            if drafter is None:
                raise ValueError(
                    "spec_adapt requires a drafter model (it adapts "
                    "the speculative draft length)")
            from ..autotune.spec_adapt import SpecTokensController
            self._spec_ctl = SpecTokensController(self._spec_k)

        slots = int(c.max_batch_slots)
        if c.reserved_slots < 0 or c.reserved_slots >= slots:
            raise ValueError(
                f"reserved_slots ({c.reserved_slots}) must be in "
                f"[0, max_batch_slots) — reserving every slot would "
                "starve all non-interactive classes")
        max_tab = c.max_blocks_per_seq if c.max_blocks_per_seq \
            else -(-cfg.max_seq // bs)
        self._tab_width = int(max_tab)
        self._slots = slots
        self._alloc = BlockAllocator(c.kv_blocks)
        self._prefix = PrefixCache(self._alloc, c.prefix_cache_entries) \
            if c.prefix_cache else None
        self._sessions = SessionLeaseTable(
            self._alloc, int(c.session_leases)) \
            if c.session_leases else None
        self._m["kv_total"].set(self._alloc.total)
        self._m["slots"].set(slots)

        # Chunked prefill (docs/serving.md#chunked-prefill): the cap is
        # rounded to an existing power-of-two bucket so chunking adds
        # ZERO new compiled shapes; the budget policy below only ever
        # halves within the same bucket family.
        if c.prefill_chunk is not None and int(c.prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {c.prefill_chunk}")
        self._chunk_cap = self._bucket(int(c.prefill_chunk)) \
            if c.prefill_chunk else 0
        self._chunk_cost: Dict[int, float] = {}  # bucket -> EWMA secs
        # QoS plane (docs/serving.md#qos): per-class DWRR admission
        # queues, tenant token-rate quotas, and the measured-cost
        # models the predictive shed reads (monolithic prefill EWMA by
        # bucket — the chunked path reuses _chunk_cost — plus a decode
        # step EWMA as the minimum decode budget).
        self._qos = _qos.policy()
        self._quota = _qos.QuotaLedger(self._qos)
        self._prefill_cost: Dict[int, float] = {}  # bucket -> EWMA s
        self._decode_cost = 0.0                    # EWMA secs/step
        budget_ms = _env.serving_tick_budget_ms()
        self._tick_budget_s = None if budget_ms is None \
            else budget_ms / 1e3
        self._t_last_tick: Optional[float] = None

        # Serving fault injection (docs/adaptation.md): slow_decode /
        # slow_prefill / replica_crash_at ride the same declarative spec
        # as the training faults; resolved once, a single `is None`
        # check per step when unset.
        from ..adaptation import faults as _faults
        self._inj = _faults.injector()

        # The pools live on the device for the engine's lifetime; every
        # forward writes them in place.
        self._cache = model.init_cache(c.kv_blocks, bs, self._kv_spec)
        self._bytes_per_block = tfm.kv_bytes_per_block(
            cfg, bs, self._kv_spec)
        if drafter is not None:
            self._draft_cache = drafter.init_cache(c.kv_blocks, bs,
                                                   self._kv_spec)
            self._bytes_per_block += tfm.kv_bytes_per_block(
                draft_cfg, bs, self._kv_spec)

        # host mirrors of the device-side scheduling state
        self._tables = np.full((slots, self._tab_width), SCRATCH_BLOCK,
                               np.int32)
        self._lengths = np.zeros((slots,), np.int32)    # cached tokens
        self._last_tok = np.zeros((slots,), np.int32)   # next input
        self._reqs: List[Optional[Request]] = [None] * slots

        self._queue = _qos.ClassQueues(self._qos.class_weights())
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._draining = False
        self._next_id = 0
        self._rng = np.random.default_rng(c.seed)
        self._completions: deque = deque()  # perf_counter stamps

        self._fwd = self._build_fwd(model, self._cache, exact_chunk=False)
        # Prefill reads this chunk at full precision (prefill-exact
        # parity with the unquantized pool); without quantization the
        # flag changes nothing, so the decode forward is reused.
        self._fwd_prefill = self._build_fwd(model, self._cache,
                                            exact_chunk=True) \
            if self._kv_spec is not None else self._fwd
        if drafter is not None:
            self._dfwd = self._build_fwd(drafter, self._draft_cache,
                                         exact_chunk=False)
            self._dfwd_prefill = self._build_fwd(
                drafter, self._draft_cache, exact_chunk=True) \
                if self._kv_spec is not None else self._dfwd
        self._buckets_seen: set = set()

    # ------------------------------------------------------- submission

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               session_id: Optional[str] = None,
               tenant: Optional[str] = None,
               slo=None) -> Request:
        """Enqueue a request; returns immediately with its ticket.
        Raises :exc:`QueueFullError` past ``max_queue`` (the HTTP 429
        path) and :exc:`DrainingError` after drain began.

        ``deadline_s`` is a *relative* budget in seconds (the router
        propagates the client's remaining deadline per hop): a request
        still queued when it expires fails with ``DEADLINE_ERROR``
        instead of occupying a slot. ``trace_id`` is the caller's
        end-to-end request identity (the router's ``X-Request-Id``);
        None mints a local one. ``session_id`` names a conversation
        (docs/serving.md#session-affinity): completion stores a KV
        lease under it, and a later turn whose prompt extends the
        stored context resumes decoding instead of re-prefilling.

        ``tenant``/``slo`` attach SLO attribution
        (docs/serving.md#slo): the tenant name is collapsed to a
        bounded-cardinality label, the targets resolve request-field >
        tenant config > env defaults, and the completed request is
        stamped with a ``slo_verdict``."""
        c = self.config
        # Resolve SLO attribution before validation: a shed (queue
        # full) request must still be attributable to its tenant.
        tlabel = _slo.resolve_tenant(tenant) if (tenant or slo) \
            else None
        targets = _slo.policy().resolve(tenant, slo)
        if targets is not None and tlabel is None:
            tlabel = _slo.resolve_tenant(tenant)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else c.max_new_tokens)
        temp = float(temperature if temperature is not None
                     else c.temperature)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.cfg.vocab for t in prompt):
            raise ValueError(f"prompt token out of range "
                             f"[0, {self.cfg.vocab})")
        if len(prompt) + max_new > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the model's max_seq ({self.cfg.max_seq})")
        need = blocks_needed(len(prompt), max_new, c.block_size)
        if need > min(self._alloc.total, self._tab_width):
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds "
                f"{self._alloc.total} (table width {self._tab_width}) "
                "— raise kv_blocks or lower max_new_tokens")
        with self._lock:
            if self._draining:
                raise DrainingError("server is draining")
            if len(self._queue) >= c.max_queue:
                self._count_request("rejected", tlabel)
                # Shed load stays visible in goodput math
                # (docs/serving.md#slo): the 429 path attributes the
                # rejection to its tenant.
                _slo.record_shed(tlabel or _slo.DEFAULT_TENANT, "shed")
                raise QueueFullError(
                    f"admission queue full ({c.max_queue})")
            # Token-rate quota (docs/serving.md#qos): charged AFTER
            # the queue-full gate so a rejected request never burns
            # bucket tokens. Retry-After comes from the tenant's own
            # measured drain rate, not the global queue estimate.
            retry = self._quota.admit(
                tlabel, len(prompt) + max_new) if tlabel else None
            if retry is not None:
                self._count_request("rejected", tlabel)
                _slo.record_shed(tlabel or _slo.DEFAULT_TENANT, "shed")
                self._m["shed"].labels(reason="quota").inc()
                raise _qos.QuotaExceededError(retry, tenant=tlabel)
            deadline = None if deadline_s is None \
                else time.monotonic() + float(deadline_s)
            req = Request(self._next_id, prompt, max_new, temp,
                          deadline=deadline, trace_id=trace_id,
                          session_id=session_id, tenant=tlabel,
                          slo=targets)
            req.qos_class = self._qos.class_of(tlabel)
            self._next_id += 1
            self._queue.append(req)
            self._m["queue_depth"].set(len(self._queue))
            self._work.notify()
            return req

    def generate(self, prompt: Sequence[int], *,
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None) -> List[int]:
        """Synchronous single-request convenience: submit + drive the
        scheduler until THIS request finishes (single-threaded use;
        under a running serve loop, use submit().result())."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature)
        while not req.done:
            if not self.step():
                time.sleep(0.001)
        return req.result()

    # -------------------------------------------------------- scheduler

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._reqs if r is not None)

    @property
    def _decodable_count(self) -> int:
        """Live slots past prefill — the batched decode's real width
        (mid-chunked-prefill slots are masked out of decode calls)."""
        return sum(1 for r in self._reqs
                   if r is not None and r.prefill_pos is None)

    def session_ids(self) -> List[str]:
        """Live session-lease ids (LRU-oldest first) — advertised via
        ``/healthz`` so the fleet router can pin leased sessions."""
        with self._lock:
            if self._sessions is None:
                return []
            return self._sessions.ids()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        with self._lock:
            return self.active_count == 0 and not self._queue

    def retry_after_s(self) -> int:
        """Back-off hint for a 429: how long until the bounded queue
        has plausibly drained, from the measured completion rate (the
        same 10 s window behind ``hvdtpu_serving_requests_per_second``)
        plus — under chunked prefill — the prefill backlog itself.
        With interleaving, drain is paced by chunks-per-tick, not whole
        prefills: a queue of long prompts admits fast but takes
        ``pending_chunks × per-chunk seconds`` to actually prefill, so
        that term is added on top of the completion-rate estimate.
        Clamped to [1, 60] whole seconds — a cold server (no completions
        yet, no chunk backlog) answers 1 rather than guessing."""
        with self._lock:
            depth = len(self._queue) + self.active_count
            rate = len(self._completions) / 10.0
            chunk_s = self._chunk_backlog_s()
        if rate <= 0.0:
            if chunk_s > 0.0:
                return max(1, min(60, math.ceil(chunk_s)))
            return 1
        return max(1, min(60, math.ceil(depth / rate + chunk_s)))

    def _chunk_backlog_s(self) -> float:
        """Estimated seconds of interleaved prefill work outstanding:
        chunks still owed by mid-prefill slots plus chunks the queued
        prompts will need, priced at the measured per-chunk cost (the
        cap bucket's EWMA; the worst measured bucket as fallback).
        0 when chunking is off or nothing is pending — callers under
        the engine lock."""
        cap = self._chunk_cap
        if not cap:
            return 0.0
        cost = self._chunk_cost.get(cap)
        if cost is None:
            cost = max(self._chunk_cost.values(), default=0.0)
        if cost <= 0.0:
            return 0.0
        chunks = 0
        for r in self._reqs:
            if r is not None and r.prefill_pos is not None:
                chunks += -(-(len(r.prompt) - r.prefill_pos) // cap)
        for r in self._queue:
            chunks += -(-len(r.prompt) // cap)
        return chunks * cost

    def step(self) -> bool:
        """One scheduler iteration: admit → at most ONE prefill chunk →
        batched decode → evict. Returns True when any work was done.

        The single-chunk rule is the tentpole latency bound: a long
        prompt's prefill is spread across ticks instead of running
        start-to-finish between two decode steps, so the decode-tick
        gap every live slot experiences is bounded by one chunk (the
        budget policy sizes it under
        ``HOROVOD_TPU_SERVING_TICK_BUDGET_MS``), not by the longest
        prompt in the mix."""
        with self._lock:
            if self._inj is not None:
                for plen in self._inj.take_long_prompt_bursts():
                    self._inject_long_prompt(plen)
            admitted = self._admit()
            worked = admitted > 0
            if self._prefill_tick():
                worked = True
            if self._decodable_count:
                self._decode_step()
                worked = True
            else:
                # No decode ran: a gap across an idle stretch is not a
                # tick the histogram should count.
                self._t_last_tick = None
            self._update_gauges()
            return worked

    def wait_for_work(self, timeout: float) -> None:
        """Serve-loop parking: block until a submit arrives (or
        timeout) instead of spinning on an idle engine."""
        with self._work:
            if self.idle and not self._draining:
                self._work.wait(timeout)

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError("run_until_idle: scheduler did not converge")

    def drain(self) -> None:
        """Graceful shutdown: refuse NEW submissions, then finish every
        request already accepted — live slots decode to completion AND
        queued requests are still admitted as slots/blocks free up.

        An accepted request is a promise (its client got past the
        429/503 gate); whether the scheduler thread happened to admit it
        before SIGTERM landed must not decide its fate — the old
        fail-the-queue behavior made drain outcomes race the prefill
        phase (the regression test injects a slow_prefill fault to pin
        the window open). Zero requests dropped by a drain is the fleet
        tier's base invariant (docs/serving.md#fleet)."""
        with self._lock:
            self._draining = True
            waiting = self.active_count + len(self._queue)
        flight_note("serving", ("drain", waiting))
        while True:
            with self._lock:
                self._admit()
                if self.active_count == 0 and not self._queue:
                    self._update_gauges()
                    break
                self._prefill_tick()
                if self._decodable_count:
                    self._decode_step()
                self._update_gauges()
        flight_note("serving", ("drained", 0))

    # -------------------------------------------------------- internals

    def _build_fwd(self, model: "tfm.Transformer", pool: List[Dict],
                   exact_chunk: bool):
        """``fwd(tokens, starts, tables) -> logits`` for ``model`` over
        ``pool``, which the forward writes in place (JAX's engine
        donates its pool to a jitted program). Host arrays go to the
        device here; logits stay on it."""
        kvq = self._kv_spec
        dev = self.device

        def fwd(tokens, starts, tables):
            with torch.inference_mode():
                logits, _ = model.apply_decode(
                    torch.as_tensor(tokens).to(dev),
                    torch.as_tensor(starts).to(dev),
                    torch.as_tensor(tables).to(dev), pool,
                    kv_quant=kvq, exact_chunk=exact_chunk)
            return logits

        return fwd

    def _admit(self) -> int:
        """Move queued requests into free slots while the pool covers
        them, running each prefill immediately (this is the per-step
        admission that makes the batching *continuous*).

        Selection is deficit-weighted round robin over the per-class
        queues (docs/serving.md#qos), with ``reserved_slots`` batch
        slots only the top priority class may occupy, and a predictive
        shed at each class head: a deadline that cannot cover the
        measured prefill cost plus one decode step fails NOW (504)
        instead of burning a slot on an answer that would miss
        anyway."""
        admitted = 0
        c = self.config
        while True:
            now = time.monotonic()
            doomed = None
            for r in self._queue.heads():
                if r.deadline is None:
                    continue
                if now > r.deadline:
                    # Expired while queued: fail instead of burning a
                    # slot on an answer nobody waits for (HTTP 504).
                    doomed = r
                    break
                if _qos.shed_decision(r.deadline - now,
                                      self._predict_prefill_s(r),
                                      self._decode_cost):
                    r.shed = True
                    doomed = r
                    break
            if doomed is not None:
                self._queue.remove(doomed)
                if doomed.shed:
                    self._m["shed"].labels(
                        reason="deadline_pred").inc()
                    flight_note(
                        "qos", ("shed", doomed.trace_id,
                                f"class={doomed.qos_class}"))
                self._finish(doomed, "failed", error=DEADLINE_ERROR)
                continue
            if not self._queue:
                break
            slot = next((i for i, r in enumerate(self._reqs)
                         if r is None), None)
            if slot is None:
                break
            # Reserved-slot invariant: non-top classes may never hold
            # more than max_batch_slots - reserved_slots slots, so a
            # full bulk backlog still leaves room for interactive.
            non_top = sum(1 for r in self._reqs if r is not None
                          and r.qos_class != _qos.TOP_CLASS)
            cap = self._slots - c.reserved_slots

            def allowed(cls, _non_top=non_top, _cap=cap):
                return cls == _qos.TOP_CLASS or _non_top < _cap

            req = self._queue.select(allowed)
            if req is None:
                break   # only reservation-blocked classes are queued
            bs = self.config.block_size
            need = blocks_needed(len(req.prompt), req.max_new_tokens,
                                 bs)
            # Session-lease probe (docs/serving.md#session-affinity):
            # a prompt that EXTENDS its session's stored conversation
            # resumes from the lease's resident blocks — the whole
            # previous context (generated tokens included, which the
            # prefix cache never indexes) skips prefill. A divergent
            # turn releases the stale lease instead: partial reuse
            # could rewrite blocks the prefix cache shares.
            lease = None
            if self._sessions is not None and req.session_id:
                peek = self._sessions.get(req.session_id)
                if peek is not None:
                    ln = peek.n_tokens
                    if len(req.prompt) >= ln \
                            and req.prompt[:ln] == peek.tokens:
                        lease = self._sessions.pop(req.session_id)
                        self._m["session_hits"].inc()
                    else:
                        self._sessions.release(
                            self._sessions.pop(req.session_id))
            lease_blocks = lease.blocks if lease is not None else []
            # Resume must re-run at least one prompt token (its forward
            # produces the first-token logits), so the cached cursor
            # stops one short of a prompt that matches end-to-end.
            lease_tokens = 0 if lease is None \
                else min(lease.n_tokens, len(req.prompt) - 1)
            # Prefix-cache probe: matching leading FULL prompt blocks
            # are shared (incref'd, read-only) instead of re-prefilled.
            # Skipped on a lease hit — the lease already covers more.
            hashes: List[bytes] = []
            shared: List[int] = []
            if lease is None and self._prefix is not None:
                hashes = prefix_hashes(req.prompt, bs)
                shared = self._prefix.lookup(hashes)
            fresh = self._alloc.alloc(
                need - len(shared) - len(lease_blocks))
            while fresh is None and self._free_pressure():
                # Pool pressure: cached-but-idle prefix blocks and then
                # parked session leases yield to a live admission.
                fresh = self._alloc.alloc(
                    need - len(shared) - len(lease_blocks))
            if fresh is None:
                for b in shared:       # roll the probe's holds back
                    self._alloc.decref(b)
                if lease is not None:  # park the consumed lease again
                    self._sessions.put(req.session_id, lease.tokens,
                                       lease.blocks)
                self._queue.pushback(req)  # DWRR deficit refunded
                break    # pool exhausted: nothing admits, nothing evicts
            if self._prefix is not None and lease is None:
                self._m["prefix_hits"].inc(len(shared))
                self._m["prefix_misses"].inc(len(hashes) - len(shared))
            t_admit_m = time.monotonic()
            self._observe_latency(
                "queue_wait", time.perf_counter() - req.t_submit,
                tenant=req.tenant, exemplar=req.trace_id)
            req.blocks = lease_blocks + shared + fresh
            req.cached_tokens = lease_tokens if lease is not None \
                else len(shared) * bs
            req._hashes = hashes
            req._n_shared = len(shared)
            req.slot = slot
            req.status = "active"
            self._reqs[slot] = req
            self._tables[slot, :] = SCRATCH_BLOCK
            self._tables[slot, :need] = req.blocks
            flight_note(
                "request", ("admit", req.trace_id,
                            f"slot={slot} blocks={need} "
                            f"cached={req.cached_tokens}"))
            w = _rt.writer()
            if w is not None:
                w.request_span(req.trace_id, "QUEUE_WAIT",
                               req.t_submit_m, t_admit_m)
                w.request_span(req.trace_id, "ADMIT", t_admit_m,
                               time.monotonic(),
                               {"blocks": need,
                                "prefix_tokens": req.cached_tokens})
            if self._chunk_cap:
                # Chunked prefill: admission only reserves; the chunks
                # run one per tick from _prefill_tick, interleaved with
                # everyone else's decode.
                req.prefill_pos = req.cached_tokens
            else:
                self._prefill(req)
            admitted += 1
        self._m["queue_depth"].set(len(self._queue))
        return admitted

    def _bucket(self, n: int) -> int:
        b = max(self.config.min_prefill_bucket, _next_pow2(n))
        return min(b, self.cfg.max_seq)

    def _predict_prefill_s(self, req: Request) -> float:
        """Predicted prefill seconds for a queued request, from the
        measured per-bucket EWMA of whichever prefill path this engine
        runs (docs/serving.md#qos). 0.0 until the model warms up —
        the predictive shed never fires on a guess."""
        n = len(req.prompt)
        if self._chunk_cap:
            return _qos.predict_prefill_s(
                n, self._chunk_cost, self._bucket,
                chunk_tokens=self._chunk_cap)
        return _qos.predict_prefill_s(
            n, self._prefill_cost, self._bucket)

    def _record_bucket(self, phase: str, key) -> None:
        if (phase, key) not in self._buckets_seen:
            self._buckets_seen.add((phase, key))
            self._m["compiles"].labels(phase=phase).inc()

    def _free_pressure(self) -> bool:
        """Reclaim one cached-but-idle resource under pool pressure:
        prefix-cache entries first (cheapest to lose — one block each),
        then whole session leases, LRU first, demoted to the prefix
        cache as the degraded tier. True while something yielded."""
        if self._prefix is not None and self._prefix.evict_one():
            return True
        if self._sessions is not None and self._sessions.evict_one(
                self._prefix, self.config.block_size):
            self._m["session_evictions"].inc()
            return True
        return False

    def _run_prefill(self, req: Request, start: int, ns: int,
                     L: int) -> Any:
        """One prefill forward over ``prompt[start:start+ns]`` padded
        to bucket ``L`` — the shared core of monolithic and chunked
        prefill. The drafter (when present) prefills the same chunk on
        its own pool, same tables, same positions. Returns the
        flagship logits (``[1, L, vocab]``; row ``ns-1`` is the
        distribution after the last real token)."""
        self._record_bucket("prefill", L)
        toks = np.zeros((1, L), np.int32)
        toks[0, :ns] = req.prompt[start:start + ns]
        starts = np.full((1,), start, np.int32)
        tabs = self._tables[req.slot:req.slot + 1]
        logits = self._fwd_prefill(toks, starts, tabs)
        if self._drafter is not None:
            # The drafter's pool shares the block tables, so its prefix
            # blocks are shared by the same admission decision.
            self._record_bucket("draft_prefill", L)
            self._dfwd_prefill(toks, starts, tabs)
        self._m["tokens"].labels(kind="prompt").inc(ns)
        return logits

    def _emit_first_token(self, req: Request,
                          logits_row: np.ndarray) -> None:
        """Sample the first token from the final prefill logits row —
        TTFT ends here for both prefill shapes."""
        first = self._sample(logits_row, req)
        req.t_first_token = time.perf_counter()
        req.tokens.append(first)
        req._notify()
        self._last_tok[req.slot] = first
        self._observe_latency("ttft", req.t_first_token - req.t_submit,
                              tenant=req.tenant, exemplar=req.trace_id)
        self._m["tokens"].labels(kind="generated").inc()
        flight_note(
            "request", ("first_token", req.trace_id,
                        f"ttft_ms={round((req.t_first_token - req.t_submit) * 1e3, 1)}"))

    def _index_prefix(self, req: Request) -> None:
        """Index this prompt's freshly-prefilled full blocks so the
        NEXT matching prompt shares them (first writer wins). Runs
        right after the last prefill forward — before _check_finished
        can evict the slot and hand the blocks back."""
        if self._prefix is None or not req._hashes:
            return
        for j in range(req._n_shared, len(req._hashes)):
            self._prefix.insert(req._hashes[j],
                                int(self._tables[req.slot, j]))
        req._hashes = []

    def _prefill(self, req: Request) -> None:
        """Monolithic prefill: the whole prompt suffix in one bucketed
        forward at admission (the chunking-off path)."""
        # Span epoch BEFORE the fault hook: an injected slow_prefill is
        # latency the request experienced — it must land INSIDE the
        # PREFILL span, or the budget report under-attributes.
        t0m = time.monotonic()
        if self._inj is not None:
            self._inj.on_serving_prefill()
        t0 = time.perf_counter()
        n = len(req.prompt)
        c = req.cached_tokens   # resident via prefix blocks or a lease
        ns = n - c
        L = self._bucket(ns)
        compile_new = ("prefill", L) not in self._buckets_seen
        logits = self._run_prefill(req, c, ns, L)
        self._lengths[req.slot] = n
        dt = time.perf_counter() - t0
        self._m["prefill"].observe(dt)
        if not compile_new:
            # Steady-state per-bucket cost for the predictive shed
            # (first-run compile time is not prefill cost).
            prev = self._prefill_cost.get(L)
            self._prefill_cost[L] = dt if prev is None \
                else 0.5 * prev + 0.5 * dt
        self._emit_first_token(req, _host(logits[0, ns - 1]))
        w = _rt.writer()
        if w is not None:
            w.request_span(req.trace_id, "PREFILL", t0m,
                           time.monotonic(),
                           {"bucket": L, "tokens": ns, "cached": c,
                            "compile": compile_new})
        self._index_prefix(req)
        self._check_finished(req)

    def _chunk_len(self, remaining: int) -> int:
        """Budget policy: the next chunk's bucket. Start from the
        configured cap (or what's left of the prompt, if smaller) and
        halve while the bucket's measured cost exceeds the tick budget
        — never below the engine's smallest prefill bucket, and only
        through buckets the engine would compile anyway. Unmeasured
        buckets run optimistically (their first timed run seeds the
        cost model)."""
        L = self._bucket(min(remaining, self._chunk_cap))
        floor = self._bucket(1)
        if self._tick_budget_s is not None:
            while L > floor:
                cost = self._chunk_cost.get(L)
                if cost is None or cost <= self._tick_budget_s:
                    break
                L //= 2
            L = max(L, floor)
        return L

    def _note_chunk_cost(self, L: int, dt: float) -> None:
        prev = self._chunk_cost.get(L)
        self._chunk_cost[L] = dt if prev is None \
            else 0.5 * prev + 0.5 * dt

    def _prefill_tick(self) -> bool:
        """Run at most ONE prefill chunk — the oldest mid-prefill
        request's next chunk — between decode ticks. Returns True when
        a chunk ran. The final chunk flips the request live: lengths
        advance, the first token is sampled from its logits, and the
        next decode tick picks the slot up."""
        pending = [r for r in self._reqs
                   if r is not None and r.prefill_pos is not None]
        if not pending:
            return False
        req = min(pending, key=lambda r: r.id)
        t0m = time.monotonic()
        if self._inj is not None:
            self._inj.on_serving_prefill()
        t0 = time.perf_counter()
        n = len(req.prompt)
        pos = req.prefill_pos
        remaining = n - pos
        L = self._chunk_len(remaining)
        ns = min(remaining, L)
        compile_new = ("prefill", L) not in self._buckets_seen
        logits = self._run_prefill(req, pos, ns, L)
        dt = time.perf_counter() - t0
        if not compile_new:
            # First-run compile time is not steady-state chunk cost.
            self._note_chunk_cost(L, dt)
        req._prefill_s += dt
        req._chunks += 1
        req.prefill_pos = pos + ns
        self._m["prefill_chunks"].inc()
        w = _rt.writer()
        if w is not None:
            w.request_span(req.trace_id, "PREFILL", t0m,
                           time.monotonic(),
                           {"bucket": L, "tokens": ns, "cached": pos,
                            "compile": compile_new,
                            "chunk": req._chunks})
        if req.prefill_pos >= n:
            req.prefill_pos = None
            self._lengths[req.slot] = n
            self._m["prefill"].observe(req._prefill_s)
            self._emit_first_token(req, _host(logits[0, ns - 1]))
            self._index_prefix(req)
            self._check_finished(req)
        return True

    def _inject_long_prompt(self, plen: int) -> None:
        """A ``long_prompt_burst`` fault's synthetic request:
        deterministic oversized prompt, clamped to what this model can
        hold, submitted through the ordinary admission gate (a full
        queue drops it with a warning — the burst is adversarial load,
        not a correctness obligation)."""
        vocab = self.cfg.vocab
        plen = max(1, min(int(plen), self.cfg.max_seq - 1))
        max_new = max(1, min(int(self.config.max_new_tokens),
                             self.cfg.max_seq - plen))
        prompt = [(7 + 13 * i) % vocab for i in range(plen)]
        try:
            self.submit(prompt, max_new_tokens=max_new,
                        trace_id=f"fault.burst.{self._next_id:x}")
        except (QueueFullError, DrainingError, ValueError) as e:
            _log.warning("long_prompt_burst request dropped: %s", e)

    def _decode_views(self) -> Tuple[np.ndarray, np.ndarray]:
        """Block tables / lengths for a batched decode call. Slots
        still mid-chunked-prefill are masked to the empty-slot shape
        (scratch table, length 0): a decode forward over them would
        scatter garbage K/V into their REAL blocks at the positions
        the remaining chunks are about to write."""
        if not any(r is not None and r.prefill_pos is not None
                   for r in self._reqs):
            return self._tables, self._lengths
        tabs = self._tables.copy()
        lens = self._lengths.copy()
        for s, r in enumerate(self._reqs):
            if r is not None and r.prefill_pos is not None:
                tabs[s, :] = SCRATCH_BLOCK
                lens[s] = 0
        return tabs, lens

    def _decode_step(self) -> None:
        # Tick-gap histogram: start-to-start of consecutive batched
        # decode ticks — an interleaved prefill chunk lands inside one
        # gap, which is exactly the tail this PR bounds.
        now = time.perf_counter()
        if self._t_last_tick is not None:
            self._m["decode_tick"].observe(now - self._t_last_tick)
        self._t_last_tick = now
        tabs_h, lens_h = self._decode_views()
        if self._drafter is not None:
            ctl = self._spec_ctl
            if ctl is None:
                self._spec_decode_step()
                return
            live = [s for s, r in enumerate(self._reqs)
                    if r is not None and r.prefill_pos is None]
            width = ctl.width(live) if live else 1
            if width > 1:
                # Verify at the widest live slot's k; narrower slots
                # cap their accepted run at their own k_eff below.
                self._spec_decode_step(width)
                return
            # Every live slot backed off to k=1: take the plain decode
            # path (no verify-width tax), but keep the drafter's KV
            # cache in step with the true context — one cheap [slots,1]
            # drafter call — so a probe step's proposals are grounded,
            # and tick each slot's probe clock.
            self._record_bucket("draft", 1)
            self._dfwd(self._last_tok[:, None], lens_h, tabs_h)
            for s in live:
                ctl.note_plain_step(s)
        t0m = time.monotonic()   # before the fault hook (slow_decode
        #                          belongs inside the DECODE span)
        if self._inj is not None:
            self._inj.on_serving_decode()
        t0 = time.perf_counter()
        decode_warm = ("decode", self._slots) in self._buckets_seen
        self._record_bucket("decode", self._slots)
        logits = self._fwd(self._last_tok[:, None], lens_h, tabs_h)
        lg = _host(logits[:, 0])
        dt = time.perf_counter() - t0
        self._m["decode_step"].observe(dt)
        self._m["decode_steps"].inc()
        if decode_warm:
            # Minimum decode budget for the predictive shed
            # (docs/serving.md#qos); compile runs excluded.
            self._decode_cost = dt if self._decode_cost <= 0.0 \
                else 0.5 * self._decode_cost + 0.5 * dt
        w = _rt.writer()
        for slot, req in enumerate(self._reqs):
            if req is None or req.prefill_pos is not None:
                continue
            # the input token's K/V is cached now; its position is used
            self._lengths[slot] += 1
            tok = self._sample(lg[slot], req)
            req.tokens.append(tok)
            req._notify()
            self._last_tok[slot] = tok
            self._observe_latency("tpot", dt, tenant=req.tenant,
                                  exemplar=req.trace_id)
            self._m["tokens"].labels(kind="generated").inc()
            if w is not None:
                # The step wall as THIS request experienced it — the
                # decode share of its latency budget.
                w.request_span(req.trace_id, "DECODE", t0m,
                               time.monotonic(), {"n": 1})
            self._check_finished(req)

    def _spec_decode_step(self, k: Optional[int] = None) -> None:
        """Speculative decode step: the drafter proposes ``k-1`` greedy
        tokens per slot (k-1 cheap ``[slots, 1]`` calls on its own
        cache), the flagship verifies them in ONE batched ``[slots, k]``
        forward, and each slot advances by its accepted prefix plus the
        flagship's correction token — between 1 and k tokens per
        flagship call, greedy output token-identical to the
        non-speculative path (the emitted tokens ARE the flagship's
        argmaxes under the true prefix).

        Rollback of a rejected suffix is host-side only: ``_lengths``
        simply doesn't advance over it. The garbage K/V those positions
        hold is overwritten by the next chunk's scatter before any
        query can see it (chunks are a constant k wide and start where
        the accepted prefix ended, so the rewritten span always covers
        the stale one; with spec_adapt the width can shrink between
        steps, which is equally safe — each chunk writes contiguously
        from the current length, and causal queries never read past
        their own chunk).

        With spec_adapt, ``k`` is the widest live slot's adaptive
        width; each slot caps its ACCEPTED run at its own k_eff and
        feeds its raw (uncapped) acceptance back to the controller."""
        t0m = time.monotonic()   # before the fault hook, like
        #                          _decode_step
        if self._inj is not None:
            self._inj.on_serving_decode()
        t0 = time.perf_counter()
        if k is None:
            k = self._spec_k
        ctl = self._spec_ctl
        n_live = self._decodable_count
        tabs_h, lens_h = self._decode_views()

        # Drafter proposals: greedy chain on the drafter's own pool,
        # same block tables, same positions.
        d_len = lens_h.copy()
        cur = self._last_tok.copy()
        proposals = np.zeros((self._slots, k - 1), np.int32)
        for i in range(k - 1):
            self._record_bucket("draft", 1)
            dlg = self._dfwd(cur[:, None], d_len, tabs_h)
            cur = np.argmax(_host(dlg[:, 0]), axis=-1).astype(np.int32)
            proposals[:, i] = cur
            d_len += 1
        self._m["draft_proposed"].inc((k - 1) * n_live)

        # One batched verification: feed [last_tok, d_1..d_{k-1}]; row
        # i of the logits is the flagship's next-token distribution
        # after the first i+1 of those inputs.
        feed = np.concatenate([self._last_tok[:, None], proposals],
                              axis=1)
        self._record_bucket("decode", (self._slots, k))
        logits = self._fwd(feed, lens_h, tabs_h)
        lg = _host(logits)                # [slots, k, vocab]
        greedy = lg.argmax(axis=-1)       # [slots, k]
        dt = time.perf_counter() - t0
        self._m["decode_step"].observe(dt)
        self._m["decode_steps"].inc()

        w = _rt.writer()
        for slot, req in enumerate(self._reqs):
            if req is None or req.prefill_pos is not None:
                continue
            if req.temperature > 0.0:
                # Sampled slots take one token from the true next-token
                # logits (row 0) — the exact non-speculative
                # distribution; drafts are ignored rather than biased.
                emit = [self._sample(lg[slot, 0], req)]
                accepted = 0
            else:
                d = proposals[slot]
                g = greedy[slot]
                raw = 0
                while raw < k - 1 and d[raw] == g[raw]:
                    raw += 1
                accepted = raw
                if ctl is not None:
                    # Cap the accepted run at THIS slot's adaptive k
                    # (still token-identical: every emitted token is
                    # the flagship's argmax under the true prefix),
                    # but feed the controller the raw acceptance so a
                    # recovered drafter can climb back without a probe.
                    accepted = min(raw, max(ctl.slot_k(slot) - 1, 0))
                    ctl.observe(slot, k - 1, raw)
                emit = [int(t) for t in g[:accepted + 1]]
            self._m["draft_accepted"].inc(accepted)
            # Truncate to the request's remaining budget / EOS — any
            # truncation below finishes the request, so the cache-
            # validity induction only ever continues on full chunks.
            emit = emit[:req.max_new_tokens - len(req.tokens)]
            eos = self.config.eos_id
            if eos is not None and eos in emit:
                emit = emit[:emit.index(eos) + 1]
            self._lengths[slot] += len(emit)
            self._last_tok[slot] = emit[-1]
            for tok in emit:
                req.tokens.append(int(tok))
                self._observe_latency("tpot", dt, tenant=req.tenant,
                                      exemplar=req.trace_id)
                self._m["tokens"].labels(kind="generated").inc()
            req._notify()
            if w is not None:
                w.request_span(req.trace_id, "DECODE", t0m,
                               time.monotonic(),
                               {"n": len(emit), "proposed": k - 1,
                                "accepted": accepted})
            self._check_finished(req)

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        x = logits.astype(np.float64) / req.temperature
        x -= x.max()
        p = np.exp(x)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _check_finished(self, req: Request) -> None:
        eos = self.config.eos_id
        if (eos is not None and req.tokens
                and req.tokens[-1] == eos) \
                or len(req.tokens) >= req.max_new_tokens:
            self._evict(req, "completed")

    def _evict(self, req: Request, status: str,
               error: Optional[str] = None) -> None:
        """Free the slot mid-stream — the rest of the batch keeps
        decoding; the blocks return to the pool for the next admit
        (minus any leading blocks a session lease keeps resident)."""
        slot = req.slot
        self._tables[slot, :] = SCRATCH_BLOCK
        self._lengths[slot] = 0
        self._last_tok[slot] = 0
        self._reqs[slot] = None
        kept = 0
        if status == "completed" and self._sessions is not None \
                and req.session_id:
            kept = self._store_lease(req)
        self._alloc.release(req.blocks[kept:])
        req.blocks = []
        flight_note(
            "request", ("evict", req.trace_id,
                        f"{status} tokens={len(req.tokens)}"))
        self._finish(req, status, error=error)

    def _store_lease(self, req: Request) -> int:
        """Park this conversation's K/V under its session id: the
        leading blocks covering ``prompt + generated[:-1]`` (every
        position actually written — the final token was output-only)
        transfer their reference from the request to the lease table.
        Returns how many blocks the lease kept."""
        tokens = req.prompt + req.tokens[:-1]
        if not tokens:
            return 0
        kept = min(-(-len(tokens) // self.config.block_size),
                   len(req.blocks))
        self._sessions.put(req.session_id, tokens, req.blocks[:kept])
        self._m["session_leases"].inc()
        while self._sessions.max_entries is not None \
                and len(self._sessions) > self._sessions.max_entries \
                and self._sessions.evict_one(self._prefix,
                                             self.config.block_size):
            self._m["session_evictions"].inc()
        return kept

    def _count_request(self, status: str,
                       tenant: Optional[str] = None) -> None:
        """Tenanted requests get a {status=, tenant=} child so per-
        tenant traffic is attributable; untenanted ones keep the
        pre-tenant {status=} shape (sum over children stays correct)."""
        if tenant:
            self._m["requests"].labels(status=status,
                                       tenant=tenant).inc()
        else:
            self._m["requests"].labels(status=status).inc()

    def _observe_latency(self, key: str, value: float,
                         tenant: Optional[str] = None,
                         exemplar: Optional[str] = None) -> None:
        fam = self._m[key]
        child = fam.labels(tenant=tenant) if tenant else fam.labels()
        child.observe(value, exemplar=exemplar)

    def _judge_slo(self, req: Request) -> None:
        """Stamp a completed SLO-attached request with its verdict and
        count it into the hvdtpu_slo_* families."""
        ttft_s = req.ttft_s
        tpot_s = None
        if (req.t_first_token is not None and req.t_done is not None
                and len(req.tokens) > 1):
            tpot_s = ((req.t_done - req.t_first_token)
                      / (len(req.tokens) - 1))
        verdict = _slo.judge(req.slo, ttft_s, tpot_s)
        req.slo_verdict = verdict
        _slo.record_completion(
            req.tenant or _slo.DEFAULT_TENANT, verdict,
            req.t_done - req.t_submit, ttft_s, tpot_s,
            len(req.tokens), trace_id=req.trace_id)

    def _finish(self, req: Request, status: str,
                error: Optional[str] = None) -> None:
        req.status = status
        req.error = error
        req.t_done = time.perf_counter()
        if status == "completed" and req.slo is not None:
            self._judge_slo(req)
        elif error == DEADLINE_ERROR and (req.tenant
                                          or req.slo is not None):
            # Predictive sheds count under reason="shed" (the request
            # was turned away, not served late); queue expiries stay
            # under "deadline" (docs/serving.md#qos).
            _slo.record_shed(req.tenant or _slo.DEFAULT_TENANT,
                             "shed" if req.shed else "deadline")
        note = status if error is None else f"{status}: {error}"[:200]
        if req.tenant:
            note += (f" tenant={req.tenant}"
                     f" slo={_slo.verdict_summary(req.slo_verdict)}")
        flight_note(
            "request", ("finish", req.trace_id, note))
        self._count_request(status, req.tenant)
        if status == "completed":
            now = req.t_done
            self._completions.append(now)
            while self._completions and now - self._completions[0] > 10:
                self._completions.popleft()
            self._m["qps"].set(len(self._completions) / 10.0)
            if req.tenant:
                # Tenant drain rate: what quota Retry-After quotes
                # instead of the global queue estimate.
                self._quota.note_completion(
                    req.tenant, len(req.prompt) + len(req.tokens))
        req._done.set()
        req._notify()

    def _update_gauges(self) -> None:
        self._m["active"].set(self.active_count)
        self._m["occupancy"].set(self.active_count / self._slots)
        self._m["kv_used"].set(self._alloc.in_use)
        self._m["kv_bytes"].set(self._alloc.in_use
                                * self._bytes_per_block)
        depths = self._queue.depths()
        active = {c: 0 for c in _qos.PRIORITY_CLASSES}
        for r in self._reqs:
            if r is not None:
                active[r.qos_class] = active.get(r.qos_class, 0) + 1
        for cls in _qos.PRIORITY_CLASSES:
            self._m["class_queue"].labels(qos_class=cls).set(
                depths.get(cls, 0))
            self._m["class_active"].labels(qos_class=cls).set(
                active.get(cls, 0))

    def class_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-QoS-class queued/active counts — advertised via
        ``/healthz`` so the fleet router's class-aware scoring sees
        each replica's interactive backlog (docs/serving.md#qos)."""
        with self._lock:
            depths = self._queue.depths()
            active = {c: 0 for c in _qos.PRIORITY_CLASSES}
            for r in self._reqs:
                if r is not None:
                    active[r.qos_class] = \
                        active.get(r.qos_class, 0) + 1
        return {c: {"queued": depths.get(c, 0),
                    "active": active.get(c, 0)}
                for c in _qos.PRIORITY_CLASSES}
