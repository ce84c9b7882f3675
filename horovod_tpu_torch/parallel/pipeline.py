"""Pipeline parallelism over 'pp': microbatches through stages, by schedule.

Counterpart of ``horovod_tpu/parallel/pipeline.py``. Every 'pp' rank
holds the parameters of its stage (interleaved: of V chunk-stages, chunk
``c = v·n + r`` on rank ``r``); activations travel to rank ``i + 1`` and
cotangents to rank ``i - 1`` once per tick. The four schedules keep
JAX's tick formulas, so each stage's gradient adds its microbatches in
JAX's order:

``gpipe``
    A forward sweep (``m + n - 1`` ticks) under ``torch.no_grad`` that
    stashes each microbatch's stage input; the loss and its seeds over
    all ``m`` outputs at once; a backward sweep that recomputes the stage
    with grad at each tick (GPipe's rematerialisation).
``1f1b`` and ``interleaved``
    Warmup, steady and drain ticks of one fused schedule: chunk-stage
    ``c`` of microbatch ``j`` runs forward at ``t_F = g·nV + v·n + r +
    jr`` (``g = j // n``, ``jr = j % n``) and backward at ``t_F + 2·(nV
    - 1 - c)``. Where JAX stashes the VJP residuals in a ring of ``2nV -
    1`` slots keyed ``t_F mod (2nV - 1)``, the port keeps the live
    autograd graph of each in-flight microbatch in such a slot: the
    window is O(n·V) graphs, never O(m).
``zb-h1``
    1f1b's F and B tiling with the backward split: Bx at ``j + 2n - 2 -
    idx`` takes the input gradient (``retain_graph``) and parks its
    cotangent in an n-slot ring keyed ``j mod n``; W at the uniform tick
    ``2n - 2 + j`` takes the weight gradients from the same graph and
    frees it. W walks the stage's activation-gradient chain again, as
    JAX's W does.

The schedule code is written once, as one rank's program: a generator
that yields at every exchange (one batch of the tick's sends to ``i +
1`` and ``i - 1``) and every sum over 'pp'. A private transport drives
the programs: over a mesh axis's process group (NCCL on the card, gloo
on the CPU) it runs this rank's program; for n virtual stages in one
process it runs all n programs in lockstep and hands each the list
entries its neighbours sent. JAX computes every tick on every rank and
masks the result; the port skips the compute of a masked tick (it would
add exact zeros) but still makes the tick's exchange, with zeros where
the sender's tick was masked, so that every rank issues the same sends
and receives in the same order.

Static accounting (:class:`PipelineSchedule`, :func:`schedule_info`) is
a copy of JAX's: every tick costs wall time on every rank, so the bubble
share is the fraction of the schedule's compute budget not spent on
microbatch work. Each distinct schedule a process runs sets JAX's
``hvdtpu_pipeline_bubble_share`` and ``hvdtpu_pipeline_ticks`` gauges
and is a flight-recorder ``pipeline`` note, as JAX records each
pipeline program it builds.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from .collectives import _shifts, axis_index, axis_size

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb-h1")


# ---------------------------------------------------------------------------
# Static schedule accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Static tick/cost budget of one pipelined step.

    Costs are in forward-compute units per FULL stage (``cost_fwd`` for a
    stage forward, ``cost_bwd`` for a stage backward — the conventional
    backward:forward ratio is 2). Interleaved ticks move one chunk, i.e.
    1/V of a stage, and are costed accordingly. ``bubble_share`` is
    ``1 - useful_cost / total_cost`` — the fraction of the program's
    compute budget spent on masked (bubble) work, including gpipe's
    backward recompute."""

    name: str
    num_stages: int
    num_microbatches: int
    num_virtual: int = 1
    cost_fwd: float = 1.0
    cost_bwd: float = 2.0

    @property
    def ticks(self) -> dict:
        """Trip counts per phase. gpipe phases are its two sweeps
        (warmup = forward sweep, steady = 0, drain = backward sweep);
        1f1b/interleaved are warmup/steady/drain of the fused schedule;
        zb-h1's steady merges its F+Bx and F+Bx+W spans (m ticks) and
        its drain is the Bx+W tail."""
        n, m, v = self.num_stages, self.num_microbatches, self.num_virtual
        if self.name == "gpipe":
            return {"warmup": m + n - 1, "steady": 0, "drain": m + n - 1}
        if self.name == "zb-h1":
            return {"warmup": n - 1, "steady": m, "drain": n - 1}
        warmup = n * v - 1
        steady = (m - n) * v + n
        drain = n * v - 1
        return {"warmup": warmup, "steady": steady, "drain": drain}

    @property
    def total_cost(self) -> float:
        n, m, v = self.num_stages, self.num_microbatches, self.num_virtual
        cf, cb = self.cost_fwd, self.cost_bwd
        if self.name == "gpipe":
            # Forward sweep at cF a tick; backward sweep re-linearizes
            # from the activation stash (recompute), cF + cB a tick.
            return (m + n - 1) * cf + (m + n - 1) * (cf + cb)
        if self.name == "zb-h1":
            # Backward split cB = cBx + cBw (even halves by convention):
            # only cBx rides the fill/drain skew, cBw fills the bubble.
            cbx = cbw = cb / 2.0
            return (m + n - 1) * (cf + cbx) + m * cbw
        t = self.ticks
        per = 1.0 / v
        return (t["warmup"] * cf * per + t["steady"] * (cf + cb) * per
                + t["drain"] * cb * per)

    @property
    def useful_cost(self) -> float:
        return self.num_microbatches * (self.cost_fwd + self.cost_bwd)

    @property
    def bubble_share(self) -> float:
        return 1.0 - self.useful_cost / self.total_cost


def schedule_info(schedule: str, num_stages: int, num_microbatches: int,
                  *, num_virtual: int = 1, cost_fwd: float = 1.0,
                  cost_bwd: float = 2.0) -> PipelineSchedule:
    """Static budget of a pipelined step: ticks per phase and the bubble
    share."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"expected one of {SCHEDULES}")
    v = num_virtual if schedule == "interleaved" else 1
    _validate(schedule, num_stages, num_microbatches, v)
    return PipelineSchedule(schedule, num_stages, num_microbatches, v,
                            cost_fwd, cost_bwd)


class _PipelineMetrics:
    _instance = None

    def __init__(self):
        from ..observability import registry as _obs
        r = _obs.registry()
        self.bubble = r.gauge(
            "hvdtpu_pipeline_bubble_share",
            "Static bubble share of the most recently built pipeline "
            "program per schedule: the fraction of the schedule's "
            "compute-cost budget spent on masked (non-microbatch) work, "
            "from the tick budget — compare against the measured step "
            "phases to see how much of a comm-bound verdict is schedule "
            "bubble (docs/pipeline.md)")
        self.ticks = r.gauge(
            "hvdtpu_pipeline_ticks",
            "Scan trip counts of the most recently built pipeline "
            "program, by schedule and phase (warmup/steady/drain)")

    @classmethod
    def get(cls) -> "_PipelineMetrics":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


_recorded_schedules: set = set()


def _record_schedule(sched: PipelineSchedule) -> None:
    """The static bubble and tick gauges and a flight-recorder note for a
    schedule, once per distinct schedule in this process (JAX records
    each pipeline program when it is built)."""
    key = dataclasses.astuple(sched)
    if key in _recorded_schedules:
        return
    _recorded_schedules.add(key)
    metrics = _PipelineMetrics.get()
    metrics.bubble.labels(schedule=sched.name).set(
        round(sched.bubble_share, 6))
    for phase, count in sched.ticks.items():
        metrics.ticks.labels(schedule=sched.name, phase=phase).set(
            float(count))
    from ..observability import flight_recorder as _fr
    _fr.recorder().note("pipeline", (
        sched.name, sched.num_stages, sched.num_microbatches,
        sched.num_virtual, sched.ticks["warmup"], sched.ticks["steady"],
        sched.ticks["drain"], round(sched.bubble_share, 6)))


def _validate(schedule: str, n: int, m: int, v: int) -> None:
    if m < 1:
        raise ValueError("need at least one microbatch")
    if v < 1:
        raise ValueError("num_virtual must be >= 1")
    if schedule == "interleaved":
        if v < 2:
            raise ValueError("interleaved needs num_virtual >= 2 "
                             "(num_virtual=1 IS the 1f1b schedule)")
        if m < n or m % n:
            raise ValueError(
                f"interleaved needs num_microbatches ({m}) to be a "
                f"multiple of the stage count ({n}) at least as large "
                "as it — the circular schedule streams microbatches in "
                "rounds of one per stage")
    if schedule == "zb-h1" and m < n:
        raise ValueError(
            f"zb-h1 needs num_microbatches ({m}) >= num_stages ({n}): "
            "the uniform weight-grad tick W_j = 2n-2+j assumes every "
            "rank reached steady state before the first W fires")


# ---------------------------------------------------------------------------
# The transport: what a rank's program yields, and the two rings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Exchange:
    """One tick's hand-off: ``fwd`` goes to rank i + 1, ``bwd`` to rank
    i - 1; the reply is ``(received from i - 1, received from i + 1)``,
    lists of the same lengths."""

    fwd: List[torch.Tensor]
    bwd: List[torch.Tensor]


@dataclasses.dataclass
class _Sum:
    """A sum over 'pp' of each tensor; the reply is the list of sums."""

    tensors: List[torch.Tensor]


class _GroupRing:
    """This rank's place on a mesh axis: one program, communication over
    the axis's process group (one ``batch_isend_irecv`` per exchange)."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.n = axis_size(mesh, axis)
        self.ranks = (axis_index(mesh, axis),)
        self.group = mesh.get_group(axis) if self.n > 1 else None

    def _check(self, tensors):
        if self.group is None:
            return
        nccl = dist.get_backend(self.group) == "nccl"
        for t in tensors:
            if t.is_cuda != nccl:
                raise ValueError(
                    f"a {t.device.type} tensor cannot travel over the "
                    f"{dist.get_backend(self.group)} group of the 'pp' "
                    "axis; build the mesh on the tensors' device")

    def serve(self, requests):
        (req,) = requests
        if isinstance(req, _Exchange):
            if self.n == 1:
                return [(list(req.fwd), list(req.bwd))]
            self._check(req.fwd + req.bwd)
            got = _shifts([(t, 1) for t in req.fwd]
                          + [(t, -1) for t in req.bwd], self.group)
            return [(got[:len(req.fwd)], got[len(req.fwd):])]
        if self.n == 1:
            return [list(req.tensors)]
        self._check(req.tensors)
        out = []
        for t in req.tensors:
            t = t.contiguous().clone()
            dist.all_reduce(t, group=self.group)
            out.append(t)
        return [out]


class _LocalRing:
    """n virtual stages in one process: every program runs here, and an
    exchange hands each rank the list entries its neighbours yielded;
    a sum adds the ranks' tensors in rank order."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = tuple(range(n))

    def serve(self, requests):
        n = self.n
        if isinstance(requests[0], _Exchange):
            return [(list(requests[(i - 1) % n].fwd),
                     list(requests[(i + 1) % n].bwd)) for i in range(n)]
        sums = [functools.reduce(torch.add, ts)
                for ts in zip(*(r.tensors for r in requests))]
        return [list(sums) for _ in range(n)]


def _drive(ring, programs):
    """Run one program per rank the ring drives, in lockstep, serving
    what they yield; returns their results."""
    replies = [None] * len(programs)
    while True:
        requests, results = [], []
        for prog, reply in zip(programs, replies):
            try:
                requests.append(prog.send(reply))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if requests:
                raise RuntimeError("the pipeline ranks fell out of step")
            return results
        if len({type(r) for r in requests}) != 1:
            raise RuntimeError("the pipeline ranks fell out of step")
        replies = ring.serve(requests)


# ---------------------------------------------------------------------------
# Helpers of the rank programs
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree (none for None, which is a leaf to
    ``torch.utils._pytree``)."""
    return [] if tree is None else pytree.tree_flatten(tree)[0]


def _as_leaves(tree):
    """``tree`` with each tensor a fresh autograd leaf on the same
    storage, so that ``torch.autograd.grad`` can take its gradient."""
    return pytree.tree_map(lambda t: t.detach().requires_grad_(), tree)


def _forward(stage_fn, params, inp):
    """The stage on a fresh leaf of ``inp``, with grad: ``(x, y)``."""
    x = inp.detach().requires_grad_()
    with torch.enable_grad():
        y = stage_fn(params, x)
    return x, y


def _grad(y, inputs, g, retain=False):
    return torch.autograd.grad(y, inputs, g, retain_graph=retain,
                               allow_unused=True, materialize_grads=True)


def _accumulate(acc, grads):
    """``acc + grads`` leaf by leaf (``grads`` when ``acc`` is None), in
    one multi-tensor launch per device and dtype."""
    if not acc:
        return list(grads)
    return list(torch._foreach_add(acc, list(grads)))


def _loss_caller(loss_fn, loss_aux):
    """``call(lp, y, j)``: ``loss_fn([lp,] y[, aux[j]])``."""
    def call(lp, y, j):
        args = [] if lp is None else [lp]
        args.append(y)
        if loss_aux is not None:
            args.append(pytree.tree_map(lambda a: a[j], loss_aux))
        return loss_fn(*args)
    return call


def _loss_and_seed(call, lp, y, j, m):
    """One microbatch's loss at the last chunk-stage: ``(loss, seed,
    d_lp)`` with the seed and ``d_lp`` taken for ``loss / m``, as JAX's
    ``loss_vjp(ones / m)``."""
    yl = y.detach().requires_grad_()
    with torch.enable_grad():
        loss = call(lp, yl, j)
    grads = _grad(loss, [yl] + _leaves(lp), loss.new_ones(()) / m)
    return loss.detach(), grads[0], list(grads[1:])


def _zeros_like_leaves(tree):
    return [torch.zeros_like(t) for t in _leaves(tree)]


# ---------------------------------------------------------------------------
# Forward-only pipeline
# ---------------------------------------------------------------------------


def _apply_program(idx, n, stage_fn, params, x_mb, replicate_output):
    m = x_mb.shape[0]
    ticks = m + n - 1
    zero = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    state = relay = zero
    for t in range(ticks):
        if replicate_output == "relay":
            # The value arriving now left rank n - 1 idx + 1 ticks ago:
            # microbatch t - n - idx.
            j_in = t - n - idx
            if 0 <= j_in < m and idx != n - 1:
                outs[j_in] = relay.to(outs.dtype)
        j = t - idx
        y = zero
        if 0 <= j < m:
            with torch.no_grad():
                y = stage_fn(params, x_mb[t] if idx == 0 else state)
            if idx == n - 1:
                outs[j] = y.to(outs.dtype)
        if replicate_output == "relay":
            # Originate at the last stage, forward everywhere else.
            out = y if idx == n - 1 else relay
            (relay, state), _ = yield _Exchange([out, y], [])
        else:
            (state,), _ = yield _Exchange([y], [])
    if replicate_output == "psum":
        (outs,) = yield _Sum([outs if idx == n - 1 else
                              torch.zeros_like(outs)])
        return outs
    for t in range(ticks, ticks + n - 1):
        j_in = t - n - idx
        if 0 <= j_in < m and idx != n - 1:
            outs[j_in] = relay.to(outs.dtype)
        (relay,), _ = yield _Exchange([relay], [])
    return outs


def _apply(ring, stage_fn, params, x_mb, replicate_output):
    """:func:`pipeline_apply` of every rank ``ring`` drives (``params``
    and ``x_mb``: one entry per rank)."""
    if replicate_output not in ("relay", "psum"):
        raise ValueError("replicate_output must be 'relay' or 'psum'")
    return _drive(ring, [
        _apply_program(idx, ring.n, stage_fn, p, x, replicate_output)
        for idx, p, x in zip(ring.ranks, params, x_mb)])


def pipeline_apply(stage_fn: Callable, params, x_microbatches: torch.Tensor,
                   mesh: DeviceMesh, axis: str = "pp", *,
                   replicate_output: str = "relay") -> torch.Tensor:
    """A pipelined forward pass over ``axis``, without grad.

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape`` is one
    stage; every rank runs it with its own ``params``.
    ``x_microbatches`` ``[m, micro_batch, ...]`` is read on stage 0.
    ``replicate_output``: ``"relay"`` carries each finished microbatch
    around the ring one hop per tick, beside the activations, plus an
    ``n - 1``-tick drain; ``"psum"`` sums the last stage's outputs (the
    others' zeros) over the axis at the end. Returns the last stage's
    ``[m, micro_batch, ...]`` outputs on every rank."""
    return _apply(_GroupRing(mesh, axis), stage_fn, [params],
                  [x_microbatches], replicate_output)[0]


# ---------------------------------------------------------------------------
# Training schedules: loss and gradients
# ---------------------------------------------------------------------------


def _gpipe_program(idx, n, stage_fn, call, params, x_mb, lp, want_xg):
    """The forward sweep stashes each microbatch's stage input; the
    backward sweep recomputes the stage with grad (GPipe's
    rematerialisation)."""
    m = x_mb.shape[0]
    zero = torch.zeros_like(x_mb[0])
    stash = [None] * m
    outs = [None] * m
    state = zero
    for t in range(m + n - 1):
        j = t - idx
        y = zero
        if 0 <= j < m:
            stash[j] = x_mb[t] if idx == 0 else state
            with torch.no_grad():
                y = stage_fn(params, stash[j])
            if idx == n - 1:
                outs[j] = y
        (state,), _ = yield _Exchange([y], [])

    # The loss and its seeds over all m outputs at once, on the last
    # stage (JAX's vmapped total_loss).
    if idx == n - 1:
        o = torch.stack(outs).detach().requires_grad_()
        with torch.enable_grad():
            loss = torch.stack([call(lp, o[j], j) for j in range(m)]).mean()
        grads = _grad(loss, [o] + _leaves(lp), torch.ones_like(loss))
        loss, seeds, d_lp = loss.detach(), grads[0], list(grads[1:])
    else:
        loss = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        d_lp = _zeros_like_leaves(lp)
    del outs

    gacc = None
    xg = torch.zeros_like(x_mb) if want_xg else None
    g_state = zero
    for u in range(m + n - 1):
        j = u - (n - 1 - idx)
        dx = zero
        if 0 <= j < m:
            g_in = seeds[u] if idx == n - 1 else g_state
            x, y = _forward(stage_fn, params, stash[j])   # the recompute
            stash[j] = None
            dx, *dp = _grad(y, [x] + _leaves(params), g_in)
            gacc = _accumulate(gacc, dp)
            if xg is not None and idx == 0:
                xg[j] = dx.to(xg.dtype)
        _, (g_state,) = yield _Exchange([], [dx])
    if gacc is None:
        gacc = _zeros_like_leaves(params)
    return (yield from _finish(loss, [gacc], d_lp, xg))


def _finish(loss, grads, lp_grads, xg):
    """Sum the loss and the extras over 'pp'; ``(loss, grads, lp_grads,
    xg)``."""
    extra = [] if xg is None else [xg]
    sums = yield _Sum([loss] + lp_grads + extra)
    loss, rest = sums[0], sums[1:]
    return (loss, grads, rest[:len(lp_grads)],
            rest[len(lp_grads)] if extra else None)


def _fused_program(idx, n, V, stage_fn, call, chunks, x_mb, lp, want_xg):
    """1F1B (V = 1) and interleaved (V >= 2), warmup / steady / drain
    over global ticks, with JAX's ``f_sched``, ``b_sched`` and
    ``g_tF``."""
    m = x_mb.shape[0]
    nV = n * V
    W = 2 * nV - 1
    zero = torch.zeros_like(x_mb[0])
    chunk_leaves = [_leaves(c) for c in chunks]

    def f_sched(t):
        u = t - idx
        g, w = divmod(max(u, 0), nV)
        j = g * n + w % n
        return u >= 0 and j < m, j, w // n

    def b_sched(t):
        q = t - (2 * nV - 2) + idx + (V - 1) * n
        g, w = divmod(max(q, 0), nV)
        j = g * n + w % n
        return q >= 0 and j < m, j, (V - 1) - w // n

    def g_tF(j, v):
        return (j // n) * nV + v * n + idx + (j % n)

    ring = {}             # slot -> (x, y): the in-flight graphs
    gacc = [None] * V
    loss_acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    lp_acc = _zeros_like_leaves(lp)
    xg = torch.zeros_like(x_mb) if want_xg else None
    fwd_state = bwd_state = zero
    warmup = nV - 1
    steady_end = m * V + n - 1          # one past the last F tick
    drain_end = steady_end + nV - 1     # one past the last B tick
    for t in range(drain_end):
        do_f, do_b = t < steady_end, t >= warmup
        seed = None
        y = zero
        if do_f:
            valid, j, v = f_sched(t)
            if valid:
                inp = x_mb[j] if idx == 0 and v == 0 else fwd_state
                slot = g_tF(j, v) % W
                if slot in ring:
                    raise RuntimeError(f"pipeline slot {slot} still holds "
                                       "a graph")
                ring[slot] = _forward(stage_fn, chunks[v], inp)
                y = ring[slot][1].detach()
                if do_b and idx == n - 1 and v == V - 1:
                    # The microbatch's loss and seed at the last
                    # chunk-stage, in the same tick as its forward.
                    mb_loss, seed, d_lp = _loss_and_seed(call, lp, y, j, m)
                    lp_acc = _accumulate(lp_acc, d_lp)
                    loss_acc = loss_acc + mb_loss.float()
        dx = zero
        if do_b:
            valid, j, v = b_sched(t)
            if valid:
                x, yb = ring.pop(g_tF(j, v) % W)
                g_in = seed if idx == n - 1 and v == V - 1 else bwd_state
                dx, *dp = _grad(yb, [x] + chunk_leaves[v], g_in)
                gacc[v] = _accumulate(gacc[v], dp)
                if xg is not None and idx == 0 and v == 0:
                    xg[j] = dx.to(xg.dtype)
        recv_f, recv_b = yield _Exchange([y] if do_f else [],
                                         [dx] if do_b else [])
        if do_f:
            (fwd_state,) = recv_f
        if do_b:
            (bwd_state,) = recv_b
    grads = [g if g is not None else _zeros_like_leaves(c)
             for g, c in zip(gacc, chunks)]
    loss = loss_acc / m if idx == n - 1 else torch.zeros_like(loss_acc)
    return (yield from _finish(loss, grads, lp_acc, xg))


def _zb_program(idx, n, stage_fn, call, params, x_mb, lp, want_xg):
    """ZB-H1: F at ``j + idx``, Bx at ``j + 2n - 2 - idx`` (input grad,
    the graph kept), W at ``2n - 2 + j`` (weight grads, the graph
    freed)."""
    m = x_mb.shape[0]
    W = 2 * n - 1
    zero = torch.zeros_like(x_mb[0])
    p_leaves = _leaves(params)
    ring = {}             # slot (j + idx) mod W -> (x, y)
    cring = {}            # slot j mod n -> the cotangent parked for W_j
    gacc = None
    loss_acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    lp_acc = _zeros_like_leaves(lp)
    xg = torch.zeros_like(x_mb) if want_xg else None
    fwd_state = bwd_state = zero
    for t in range(m + 2 * n - 2):
        do_f = t < m + n - 1
        do_bx = t >= n - 1
        do_w = t >= 2 * n - 2
        seed = None
        y = zero
        if do_f:
            j = t - idx
            if 0 <= j < m:
                slot = (j + idx) % W
                if slot in ring:
                    raise RuntimeError(f"pipeline slot {slot} still holds "
                                       "a graph")
                ring[slot] = _forward(stage_fn, params,
                                      x_mb[j] if idx == 0 else fwd_state)
                y = ring[slot][1].detach()
                if do_bx and idx == n - 1:
                    mb_loss, seed, d_lp = _loss_and_seed(call, lp, y, j, m)
                    lp_acc = _accumulate(lp_acc, d_lp)
                    loss_acc = loss_acc + mb_loss.float()
        dx = zero
        if do_bx:
            j = t - (2 * n - 2) + idx
            if 0 <= j < m:
                x, yb = ring[(j + idx) % W]
                g_in = seed if idx == n - 1 else bwd_state
                cring[j % n] = g_in
                (dx,) = _grad(yb, [x], g_in, retain=True)
                if xg is not None and idx == 0:
                    xg[j] = dx.to(xg.dtype)
        if do_w:
            j = t - (2 * n - 2)
            x, yb = ring.pop((j + idx) % W)
            dp = _grad(yb, p_leaves, cring.pop(j % n))
            gacc = _accumulate(gacc, dp)
        recv_f, recv_b = yield _Exchange([y] if do_f else [],
                                         [dx] if do_bx else [])
        if do_f:
            (fwd_state,) = recv_f
        if do_bx:
            (bwd_state,) = recv_b
    loss = loss_acc / m if idx == n - 1 else torch.zeros_like(loss_acc)
    return (yield from _finish(loss, [gacc], lp_acc, xg))


def _value_and_grad_chunks(ring, stage_fn, loss_fn, chunks, x_mb, *,
                           schedule="1f1b", num_virtual=1, loss_aux=None,
                           loss_params=None, return_input_grads=False,
                           cost_backward=2.0):
    """The schedule on every rank ``ring`` drives. ``chunks``: per rank,
    its V chunk trees (V = 1 but for interleaved); ``x_mb``,
    ``loss_aux`` and ``loss_params``: per rank (or None). Returns per
    rank ``(loss, chunk grad lists, loss_params grad list, input
    grads)``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"expected one of {SCHEDULES}")
    n = ring.n
    m = x_mb[0].shape[0]
    v = num_virtual if schedule == "interleaved" else 1
    _validate(schedule, n, m, v)
    _record_schedule(PipelineSchedule(schedule, n, m, v, 1.0,
                                      float(cost_backward)))
    k = len(ring.ranks)
    loss_aux = loss_aux if loss_aux is not None else [None] * k
    lps = (loss_params if loss_params is not None else [None] * k)
    programs = []
    for idx, cs, x, aux, lp in zip(ring.ranks, chunks, x_mb, loss_aux, lps):
        call = _loss_caller(loss_fn, aux)
        lp = None if lp is None else _as_leaves(lp)
        cs = [_as_leaves(c) for c in cs]
        if len(cs) != v:
            raise ValueError(f"rank {idx} holds {len(cs)} chunks; the "
                             f"{schedule} schedule runs {v}")
        if schedule == "gpipe":
            prog = _gpipe_program(idx, n, stage_fn, call, cs[0], x, lp,
                                  return_input_grads)
        elif schedule == "zb-h1":
            prog = _zb_program(idx, n, stage_fn, call, cs[0], x, lp,
                               return_input_grads)
        else:
            prog = _fused_program(idx, n, v, stage_fn, call, cs, x, lp,
                                  return_input_grads)
        programs.append(prog)
    return _drive(ring, programs)


def _value_and_grad(ring, stage_fn, loss_fn, params, x_mb, *,
                    schedule="1f1b", num_virtual=1, loss_aux=None,
                    loss_params=None, return_input_grads=False,
                    cost_backward=2.0):
    """:func:`pipeline_value_and_grad` of every rank ``ring`` drives
    (``params``, ``x_mb``, ``loss_aux``, ``loss_params``: one entry per
    rank); a list of their results."""
    stacked = schedule == "interleaved"
    chunks = []
    for p in params:
        if stacked:
            chunks.append([pytree.tree_map(lambda t, c=c: t[c], p)
                           for c in range(num_virtual)])
        else:
            chunks.append([p])
    results = _value_and_grad_chunks(
        ring, stage_fn, loss_fn, chunks, x_mb, schedule=schedule,
        num_virtual=num_virtual, loss_aux=loss_aux,
        loss_params=loss_params, return_input_grads=return_input_grads,
        cost_backward=cost_backward)
    out = []
    for p, lp, (loss, grads, lp_grads, xg) in zip(
            params, loss_params or [None] * len(params), results):
        spec = pytree.tree_flatten(p)[1]
        if stacked:
            grads = [torch.stack(gs) for gs in zip(*grads)]
        else:
            (grads,) = grads
        grads = pytree.tree_unflatten(grads, spec)
        if lp is None and not return_input_grads:
            out.append((loss, grads))
            continue
        extras = {}
        if lp is not None:
            extras["loss_params_grads"] = pytree.tree_unflatten(
                lp_grads, pytree.tree_flatten(lp)[1])
        if return_input_grads:
            extras["input_grads"] = xg
        out.append((loss, grads, extras))
    return out


def pipeline_value_and_grad(stage_fn: Callable, loss_fn: Callable, params,
                            x_microbatches: torch.Tensor, mesh: DeviceMesh,
                            axis: str = "pp", *, schedule: str = "1f1b",
                            num_virtual: int = 1,
                            cost_backward: float = 2.0, loss_aux=None,
                            loss_params=None,
                            return_input_grads: bool = False):
    """Pipelined loss and stage-parameter gradients over ``axis``.

    The model is the composition of every rank's ``stage_fn(params, x)``
    along the ring (interleaved: of all ``n·V`` chunk applications in
    chunk-stage order ``c = v·n + r``); the loss is ``mean_j
    loss_fn(y_j)`` over the ``m`` microbatches' last-stage outputs.

    ``params``: this rank's stage parameters (a tree of tensors); for
    ``interleaved`` each leaf carries a leading ``num_virtual`` axis,
    slot ``v`` on rank ``r`` being chunk-stage ``v·n + r``.
    ``x_microbatches`` ``[m, micro_batch, ...]`` is read on stage 0.
    ``loss_aux``: a tree of per-microbatch loss inputs (leaves ``[m,
    ...]``), the microbatch's slice passed last to ``loss_fn``.
    ``loss_params``: a tree of trainable loss-side parameters, passed
    first (``loss_fn(lp, y[, aux])``); their gradient accumulates at
    the last stage and is summed over the axis. ``return_input_grads``:
    also ``d loss / d x_microbatches``, collected on stage 0 and summed
    over the axis. ``cost_backward`` changes only the accounting
    (:func:`schedule_info`, the bubble gauge).

    Returns ``(loss, grads)`` — the loss (0-d fp32, on every rank) and
    the gradient of this rank's ``params`` — or, with ``loss_params`` or
    ``return_input_grads``, ``(loss, grads, extras)`` with
    ``"loss_params_grads"`` and/or ``"input_grads"``, the same on every
    rank. Every rank of the axis calls it with the same schedule and
    shapes."""
    return _value_and_grad(
        _GroupRing(mesh, axis), stage_fn, loss_fn, [params],
        [x_microbatches], schedule=schedule, num_virtual=num_virtual,
        loss_aux=None if loss_aux is None else [loss_aux],
        loss_params=None if loss_params is None else [loss_params],
        return_input_grads=return_input_grads,
        cost_backward=cost_backward)[0]


def _virtual_value_and_grad(n: int, stage_fn, loss_fn,
                            params: Sequence, x_microbatches, **kw):
    """:func:`pipeline_value_and_grad` over ``n`` virtual stages in this
    process: ``params`` holds each stage's, in rank order; the same
    ``x_microbatches``, ``loss_aux`` and ``loss_params`` reach every
    stage. A list of the n ranks' results."""
    for key in ("loss_aux", "loss_params"):
        if kw.get(key) is not None:
            kw[key] = [kw[key]] * n
    return _value_and_grad(_LocalRing(n), stage_fn, loss_fn, list(params),
                           [x_microbatches] * n, **kw)


def _virtual_apply(n: int, stage_fn, params: Sequence, x_microbatches,
                   replicate_output: str = "relay") -> List[torch.Tensor]:
    """:func:`pipeline_apply` over ``n`` virtual stages in this
    process; a list of the n ranks' outputs."""
    return _apply(_LocalRing(n), stage_fn, list(params),
                  [x_microbatches] * n, replicate_output)

