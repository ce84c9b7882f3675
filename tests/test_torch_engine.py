"""The port's collective engine against the JAX package, on gloo.

One spawned job per world size (2 and 3 ranks, then 4), each with many
checks inside, writes every rank's results to a file; the tests here
read them. The oracle of an allreduce is the JAX function itself:
``horovod_tpu.executor._fused_reduce`` under ``jax.shard_map`` over an
n-device slice of the 8-device CPU mesh, with ``psum`` as the reduction
and ``post = postscale / n`` as the JAX engine passes it; int64 and
float64 run under 64-bit mode. Allowed error: 0 (bit for bit). That
holds for the engine's gloo path, which sums the ranks' buffers in rank
order as XLA's CPU all-reduce does; ``dist.all_reduce``, the path NCCL
takes on the card, sums in another order, so the sweep runs through it
too (the engine's ``_ordered_sum`` switched off) and is held to a
tolerance of a few units in the last place there.

- the dtype x dims sweep of ``tests/test_ops.py`` for allreduce (sum,
  average, and average with pre/postscale 0.5/2.0, each burst fused by
  the planner), allgather and broadcast, per-rank inputs from
  ``RandomState(seed + rank)``;
- the four arithmetic faults of the engine this one replaced, each in
  its own test: integer ``average`` floored, integer scale factors
  raised, fp16/bf16 reduced in their own dtype, float ``average``
  divided by n instead of multiplied by ``postscale / n``; and fp8
  sums past ±448, which JAX casts back to NaN where ``Tensor.to``
  saturates;
- the blockwise wire (int8 and fp8 at block 256, int8 at block 64):
  fp32, bf16 and fp16 tensors of ragged lengths and an empty one, with
  an int32 tensor that keeps the exact path, several tensors a group,
  sum, average and pre/postscale, against ``_fused_reduce(...,
  wire=spec, axis="dp", world=n)``, bit for bit: the wire's collectives
  only move bytes, and phase 1 adds the ranks' contributions from zero
  in rank order, as XLA's reduce does;
- an idle world: a half-second pause after the work runs a few
  negotiation rounds, not one per cycle;
- on 4 ranks: 12 named ops enqueued in a rank-dependent rotation, a
  ragged allgather, a broadcast from rank 3, every kind of mismatch
  (each raising the JAX coordinator's message on every rank), a wire
  mismatch among them, a ``synchronize`` timeout while one rank holds
  back, and a shutdown that fails the other ranks' pending op;
- in this process: the planner against the JAX ``_plan_fusion`` (on
  wire bytes where a wire is set), the validation messages and
  fingerprint against the JAX coordinator's, block-aligned packing of a
  wire group, and fusion at world size 1.

Each job has a time limit of its own, so a hang fails its tests.
"""

import itertools
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch import executor as texec
from horovod_tpu_torch import quantization as tq
from horovod_tpu_torch.ops import collective as tcoll
from horovod_tpu_torch.ops import control_plane as tcp

SEED = 1234
DTYPES = ["uint8", "int8", "int32", "int64", "float16", "float32", "float64",
          "bfloat16"]
DIMS = [1, 2, 3]
# (name, average, prescale, postscale) of the swept allreduce configs.
CONFIGS = [("sum", False, 1.0, 1.0), ("average", True, 1.0, 1.0),
           ("scaled", True, 0.5, 2.0)]
JOB_TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, n, *args):
    """Run ``fn(rank, n, port, *args)`` on n processes; fail on a hang."""
    ctx = mp.spawn(fn, args=(n, _free_port()) + args, nprocs=n, join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {n}-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")


IDLE_PAUSE_S = 0.5


def _init(rank, n, port):
    hvd.shutdown()
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=n)


# ------------------------------------------------------------------ inputs

def _np_input(kind, dtype, shape, seed):
    """numpy inputs as tests/test_ops.py draws them (bf16 as float32)."""
    rng = np.random.RandomState(seed)
    if kind == "quarters":      # floats whose sums are exact in any order
        return (rng.randint(-400, 400, size=shape) / 4).astype(dtype)
    if kind == "signed":        # integers of both signs
        return rng.randint(-50, 50, size=shape).astype(dtype)
    if kind == "wide":          # magnitudes 1e-6 to 1e6 within a block
        x = rng.standard_normal(shape) * 10.0 ** rng.randint(-6, 7, shape)
        return x.astype(np.float32 if dtype == "bfloat16" else dtype)
    if dtype.startswith("float8"):
        return rng.uniform(-100, 100, size=shape).astype(np.float32)
    if dtype in ("bfloat16", "float16", "float32", "float64"):
        x = rng.uniform(-100, 100, size=shape)
        return x.astype(np.float32 if dtype == "bfloat16" else dtype)
    return rng.randint(0, 100, size=shape).astype(dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


class Int8x64Compressor(tcomp._BlockwiseCompressor):
    """The int8 wire at a smaller block than the stock compressors'."""
    wire_spec = "int8x64"


WIRE_COMPRESSORS = {"int8x256": tcomp.Compression.int8_blockwise,
                    "fp8x256": tcomp.Compression.fp8_blockwise,
                    "int8x64": Int8x64Compressor}


class Case:
    """One allreduce: its inputs on every rank and its attributes."""

    def __init__(self, key, dtype, shape, seed, average, prescale, postscale,
                 kind="uniform", wire=None):
        self.key, self.dtype, self.shape, self.seed = key, dtype, shape, seed
        self.average, self.prescale, self.postscale = (average, prescale,
                                                       postscale)
        self.kind = kind
        self.wire = wire         # a WIRE_COMPRESSORS key, or None

    def np_input(self, rank):
        return _np_input(self.kind, self.dtype, self.shape, self.seed + rank)

    def input(self, rank):
        return _to_torch(self.np_input(rank), self.dtype)


def _sweep_cases():
    cases = []
    for (cfg, avg, pre, post), (i, (dt, dim)) in itertools.product(
            CONFIGS, enumerate(itertools.product(DTYPES, DIMS))):
        cases.append(Case(f"sweep.{cfg}.{dt}.{dim}", dt, (17,) * dim,
                          SEED + 100 * i, avg, pre, post))
    return cases


def _fault_cases():
    cases = []
    # 1. integer average truncates toward zero (JAX), it does not floor.
    for dt in ("int8", "int32", "int64"):
        cases.append(Case(f"fault1.{dt}", dt, (64,), 11, True, 1.0, 1.0,
                          "signed"))
    # 2. integers with scale factors: scaled in float, cast back
    #    (truncating, saturating at the dtype's range).
    for dt in ("uint8", "int8", "int32", "int64"):
        cases.append(Case(f"fault2.{dt}.pre_post", dt, (64,), 21, False,
                          0.5, 2.0, "signed"))
        cases.append(Case(f"fault2.{dt}.avg_post", dt, (64,), 22, True,
                          1.0, 3.0, "signed"))
    # 3. fp16/bf16 accumulate in fp32.
    for dt in ("float16", "bfloat16"):
        cases.append(Case(f"fault3.{dt}.avg", dt, (256,), 31, True, 1.0,
                          1.0))
        cases.append(Case(f"fault3.{dt}.avg_pre", dt, (256,), 32, True,
                          0.3, 1.0))
    # 5. float average multiplies by postscale / n; exact sums isolate it.
    for dt in ("float32", "float64"):
        cases.append(Case(f"fault5.{dt}.avg", dt, (256,), 51, True, 1.0,
                          1.0, "quarters"))
        cases.append(Case(f"fault5.{dt}.avg_post", dt, (256,), 52, True,
                          1.0, 0.3, "quarters"))
    # 6. fp8 sums past the e4m3 range become NaN, as JAX casts them.
    cases.append(Case("fault6.float8.sum_post", "float8_e4m3fn", (256,), 61,
                      False, 1.0, 3.0))
    cases.append(Case("fault6.float8.avg", "float8_e4m3fn", (256,), 62,
                      True, 1.0, 1.0))
    return cases


WIRE_SHAPES = [("float32", (17,)), ("float32", (300,)), ("float32", (3, 100)),
               ("bfloat16", (5, 61)), ("float16", (513,)), ("float32", (0,)),
               ("int32", (40,))]


def _wire_cases():
    cases = []
    for w, (cfg, avg, pre, post) in itertools.product(WIRE_COMPRESSORS,
                                                      CONFIGS):
        for i, (dt, shape) in enumerate(WIRE_SHAPES):
            cases.append(Case(f"wire.{w}.{cfg}.{i}.{dt}", dt, shape,
                              SEED + 300 + i, avg, pre, post,
                              "wide" if i == 1 else "uniform", w))
    return cases


def _gather_cases():
    return [(f"gather.{dt}.{dim}", dt, dim, SEED + 7 * i)
            for i, (dt, dim) in enumerate(itertools.product(DTYPES, DIMS))]


# ------------------------------------------------------------------ workers

def _save(out, outdir, rank):
    # Results may be views of one fused buffer; each is saved on its own.
    torch.save({k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()},
               os.path.join(outdir, f"rank{rank}.pt"))


def _record(out, key, fn):
    try:
        out[key] = fn()
    except Exception as e:      # recorded: the test names the failure
        out[key] = f"error: {type(e).__name__}: {e}"


def _sweep_worker(rank, n, port, outdir):
    _init(rank, n, port)
    out = {}
    cases = _sweep_cases() + _fault_cases()
    for avg, pre, post in sorted({(c.average, c.prescale, c.postscale)
                                  for c in cases}):
        batch = [c for c in cases
                 if (c.average, c.prescale, c.postscale) == (avg, pre, post)]
        handles = []
        for c in batch:
            try:
                handles.append((c.key, hvd.allreduce_async(
                    c.input(rank), average=avg, name=c.key,
                    prescale_factor=pre, postscale_factor=post)))
            except Exception as e:
                out[c.key] = f"error: {type(e).__name__}: {e}"
        for key, h in handles:
            _record(out, key, h.wait)
    gathers = _gather_cases()
    handles = [(key, hvd.allgather_async(
        _to_torch(_np_input("uniform", dt, (17,) * dim, seed + rank), dt),
        name=key)) for key, dt, dim, seed in gathers]
    handles += [(key.replace("gather", "bcast"), hvd.broadcast_async(
        _to_torch(_np_input("uniform", dt, (17,) * dim, seed + rank), dt),
        n - 1, name=key.replace("gather", "bcast")))
        for key, dt, dim, seed in gathers]
    for key, h in handles:
        _record(out, key, h.wait)
    # The blockwise wire: each batch submitted back to back, so that the
    # planner fuses it (per dtype and wire).
    handles = [(c.key, hvd.allreduce_async(
        c.input(rank), average=c.average, name=c.key,
        prescale_factor=c.prescale, postscale_factor=c.postscale,
        compression=WIRE_COMPRESSORS[c.wire])) for c in _wire_cases()]
    for key, h in handles:
        _record(out, key, h.wait)

    # The sweep again through dist.all_reduce, NCCL's path on the card.
    eng = tcoll.engine()
    eng._ordered_sum = False
    handles = [(c.key, hvd.allreduce_async(
        c.input(rank), average=c.average, name=f"all_reduce.{c.key}",
        prescale_factor=c.prescale, postscale_factor=c.postscale))
        for c in _sweep_cases()]
    for key, h in handles:
        _record(out, f"all_reduce.{key}", h.wait)
    eng._ordered_sum = True

    # Idle: nothing in flight on any rank.
    rounds = eng.rounds
    time.sleep(IDLE_PAUSE_S)
    out["idle.rounds"] = eng.rounds - rounds
    _save(out, outdir, rank)
    hvd.shutdown()


MISMATCHES = ("shape", "dtype", "op", "root", "average", "gather_rest",
              "gather_0d", "wire")


def _mismatch(kind, rank):
    nm = f"mm.{kind}"
    if kind == "shape":
        return hvd.allreduce(torch.ones(3 if rank == 0 else 5), name=nm)
    if kind == "dtype":
        return hvd.allreduce(torch.ones(4, dtype=torch.float32 if rank % 2
                                        else torch.float64), name=nm)
    if kind == "op":
        if rank == 0:
            return hvd.allreduce(torch.ones(4), name=nm)
        return hvd.broadcast(torch.ones(4), 0, name=nm)
    if kind == "root":
        return hvd.broadcast(torch.ones(4), 0 if rank < 2 else 1, name=nm)
    if kind == "average":
        return hvd.allreduce(torch.ones(4), average=rank == 0, name=nm)
    if kind == "gather_rest":
        return hvd.allgather(torch.ones(2, 3 if rank == 0 else 4), name=nm)
    if kind == "wire":
        return hvd.allreduce(torch.ones(4), name=nm, compression=(
            tcomp.Compression.int8_blockwise if rank == 0
            else tcomp.Compression.fp8_blockwise))
    return hvd.allgather(torch.tensor(float(rank)), name=nm)


def _four_rank_worker(rank, n, port, outdir):
    _init(rank, n, port)
    out = {}
    out["ragged"] = hvd.allgather(torch.full((rank + 1, 2), float(rank)),
                                  name="p4.agv")
    names = [f"p4.x{i}" for i in range(12)]
    order = names[rank:] + names[:rank]
    handles = {nm: hvd.allreduce_async(
        torch.full((3,), float(int(nm.split("x")[1]) + 1)), average=False,
        name=nm) for nm in order}
    out["sums"] = torch.stack([handles[nm].wait() for nm in names])
    out["bcast"] = hvd.broadcast(torch.full((2,), float(rank)), root_rank=3,
                                 name="p4.bc")
    for kind in MISMATCHES:
        _record(out, f"mismatch.{kind}", lambda: _mismatch(kind, rank))

    # Rank 1 holds its submission back; rank 0 times out waiting.
    if rank == 1:
        time.sleep(1.5)
    h = hvd.allreduce_async(torch.ones(2), average=False, name="to.x")
    if rank == 0:
        t0 = time.monotonic()
        _record(out, "timeout.error",
                lambda: hvd.synchronize(h, timeout=0.5))
        out["timeout.waited"] = time.monotonic() - t0
    out["timeout.result"] = hvd.synchronize(h)

    # Every rank but 1 submits sd.x; rank 1 shuts down after sd.sync.
    if rank != 1:
        pending = hvd.allreduce_async(torch.ones(2), name="sd.x")
    hvd.allreduce(torch.ones(1), name="sd.sync")
    if rank == 1:
        hvd.shutdown()
    else:
        _record(out, "shutdown.pending", pending.wait)
        _record(out, "shutdown.after",
                lambda: hvd.allreduce(torch.ones(1), name="sd.after"))
        hvd.shutdown()
    _save(out, outdir, rank)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: [rank 0's results, rank 1's, ...]}, one job each,
    started on first use."""
    cache = {}

    def get(n):
        if n not in cache:
            d = tmp_path_factory.mktemp(f"engine{n}")
            _spawn(_four_rank_worker if n == 4 else _sweep_worker, n, str(d))
            cache[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
        return cache[n]
    return get


# ------------------------------------------------------------------ oracles

def _jax_allreduce(cases, n):
    """{key: numpy result} of the JAX fused reduce over n CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.executor import _fused_reduce
    from horovod_tpu.quantization import parse

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    out = {}
    groups = {}
    for c in cases:
        x64 = c.dtype in ("int64", "float64")
        groups.setdefault((x64, c.average, c.prescale, c.postscale, c.wire),
                          []).append(c)
    for (x64, avg, pre, post, wire), batch in groups.items():
        post = post / n if avg else post
        with jax.enable_x64(x64):
            xs = [jnp.stack([jnp.asarray(c.np_input(r),
                                         dtype=getattr(jnp, c.dtype))
                             for r in range(n)]) for c in batch]

            def body(*ys, pre=pre, post=post, wire=parse(wire)):
                return _fused_reduce(tuple(y[0] for y in ys),
                                     lambda b: jax.lax.psum(b, "dp"), pre,
                                     post, wire=wire, axis="dp", world=n)
            fn = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=tuple(P("dp") for _ in xs),
                out_specs=tuple(P() for _ in xs), check_vma=False))
            for c, o in zip(batch, fn(*xs)):
                out[c.key] = np.asarray(o)
    return out


def _bits(x):
    """Bit pattern of an array or tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        elif x.element_size() == 1 and x.is_floating_point():
            x = x.view(torch.uint8)
        x = x.numpy()
    return x.view(f"u{x.dtype.itemsize}") if x.dtype != np.bool_ else x


def _check_cases(runs, cases, n):
    want = _jax_allreduce(cases, n)
    bad = []
    for rank, res in enumerate(runs(n)):
        for c in cases:
            got = res[c.key]
            if isinstance(got, str):
                bad.append(f"rank {rank} {c.key}: {got}")
            elif (tuple(got.shape) != want[c.key].shape
                  or not np.array_equal(_bits(got), _bits(want[c.key]))):
                diff = int((_bits(got) != _bits(want[c.key])).sum())
                bad.append(f"rank {rank} {c.key}: {diff} elements differ")
    assert not bad, "\n".join(bad[:20])


WORLDS = [2, 3]


@pytest.mark.parametrize("n", WORLDS)
def test_allreduce_sweep_matches_jax(runs, n):
    _check_cases(runs, _sweep_cases(), n)


@pytest.mark.parametrize("n", WORLDS)
def test_allgather_and_broadcast_sweep(runs, n):
    ins = {key: [_np_input("uniform", dt, (17,) * dim, seed + r)
                 for r in range(n)] for key, dt, dim, seed in _gather_cases()}
    for res in runs(n):
        for key, dt, dim, _ in _gather_cases():
            want = np.concatenate(ins[key])
            got = res[key]
            assert not isinstance(got, str), got
            want_t = _to_torch(want, dt)
            assert got.dtype == want_t.dtype and torch.equal(got, want_t)
            b = res[key.replace("gather", "bcast")]
            assert torch.equal(b, _to_torch(ins[key][n - 1], dt))


@pytest.mark.parametrize("n", WORLDS)
def test_allreduce_sweep_on_all_reduce_path_within_tolerance(runs, n):
    """The engine's ``dist.all_reduce`` path (NCCL's on the card): integer
    results bit for bit, float results within 4 units in the last place
    of the largest JAX result of the tensor (the ranks are summed in
    another order than XLA's)."""
    cases = _sweep_cases()
    want = _jax_allreduce(cases, n)
    bad = []
    for rank, res in enumerate(runs(n)):
        for c in cases:
            got, w = res[f"all_reduce.{c.key}"], want[c.key]
            if isinstance(got, str):
                bad.append(f"rank {rank} {c.key}: {got}")
                continue
            g = got.float().numpy() if got.dtype == torch.bfloat16 \
                else got.numpy()
            assert g.shape == w.shape and got.dtype == getattr(torch, c.dtype)
            if c.dtype.startswith(("int", "uint")):
                ok = np.array_equal(g, w)
            else:
                w = np.asarray(w, np.float64)
                eps = float(torch.finfo(getattr(torch, c.dtype)).eps)
                tol = 4 * eps * max(float(np.abs(w).max()), 1.0)
                ok = float(np.abs(g.astype(np.float64) - w).max()) <= tol
            if not ok:
                bad.append(f"rank {rank} {c.key}: beyond tolerance")
    assert not bad, "\n".join(bad[:20])


@pytest.mark.parametrize("n", WORLDS)
def test_idle_world_runs_few_negotiation_rounds(runs, n):
    """With nothing in flight every rank leaves the rounds for up to
    ``IDLE_CYCLE_S``: a pause runs about pause / IDLE_CYCLE_S rounds,
    where a round every 1 ms cycle would run hundreds."""
    limit = IDLE_PAUSE_S / tcoll.IDLE_CYCLE_S + 3
    for r in runs(n):
        assert 0 < r["idle.rounds"] <= limit


def _fault(runs, prefix):
    for n in WORLDS:
        _check_cases(runs, [c for c in _fault_cases()
                            if c.key.startswith(prefix)], n)


def test_integer_average_truncates_toward_zero(runs):
    _fault(runs, "fault1.")


def test_integer_scale_factors_scale_in_float(runs):
    _fault(runs, "fault2.")


def test_half_precision_accumulates_in_fp32(runs):
    _fault(runs, "fault3.")


def test_float_average_multiplies_by_postscale_over_n(runs):
    _fault(runs, "fault5.")


def test_fp8_sums_past_the_range_are_nan_as_in_jax(runs):
    _fault(runs, "fault6.")
    for r in runs(2):       # the case does overflow
        assert r["fault6.float8.sum_post"].float().isnan().any()


@pytest.mark.parametrize("wire", sorted(WIRE_COMPRESSORS))
@pytest.mark.parametrize("n", WORLDS)
def test_blockwise_wire_sweep_matches_jax(runs, n, wire):
    _check_cases(runs, [c for c in _wire_cases() if c.wire == wire], n)


def test_blockwise_wire_packs_each_tensor_block_aligned():
    """A group of wire requests pads each tensor to whole blocks: a small
    tensor fused behind a large one comes out as it does alone. Packed
    back to back, its elements would share a block (and its scale) with
    the large tensor's and quantize to zero."""
    spec = tq.parse("int8x256")
    ident = lambda b: b              # noqa: E731  the collectives at n = 1
    rng = np.random.default_rng(4)
    big = torch.from_numpy((rng.standard_normal(100) * 1e3).astype(
        np.float32))
    small = torch.from_numpy((rng.standard_normal(200) * 1e-3).astype(
        np.float32))
    fused = texec.fused_allreduce([big, small], ident, wire=spec, world=1,
                                  all_to_all_fn=ident, all_gather_fn=ident)
    alone = [texec.fused_allreduce([t], ident, wire=spec, world=1,
                                   all_to_all_fn=ident,
                                   all_gather_fn=ident)[0]
             for t in (big, small)]
    for got, want in zip(fused, alone):
        assert torch.equal(got, want)
    assert torch.count_nonzero(fused[1]) > 150       # of 200
    packed = torch.cat([big, small, torch.zeros(212)])
    back_to_back = tq.allreduce_blocks(packed, spec, 1, ident, ident)
    assert not torch.equal(back_to_back[100:300], fused[1])
    assert not back_to_back[100:256].any()


def test_blockwise_compressor_keeps_integers_exact(world_one):
    comp = tcomp.Compression.int8_blockwise
    assert tcoll._wire_for(torch.ones(3), comp) == "int8x256"
    assert tcoll._wire_for(torch.ones(3, dtype=torch.bfloat16),
                           comp) == "int8x256"
    assert tcoll._wire_for(torch.arange(3), comp) is None
    assert tcoll._wire_for(torch.ones(3), tcomp.Compression.fp16) is None
    x = torch.arange(-500, 500, dtype=torch.int32)
    assert torch.equal(hvd.allreduce(x, compression=comp, name="ints"), x)


def test_integer_average_example():
    """JAX's [-1, 1, -2] for a sum of [-3, 3, -5] over 2 ranks, through
    the executor's arithmetic with the sum in place of the collective."""
    parts = torch.tensor([[-1, 1, -2], [-2, 2, -3]], dtype=torch.int32)
    out = texec.fused_allreduce([parts[0]], lambda b: parts.sum(0), 1.0,
                                1.0 / 2)
    assert out[0].tolist() == [-1, 1, -2]


@pytest.mark.parametrize("dtype", ["complex64", "bool", "int8",
                                   "bfloat16", "float32"])
def test_executor_matches_jax_in_process(dtype):
    """The executor's arithmetic against ``_fused_reduce`` run eagerly,
    with "two identical ranks" (b + b) as the reduction: complex stays
    complex when scaled, bool sums in int32."""
    import jax.numpy as jnp
    from horovod_tpu.executor import _fused_reduce
    rng = np.random.RandomState(3)
    x = rng.uniform(-100, 100, size=(33,))
    if dtype == "complex64":
        x = x + 1j * rng.uniform(-100, 100, size=(33,))
    elif dtype == "bool":
        x = x > 0
    elif dtype == "int8":
        x = x.astype(np.int8)
    x = x.astype(np.float32 if dtype == "bfloat16" else dtype)
    want = _fused_reduce((jnp.asarray(x, dtype=getattr(jnp, dtype)),),
                         lambda b: b + b, 0.5, 1.0 / 3)[0]
    got = texec.fused_allreduce([_to_torch(x, dtype)], lambda b: b + b,
                                0.5, 1.0 / 3)[0]
    assert np.array_equal(_bits(got), _bits(np.asarray(want)))


# --------------------------------------------------------------- four ranks

def test_four_ranks_rotation_ragged_and_broadcast(runs):
    res = runs(4)
    ragged = torch.cat([torch.full((r + 1, 2), float(r)) for r in range(4)])
    for r in res:
        assert torch.equal(r["ragged"], ragged)
        assert torch.equal(r["sums"], 4.0 * torch.arange(1, 13.0)[:, None]
                           .expand(12, 3))
        assert torch.equal(r["bcast"], torch.full((2,), 3.0))


def _jax_message(kind):
    """The JAX coordinator's message for the 4-rank mismatch ``kind``."""
    from horovod_tpu.ops.control_plane import CoordinatorService, _Entry
    e = _Entry(0)
    for rank in range(4):
        m = _mismatch_meta(kind, rank)
        e.op_by_rank[rank] = m.op
        e.dtype_by_rank[rank] = m.dtype
        e.shape_by_rank[rank] = m.shape
        e.root_by_rank[rank] = m.root_rank
        e.device_by_rank[rank] = _jax_fingerprint(m)
    return CoordinatorService._validate(None, m.name, e)


def _mismatch_meta(kind, rank):
    """What rank ``rank`` announces in ``_mismatch(kind, rank)``."""
    nm = f"mm.{kind}"
    meta = dict(name=nm, op=tcp.ALLREDUCE, dtype="float32", shape=(4,),
                average=True)
    if kind == "shape":
        meta["shape"] = (3 if rank == 0 else 5,)
    elif kind == "dtype":
        meta["dtype"] = "float64" if rank % 2 == 0 else "float32"
    elif kind in ("op", "root"):
        if kind == "root" or rank:
            meta.update(op=tcp.BROADCAST, average=False,
                        root_rank=0 if kind == "op" or rank < 2 else 1)
    elif kind == "average":
        meta["average"] = rank == 0
    elif kind == "gather_rest":
        meta.update(op=tcp.ALLGATHER, shape=(2, 3 if rank == 0 else 4),
                    average=False)
    elif kind == "wire":
        meta["wire"] = "int8x256" if rank == 0 else "fp8x256"
    else:
        meta.update(op=tcp.ALLGATHER, shape=(), average=False)
    return tcp.Meta(**meta)


def _jax_fingerprint(m):
    from horovod_tpu.ops.collective import _Request, _semantics_fingerprint
    req = _Request(m.name, m.op, np.zeros((1,), np.float32), None,
                   average=m.average, prescale=m.prescale,
                   postscale=m.postscale, wire=m.wire)
    return _semantics_fingerprint(req)


@pytest.mark.parametrize("kind", MISMATCHES)
def test_four_ranks_mismatch_raises_jax_message(runs, kind):
    want = _jax_message(kind)
    assert want.startswith("Mismatched")
    for r in runs(4):
        assert r[f"mismatch.{kind}"] == f"error: HorovodInternalError: {want}"


def test_four_ranks_synchronize_timeout_then_finish(runs):
    res = runs(4)
    assert res[0]["timeout.error"] == (
        "error: TimeoutError: collective 'to.x' did not complete within "
        "0.5s")
    assert 0.5 <= res[0]["timeout.waited"] < 1.4
    for r in res:
        assert torch.equal(r["timeout.result"], torch.full((2,), 4.0))


def test_four_ranks_shutdown_fails_pending_op(runs):
    msg = tcoll.SHUT_DOWN_ERROR.format(op="allreduce")
    for rank, r in enumerate(runs(4)):
        if rank == 1:
            continue
        assert r["shutdown.pending"] == f"error: HorovodInternalError: {msg}"
        assert r["shutdown.after"] == f"error: HorovodInternalError: {msg}"


# ------------------------------------------------- planner and validation

def _jax_req(name, op=0, n=16, dtype=np.float32, wire=None, root_rank=0,
             average=False, prescale=1.0, postscale=1.0, per_rank=None):
    from horovod_tpu.ops.collective import _Request
    tensor = None if per_rank is not None else np.zeros((n,), dtype)
    return _Request(name, op, tensor, handle=None, per_rank=per_rank,
                    root_rank=root_rank, average=average, prescale=prescale,
                    postscale=postscale, wire=wire)


def _port_item(req):
    return tcp.Ready(req.name, tcp.fusion_key(
        req.op, str(req.dtype), req.wire, req.root_rank, req.average,
        req.prescale, req.postscale), req.nbytes, req.per_rank is not None)


def _plans(batch, threshold):
    from horovod_tpu.ops.collective import CollectiveEngine
    eng = CollectiveEngine.__new__(CollectiveEngine)
    eng.fusion_threshold = threshold
    want = [[r.name for r in g] for g in eng._plan_fusion(batch)]
    got = [[r.name for r in g]
           for g in tcp.plan_fusion([_port_item(r) for r in batch],
                                    threshold)]
    return got, want


def _fixed_batches():
    z = np.zeros
    return {
        "mixed": ([_jax_req("a0"), _jax_req("g0", 1, 8), _jax_req("a1"),
                   _jax_req("i0", dtype=np.int32),
                   _jax_req("b0", 2, 4, root_rank=2),
                   _jax_req("a2", dtype=np.float16),
                   _jax_req("b1", 2, 4, root_rank=2),
                   _jax_req("i1", dtype=np.int32),
                   _jax_req("b2", 2, 4, root_rank=1)], 64 << 20),
        "wire": ([_jax_req("p0", n=64), _jax_req("q0", n=64, wire="int8x256"),
                  _jax_req("p1", n=64), _jax_req("q1", n=64, wire="int8x256"),
                  _jax_req("f0", n=64, wire="fp8x256")], 64 << 20),
        "look_ahead": ([_jax_req("a", n=3), _jax_req("big", n=4),
                        _jax_req("c", n=2)], 20),
        "oversized_head": ([_jax_req("huge", n=100), _jax_req("t0", n=1),
                            _jax_req("t1", n=100)], 4),
        "ragged": ([_jax_req("a0", 1, 8),
                    _jax_req("r0", 1, per_rank=[z((2,), np.float32),
                                                z((3,), np.float32)]),
                    _jax_req("a1", 1, 8)], 64 << 20),
    }


@pytest.mark.parametrize("case", sorted(_fixed_batches()))
def test_planner_matches_jax_fixed(case):
    batch, threshold = _fixed_batches()[case]
    got, want = _plans(batch, threshold)
    assert got == want


@pytest.mark.parametrize("seed", range(12))
def test_planner_matches_jax_randomized(seed):
    """The randomized batches of tests/test_fusion_planner.py (seeds 0-5),
    and six more."""
    rng = np.random.RandomState(seed)
    threshold = int(rng.choice([64, 512, 4096, 1 << 26]))
    batch = []
    for i in range(rng.randint(1, 60)):
        kind = rng.randint(4)
        if kind == 3 and rng.rand() < 0.2:
            batch.append(_jax_req(
                f"r{i}", 1, per_rank=[np.zeros((rng.randint(1, 4),),
                                               np.float32)
                                      for _ in range(2)]))
            continue
        batch.append(_jax_req(
            f"t{i}", op=[0, 1, 2][rng.randint(3)], n=int(rng.randint(1, 200)),
            dtype=[np.float32, np.float16, np.int32][rng.randint(3)],
            wire=[None, "int8x256", "fp8x256"][rng.randint(3)],
            root_rank=int(rng.randint(2)), average=bool(rng.randint(2)),
            prescale=float(rng.choice([1.0, 0.5]))))
    got, want = _plans(batch, threshold)
    assert got == want


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 70000])
@pytest.mark.parametrize("wire", [None, "int8x256", "fp8x256", "int8x64"])
def test_meta_counts_wire_bytes_as_jax(wire, n):
    m = tcp.Meta("t", tcp.ALLREDUCE, "float32", (n,), wire=wire)
    assert m.nbytes == _jax_req("t", n=n, wire=wire).nbytes


def test_planner_cuts_on_wire_bytes():
    """Eight fp32 tensors of 256 elements: 1 KiB each, 260 bytes on the
    int8x256 wire. At a 600-byte threshold the wire requests fuse in
    pairs, the plain ones not at all, as the JAX planner decides."""
    c = tcp.Coordinator(1)
    metas = [tcp.Meta(f"w{i}", tcp.ALLREDUCE, "float32", (256,),
                      wire="int8x256" if i % 2 else None) for i in range(8)]
    got = [g.names for g in c.cycle([metas], 600)]
    assert got == [["w0"], ["w1", "w3"], ["w2"], ["w4"], ["w5", "w7"],
                   ["w6"]]
    _, want = _plans([_jax_req(m.name, n=256, wire=m.wire) for m in metas],
                     600)
    assert got == want


@pytest.mark.parametrize("kind", MISMATCHES)
def test_validate_matches_jax_coordinator(kind):
    e = tcp.Entry()
    for rank in range(4):
        e.add(rank, _mismatch_meta(kind, rank))
    assert tcp.validate(f"mm.{kind}", e) == _jax_message(kind)


@pytest.mark.parametrize("average,pre,post", [
    (False, 1.0, 1.0), (True, 1.0, 1.0), (True, 0.5, 2.0), (False, 0.3, 1.0)])
def test_fingerprint_matches_jax(average, pre, post):
    m = tcp.Meta("t", 0, "float32", (4,), 0, average, pre, post)
    assert tcp.semantics_fingerprint(*m.attrs) == _jax_fingerprint(m)


def test_coordinator_waits_for_every_rank_and_keeps_order():
    """A name is planned once every rank announced it, whatever the
    order; groups follow first announcement; a ragged allgather stands
    alone with every rank's rows."""
    c = tcp.Coordinator(2)
    meta = [tcp.Meta(f"x{i}", 0, "float32", (4,)) for i in range(3)]
    assert c.cycle([[meta[2], meta[0]], [meta[1]]], 1 << 20) == []
    groups = c.cycle([[meta[1]], [meta[2], meta[0]]], 1 << 20)
    assert [g.names for g in groups] == [["x2", "x0", "x1"]]
    assert c.pending() == 0
    g0 = tcp.Meta("g", tcp.ALLGATHER, "float32", (2, 3))
    g1 = tcp.Meta("g", tcp.ALLGATHER, "float32", (5, 3))
    (group,) = c.cycle([[g0], [g1]], 1 << 20)
    assert group.names == ["g"] and group.rows == {"g": [2, 5]}


# ------------------------------------------------------------ world size 1

@pytest.fixture
def world_one():
    hvd.init(device="cpu")
    yield


def _quiet_engine(monkeypatch):
    """Pause the engine's cycle for a minute, so that a burst is drained
    at once by the first blocking wait. The wait for "quiet" may leave
    a wake-up behind (it can land after the engine took the op on its
    1 ms cycle); it is cleared, or it would drain the next op at once."""
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "60000")
    hvd.allreduce(torch.zeros(1), name="quiet")
    time.sleep(0.05)
    tcoll.engine()._wake.clear()


def test_world_one_fuses_by_first_fit(world_one, monkeypatch):
    _quiet_engine(monkeypatch)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "20")
    ts = [torch.ones(4), torch.full((4,), 2.0), torch.arange(2),
          torch.ones(1), torch.ones(2, dtype=torch.bfloat16),
          torch.ones(3, dtype=torch.float16)]
    h = tcoll.fused_allreduce_async(ts, name="ff")
    for a, b in zip(h.wait(), ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # fp32: 16 + 4 fit in 20 bytes; bf16 and fp16 share a planning key.
    assert h.groups == [("ff.0", "ff.3"), ("ff.1",), ("ff.2",),
                        ("ff.4", "ff.5")]


def test_world_one_allgather_of_a_scalar_is_refused(world_one):
    with pytest.raises(hvd.HorovodInternalError,
                       match="Mismatched allgather tensor shapes"):
        hvd.allgather(torch.tensor(1.0), name="scalar")


def test_world_one_wrong_device_and_timeout(world_one, monkeypatch):
    with pytest.raises(ValueError, match="collectives run on cpu"):
        hvd.allreduce(torch.ones(2, device="meta"), name="meta")
    _quiet_engine(monkeypatch)
    h = hvd.allreduce_async(torch.ones(2), name="late")
    # poll() does not wake the engine; wait(timeout) does.
    assert not hvd.poll(h)
    assert torch.equal(hvd.synchronize(h, timeout=30.0), torch.ones(2))
