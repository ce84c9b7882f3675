"""The port's incremental decode over the paged KV pool
(``Transformer.apply_decode``) against the JAX package's ``apply_decode``
on the same parameters, tokens, block tables and pool.

Every scenario runs JAX's function under ``jax.jit``, as its serving
engine does, and the port's on the CPU. Tolerances (fp32): logits within
1e-5 of the largest |logit| against JAX's, and against JAX's full
``apply`` where one exists; the unquantized pool's K/V within 1e-5 of
its largest value; the int8 and fp8 pools' payload and scales exactly
where the quantizer's inputs are the same bits in both frameworks.
bf16: 3e-2 of the largest |logit|. tp=2 (2 gloo ranks) against JAX's
tp=2 ``shard_map`` and the port's tp=1: 1e-5 of the largest |logit|,
layer 0's int8 payload and scales bit for bit across the tp widths. Scratch block 0 is
never compared: duplicate writes land there in an unspecified order.
"""

import dataclasses
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu.models import transformer as jtfm
from horovod_tpu_torch import quantization as tq
from horovod_tpu_torch.models import transformer as ttfm

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, remat=False)
BS = 4
N_BLOCKS = 40
JOB_TIMEOUT_S = 240


def _configs(jdtype=jnp.float32, tdtype=torch.float32, **over):
    kw = dict(SMALL, **over)
    return (jtfm.TransformerConfig(dtype=jdtype, **kw),
            ttfm.TransformerConfig(dtype=tdtype, **kw))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs()
    return jax.device_get(jtfm.init_params(jcfg, jax.random.PRNGKey(0)))


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab"], size=shape).astype(np.int32)


def _tables(rows):
    """Disjoint tables of 16 blocks (the whole max_seq of 64) a row."""
    return np.stack([np.arange(1 + 16 * r, 17 + 16 * r, dtype=np.int32)
                     for r in range(rows)])


# Each scenario: a list of (tokens, starts, exact_chunk) calls on one
# pool with one table a row. "past_max_seq_*" are the clamping cases.
def _scenarios():
    t = _tables(2)
    t1 = t[:1]
    long = _tokens((1, 64), 7)
    padded = np.concatenate([long[:, 56:], _tokens((1, 24), 8)], axis=1)
    return {
        "prefill": [(_tokens((2, 12), 1), [0, 0], True, t)],
        "prefill_then_decode": (
            [(_tokens((2, 9), 2), [0, 0], True, t)]
            + [(_tokens((2, 1), 10 + i), [9 + i, 9 + i], False, t)
               for i in range(6)]),
        "padded_bucket": [(np.concatenate(
            [_tokens((2, 5), 3), np.zeros((2, 3), np.int32)], axis=1),
            [0, 0], True, t),
            (_tokens((2, 1), 4), [5, 5], False, t)],
        "chunked_prefill": [
            (_tokens((2, 24), 5)[:, a:a + n], [a, a], True, t)
            for a, n in ttfm.prefill_spans(24, 8)],
        "ragged_rows": [(_tokens((2, 8), 6), [0, 3], True, t),
                        (_tokens((2, 2), 9), [8, 11], False, t)],
        # A 20-token chunk from 56 padded to a 32-bucket: positions
        # 56-87, past the table (64) and past max_seq.
        "past_max_seq_padded_prefill": [
            (long[:, :56], [0], True, t1),
            (padded, [56], True, t1)],
        # A speculative verify chunk of 4 at the end of a 64-token
        # request: positions 62-65.
        "past_max_seq_spec_verify": [
            (long[:, :62], [0], True, t1),
            (long[:, 61:62].repeat(4, axis=1), [62], False, t1)],
    }


SCENARIOS = sorted(_scenarios())


def _jax_fwd(jcfg, kv_quant, exact):
    return jax.jit(lambda p, kv, t, s, bt: jtfm.apply_decode(
        p, t, s, bt, kv, jcfg, kv_quant=kv_quant, exact_chunk=exact))


def _run_jax(tree, jcfg, calls, kv_quant=None):
    cache = jtfm.init_cache(jcfg, N_BLOCKS, BS, kv_quant)
    fwds = {e: _jax_fwd(jcfg, kv_quant, e) for e in (False, True)}
    out = []
    for tok, starts, exact, tabs in calls:
        lg, cache = fwds[exact](tree, cache, jnp.asarray(tok),
                                jnp.asarray(starts, jnp.int32),
                                jnp.asarray(tabs))
        out.append(np.asarray(lg))
    return out, jax.device_get(cache)


def _run_torch(model, calls, kv_quant=None, cache=None):
    if cache is None:
        cache = model.init_cache(N_BLOCKS, BS, kv_quant)
    out = []
    with torch.inference_mode():
        for tok, starts, exact, tabs in calls:
            lg, cache2 = model.apply_decode(
                torch.from_numpy(tok), torch.tensor(starts),
                torch.from_numpy(tabs), cache, kv_quant=kv_quant,
                exact_chunk=exact)
            assert cache2 is cache
            out.append(lg.float().numpy())
    return out, cache


def _close(got, want, rel):
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"max |err| {err} > {rel} x {scale}"


def _pool_np(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_pool_np(a):
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", SCENARIOS)
def test_decode_matches_jax(tree, name):
    jcfg, tcfg = _configs()
    calls = _scenarios()[name]
    want, jcache = _run_jax(tree, jcfg, calls)
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    got, cache = _run_torch(model, calls)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-5)
    for layer, jlayer in zip(cache, jcache):
        for n in ("k", "v"):
            _close(_pool_np(layer[n])[1:], _jax_pool_np(jlayer[n])[1:],
                   1e-5)


@pytest.mark.parametrize("name", ["prefill_then_decode", "chunked_prefill",
                                  "padded_bucket"])
def test_incremental_matches_full_apply(tree, name):
    """Every real position's logits against JAX's full-context
    ``apply`` over the same tokens (row 0 of the tables)."""
    jcfg, tcfg = _configs()
    calls = _scenarios()[name]
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    got, _ = _run_torch(model, calls)
    seq, rows = [], []
    for (tok, starts, _, _), lg in zip(calls, got):
        n = tok.shape[1] if name != "padded_bucket" or starts[0] else 5
        seq.append(tok[:1, :n])
        rows.append(lg[:1, :n])
    full = np.asarray(jtfm.apply(tree, jnp.asarray(np.concatenate(seq, 1)),
                                 jcfg))
    _close(np.concatenate(rows, 1), full, 1e-5)


def test_bf16_matches_jax(tree):
    jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
    calls = _scenarios()["prefill_then_decode"]
    want, _ = _run_jax(tree, jcfg, calls)
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    got, _ = _run_torch(model, calls)
    for g, w in zip(got, want):
        _close(g, w, 3e-2)


def _unfolded(monkeypatch):
    """The quantizer as JAX's function computes it run eagerly (absmax /
    qmax): the form the jitted program does not take."""
    real = tq.quantize_channels
    monkeypatch.setattr(tq, "quantize_channels",
                        lambda x, spec, folded=False: real(x, spec))


def _exact_row(rng, d):
    """An embedding row whose layernorm is exact in any framework: n2
    entries of +-2048, n1 of +-1024 and zeros, half of each sign, with
    n1 + 4 n2 = d, so the mean is 0, the variance 2^20 (1e-5 vanishes
    beside it) and the normalised row holds 0, +-1 and +-2."""
    n2 = 2 * rng.randint(1, 5)
    n1 = d - 4 * n2
    row = np.zeros(d, np.float32)
    row[:n2] = 2048.0 * np.repeat([1, -1], n2 // 2)
    row[n2:n2 + n1] = 1024.0 * np.repeat([1, -1], n1 // 2)
    return rng.permutation(row)


def _exact_tree(tree):
    """``tree`` with layer 0's K and V inputs made the same bits in both
    frameworks: embedding rows from :func:`_exact_row`, a zero position
    table, and ``wk``/``wv`` permutations with random weights, so each K
    and V element is one rounded product. The two frameworks' GEMMs and
    layernorms then cannot round differently, and what the pool holds
    shows the quantizer's form alone."""
    rng = np.random.RandomState(11)
    d = SMALL["d_model"]
    out = jax.tree_util.tree_map(np.array, tree)
    out["embed"] = np.stack([_exact_row(rng, d)
                             for _ in range(SMALL["vocab"])])
    out["pos"] = np.zeros_like(out["pos"])
    for name in ("wk", "wv"):
        w = np.zeros((d, d), np.float32)
        w[np.arange(d), rng.permutation(d)] = rng.randn(d)
        out["layers"][0][name] = w
    return out


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["prefill_then_decode",
                                  "past_max_seq_padded_prefill"])
def test_quantized_pool_matches_jitted_jax(tree, kv, name, monkeypatch):
    """Layer 0's int8/fp8 payload and scales equal those of JAX's jitted
    ``apply_decode`` exactly (on :func:`_exact_tree`, where the
    quantizer's inputs are the same bits), and the logits JAX's within
    1e-5. The inputs discriminate: the eager quantizer (absmax / qmax)
    writes other scales than the compiled one (absmax * fl(1/qmax))."""
    tree = _exact_tree(tree)
    jcfg, tcfg = _configs()
    calls = _scenarios()[name]
    want, jcache = _run_jax(tree, jcfg, calls, kv)
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    got, cache = _run_torch(model, calls, kv)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    for n in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_pool_np(cache[0][n])[1:],
                                      _jax_pool_np(jcache[0][n])[1:],
                                      err_msg=n)
    _unfolded(monkeypatch)
    _, eager = _run_torch(model, calls, kv)
    assert not np.array_equal(_pool_np(eager[0]["ks"])[1:],
                              _jax_pool_np(jcache[0]["ks"])[1:])


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_prefill_is_exact(tree, kv):
    """A from-empty prefill with ``exact_chunk`` gives the unquantized
    pool's logits bit for bit."""
    _, tcfg = _configs()
    calls = _scenarios()["prefill"]
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    ref, _ = _run_torch(model, calls)
    got, _ = _run_torch(model, calls, kv)
    np.testing.assert_array_equal(got[0], ref[0])


def test_pool_is_written_in_place(tree):
    _, tcfg = _configs()
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    for kv in (None, "int8", "fp8"):
        cache = model.init_cache(N_BLOCKS, BS, kv)
        ptrs = [{n: t.data_ptr() for n, t in layer.items()}
                for layer in cache]
        before = [{n: t.clone() for n, t in layer.items()}
                  for layer in cache]
        _run_torch(model, _scenarios()["prefill_then_decode"], kv, cache)
        assert [{n: t.data_ptr() for n, t in layer.items()}
                for layer in cache] == ptrs
        assert not torch.equal(_bytes(cache[0]["k"]),
                               _bytes(before[0]["k"]))


def _bytes(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.mark.parametrize("over,match", [
    (dict(sp_axis="sp"), "sequence parallelism"),
    (dict(num_experts=2, ep_axis="ep"), "MoE layers")])
def test_refuses_sp_and_moe(over, match):
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg, **over)
    model = ttfm.Transformer(_configs()[1], device="cpu")
    object.__setattr__(model, "cfg", cfg)
    cache = ttfm.init_cache(tcfg, 4, BS, device="cpu")
    with pytest.raises(ValueError, match=match):
        model.apply_decode(torch.zeros((1, 1), dtype=torch.long),
                           torch.zeros(1, dtype=torch.long),
                           torch.ones((1, 2), dtype=torch.long), cache)


@pytest.mark.parametrize("kv", [None, "int8", "fp8", "int8x16"])
def test_pool_shapes_and_bytes_match_jax(kv):
    for over in (dict(), dict(d_model=96, n_heads=3)):
        jcfg, tcfg = _configs(**over)
        want = jax.device_get(jtfm.init_cache(jcfg, 5, BS, kv))
        got = ttfm.init_cache(tcfg, 5, BS, kv, device="cpu")
        for layer, jlayer in zip(got, want):
            assert sorted(layer) == sorted(jlayer)
            for n in layer:
                assert tuple(layer[n].shape) == jlayer[n].shape
                np.testing.assert_array_equal(_pool_np(layer[n]),
                                              _jax_pool_np(jlayer[n]))
        assert ttfm.kv_bytes_per_block(tcfg, 16, kv) == \
            jtfm.kv_bytes_per_block(jcfg, 16, kv)
        spec = tuple(jtfm.cache_specs(
            dataclasses.replace(jcfg, tp_axis="tp"), kv)[0]["k"])
        assert ttfm.cache_specs(
            dataclasses.replace(tcfg, tp_axis="tp"), kv)[0]["k"] == spec


@pytest.mark.parametrize("args", [(10, 4), (10, 4, 3), (0, 4), (7, 16)])
def test_prefill_spans_match_jax(args):
    assert ttfm.prefill_spans(*args) == jtfm.prefill_spans(*args)


def test_flagship_bytes_per_block():
    """The flagship's pool block at block size 16: 589,824 bytes in
    bf16 and 304,128 in int8 (the chip's phase 21 reads both)."""
    cfg = ttfm.TransformerConfig(vocab=32000, d_model=768, n_layers=12,
                                 d_ff=3072, max_seq=2048)
    assert ttfm.kv_bytes_per_block(cfg, 16) == 589824
    assert ttfm.kv_bytes_per_block(cfg, 16, "int8") == 304128


# ------------------------------------------------------------ tp = 2

TP_CALLS = "prefill_then_decode"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tp_worker(rank, port, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"tcp://localhost:{port}", rank=rank,
             world_size=2)
    mesh = create_mesh(tp=2)
    tree = np.load(os.path.join(outdir, "tree.npy"), allow_pickle=True)
    _, tcfg = _configs(tp_axis="tp")
    model = ttfm.Transformer(tcfg, generator=None, device="cpu", mesh=mesh,
                             params=_shard(_torch_tree(tree.item()), tcfg,
                                           mesh))
    out = {}
    for kv in (None, "int8"):
        got, cache = _run_torch(model, _scenarios()[TP_CALLS], kv)
        out[kv] = (got, [{n: t.clone() for n, t in layer.items()}
                         for layer in cache])
    hvd.shutdown()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def _shard(tree, cfg, mesh):
    from horovod_tpu_torch.parallel.mesh import place, shard_tree
    return shard_tree(tree, ttfm.param_specs(cfg), *place(mesh))


@pytest.fixture(scope="module")
def tp_ranks(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_tp")
    np.save(d / "tree.npy", tree, allow_pickle=True)
    ctx = mp.spawn(_tp_worker, args=(_free_port(), str(d)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2-rank job did not finish within "
                        f"{JOB_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _jax_tp2(tree, kv):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from horovod_tpu.parallel.mesh import create_mesh
    jcfg, _ = _configs(tp_axis="tp")
    mesh = create_mesh(devices=jax.devices()[:2], tp=2)
    specs = jtfm.param_specs(jcfg)
    cspecs = jtfm.cache_specs(jcfg, kv)

    def put(t, sp):
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            t, sp, is_leaf=lambda x: isinstance(x, P))

    params = put(tree, specs)
    cache = put(jtfm.init_cache(jcfg, N_BLOCKS, BS, kv), cspecs)
    fwds = {e: jax.jit(jax.shard_map(
        lambda p, c, t, s, bt, e=e: jtfm.apply_decode(
            p, t, s, bt, c, jcfg, kv_quant=kv, exact_chunk=e),
        mesh=mesh, in_specs=(specs, cspecs, P(), P(), P()),
        out_specs=(P(), cspecs), check_vma=False)) for e in (False, True)}
    out = []
    for tok, starts, exact, tabs in _scenarios()[TP_CALLS]:
        lg, cache = fwds[exact](params, cache, jnp.asarray(tok),
                                jnp.asarray(starts, jnp.int32),
                                jnp.asarray(tabs))
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("kv", [None, "int8"])
def test_tp2_matches_jax_and_tp1(tree, tp_ranks, kv):
    _, tcfg = _configs()
    model = ttfm.Transformer(tcfg, params=_torch_tree(tree), device="cpu")
    tp1, tp1_cache = _run_torch(model, _scenarios()[TP_CALLS], kv)
    want = _jax_tp2(tree, kv)
    h = SMALL["n_heads"] // 2
    for rank, out in enumerate(tp_ranks):
        got, cache = out[kv]
        for g, w, one in zip(got, want, tp1):
            _close(g, w, 1e-5)
            _close(g, one, 1e-5)
        if kv is None:
            continue
        # Layer 0's K/V come from the embeddings through a column slice
        # of the projection, so its head shard quantizes exactly as at
        # tp=1; later layers read sums the psum took in another order.
        for layer, full in zip(cache[:1], tp1_cache[:1]):
            for n in ("k", "v", "ks", "vs"):
                np.testing.assert_array_equal(
                    _pool_np(layer[n])[1:],
                    _pool_np(full[n][:, :, rank * h:(rank + 1) * h])[1:],
                    err_msg=n)
