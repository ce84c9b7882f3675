"""The port's block-scaled wire (``horovod_tpu_torch/quantization.py``)
and its compressors against the JAX package's, on the CPU.

Every comparison is bit for bit (payload bits, scales, dequantized
values and round trips): both sides take the absmax of each block,
divide by it in fp32, round half to even (int8) or cast to e4m3 with
NaN past ±448 (fp8). Inputs come from ``numpy.random.default_rng``:
lengths that are and are not whole blocks, all-zero blocks, an empty
tensor, fp32/bf16/fp16, and magnitudes from 1e-30 to 1e30.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import compression as jcomp
from horovod_tpu import quantization as jq
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch import quantization as tq

SPECS = ["int8x256", "fp8x256", "int8x64", "fp8x32"]
MAGNITUDES = [1e-30, 1e-8, 1.0, 1e8, 1e30]
DTYPES = ["float32", "bfloat16", "float16"]


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _bits(x):
    """Bit pattern of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy()
    else:
        x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


def _same(got, want):
    g, w = _bits(got), _bits(want)
    return g.shape == w.shape and np.array_equal(g, w)


def _draw(n, mag, seed, dtype="float32", zero_blocks=(), block=256):
    x = np.random.default_rng(seed).standard_normal(n) * mag
    if dtype == "float16":
        x = np.clip(x, -6e4, 6e4)
    for b in zero_blocks:
        x[b * block:(b + 1) * block] = 0.0
    return x.astype(np.float32).astype(_np_dtype(dtype))


def _torch(x):
    """The same bits as a tensor (a cast would drop a bf16 NaN's sign)."""
    x = np.ascontiguousarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("spec", SPECS + ["int8", "fp8", "int8x7"])
def test_parse_and_sizes_match_jax(spec):
    j, t = jq.parse(spec), tq.parse(spec)
    assert tuple(t) == tuple(j)
    assert (t.qmax, t.encoded()) == (j.qmax, j.encoded())
    for n in (0, 1, 255, 256, 257, 1000, 65536 + 3):
        assert tq.wire_nbytes(spec, n) == jq.wire_nbytes(spec, n)
        assert tq.padded_size(n, t.block_size) == jq.padded_size(
            n, j.block_size)


@pytest.mark.parametrize("spec", ["int4x256", "int8xabc", "bf16"])
def test_malformed_spec_raises_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jq.parse(spec)
    with pytest.raises(ValueError) as got:
        tq.parse(spec)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- blocks

@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("spec", SPECS)
def test_quantize_dequantize_blocks_match_jax(spec, mag):
    js, ts = jq.parse(spec), tq.parse(spec)
    bs = js.block_size
    x = _draw(5 * bs, mag, seed=int(np.log10(mag)) + 40,
              zero_blocks=(0, 3), block=bs)
    jqv, jsv = jq.quantize_blocks(jnp.asarray(x), js)
    tqv, tsv = tq.quantize_blocks(torch.from_numpy(x), ts)
    assert tqv.dtype == getattr(torch, js.wire_dtype)
    assert _same(tqv, jqv) and _same(tsv, jsv)
    # All-zero blocks keep scale 1 and come back exactly zero.
    assert tsv[0] == 1.0 and tsv[3] == 1.0
    jd = jq.dequantize_blocks(jqv, jsv, js)
    td = tq.dequantize_blocks(tqv, tsv, ts)
    assert _same(td, jd)
    assert not td[:bs].any() and not td[3 * bs:4 * bs].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [0, 1, 100, 256, 700])
@pytest.mark.parametrize("spec", SPECS)
def test_local_roundtrip_matches_jax(spec, n, dtype):
    x = _draw(n, 3.0, seed=n, dtype=dtype)
    want = jq.local_roundtrip(jnp.asarray(x), spec)
    got = tq.local_roundtrip(_torch(x), spec)
    assert str(got.dtype)[6:] == dtype and tuple(got.shape) == (n,)
    assert _same(got, np.asarray(want))


@pytest.mark.parametrize("mag", MAGNITUDES)
def test_local_roundtrip_magnitudes_and_shapes(mag):
    x = _draw(3 * 7 * 45, mag, seed=3).reshape(3, 7, 45)
    for spec in SPECS:
        want = jq.local_roundtrip(jnp.asarray(x), spec)
        got = tq.local_roundtrip(torch.from_numpy(x), spec)
        assert _same(got, np.asarray(want)), spec


@pytest.mark.parametrize("shape,block", [((2, 3, 64), 256), ((4, 96), 256),
                                         ((5, 100), 32), ((3, 8, 128), 64)])
@pytest.mark.parametrize("spec_tag", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_channels_match_jax(shape, block, spec_tag, dtype):
    spec = f"{spec_tag}x{block}"
    assert tq.channel_block(shape[-1], block) == jq.channel_block(
        shape[-1], block)
    x = _draw(int(np.prod(shape)), 2.0, seed=sum(shape), dtype=dtype)
    x = x.reshape(shape)
    x[0, ..., :] = 0          # an all-zero channel chunk
    jqv, jsv = jq.quantize_channels(jnp.asarray(x), spec)
    tqv, tsv = tq.quantize_channels(_torch(x), spec)
    assert _same(tqv, jqv) and _same(tsv, jsv)
    assert tuple(tsv.shape) == tuple(jsv.shape)
    assert _same(tq.dequantize_channels(tqv, tsv, spec),
                 jq.dequantize_channels(jqv, jsv, spec))


@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("spec", SPECS)
def test_folded_quantizer_matches_compiled_jax(spec, mag):
    """Compiled, XLA's CPU backend turns the scale's absmax / qmax into
    absmax * (1 / qmax); the wire's quantizer does the same."""
    js, ts = jq.parse(spec), tq.parse(spec)
    x = _draw(6 * js.block_size, mag, seed=11, zero_blocks=(2,),
              block=js.block_size)
    jqv, jsv = jax.jit(jq.quantize_blocks, static_argnums=1)(
        jnp.asarray(x), js)
    tqv, tsv = tq.quantize_blocks(torch.from_numpy(x), ts, folded=True)
    assert _same(tqv, jqv) and _same(tsv, jsv)


def test_allreduce_blocks_at_one_rank_is_the_closed_form():
    """At one rank the collectives are the identity: the result is
    dequant(quant(0 + dequant(quant(x)))) with the wire's quantizer."""
    x = torch.from_numpy(_draw(4 * 256, 5.0, seed=9)
                         * np.exp(3 * _draw(4 * 256, 1.0, seed=10)))
    for spec in ("int8x256", "fp8x256"):
        s = tq.parse(spec)
        ident = lambda b: b          # noqa: E731
        got = tq.allreduce_blocks(x, s, 1, ident, ident)
        # Phase 1 accumulates from zero (so -0 becomes +0), phase 2 not.
        want = tq.dequantize_blocks(*tq.quantize_blocks(x, s, folded=True),
                                    s) + 0.0
        want = tq.dequantize_blocks(*tq.quantize_blocks(want, s, folded=True),
                                    s)
        assert _same(got, want)
        if spec.startswith("fp8"):      # the case the zero decides
            assert (tq.dequantize_blocks(*tq.quantize_blocks(
                x, s, folded=True), s).view(torch.int32)
                    == -2 ** 31).any()


# ------------------------------------------------------------- fp8 cast

FP8_EDGES = [448.0, 460.0, 464.0, 464.5, 465.0, 470.0, 480.0, 500.0,
             np.inf, np.nan, 1e-9, 0.0, 0.001953125, 0.0009765625,
             0.00146484375, 240.0, 447.9]


@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_cast_matches_jax_including_overflow(dtype):
    """``Tensor.to(float8_e4m3fn)`` saturates past ±448; JAX gives NaN
    for whatever rounds past 448 (|x| > 464) and for ±inf."""
    edges = np.array(FP8_EDGES + [-v for v in FP8_EDGES], np.float32)
    rng = np.random.default_rng(8)
    x = np.concatenate([edges, rng.standard_normal(500) * 3,
                        rng.standard_normal(500) * 300]).astype(np.float32)
    if dtype == "float16":
        x = np.where(np.isfinite(x) & (np.abs(x) > 6e4), 6e4, x)
    x = x.astype(_np_dtype(dtype))
    want_wire, want_ctx = jcomp.Compression.fp8.compress(jnp.asarray(x))
    got_wire, got_ctx = tcomp.Compression.fp8.compress(_torch(x))
    assert got_wire.dtype == torch.float8_e4m3fn
    assert _same(got_wire.view(torch.uint8), np.asarray(want_wire).view(
        np.uint8))
    assert np.isnan(np.asarray(want_wire, np.float32)[np.abs(
        x.astype(np.float32)) > 464]).all()
    back = tcomp.Compression.fp8.decompress(got_wire, got_ctx)
    want_back = jcomp.Compression.fp8.decompress(want_wire, want_ctx)
    assert back.dtype == got_ctx and _same(back, np.asarray(want_back))


def test_fp8_cast_leaves_integers_alone():
    t = torch.arange(5, dtype=torch.int32)
    wire, ctx = tcomp.Compression.fp8.compress(t)
    assert wire is t and tcomp.Compression.fp8.decompress(wire, ctx) is t


# ----------------------------------------------------------- compressors

@pytest.mark.parametrize("name", ["int8_blockwise", "fp8_blockwise"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blockwise_compressors_match_jax(name, dtype):
    jc = getattr(jcomp.Compression, name)
    tc = getattr(tcomp.Compression, name)
    assert tc.wire_spec == jc.wire_spec
    x = _draw(600, 7.0, seed=6, dtype=dtype)
    t = _torch(x)
    wire, ctx = tc.compress(t)
    assert wire is t and ctx == t.dtype      # the engine quantizes
    assert tc.decompress(wire.float(), ctx).dtype == t.dtype
    assert _same(tc.local_roundtrip(t), np.asarray(
        jc.local_roundtrip(jnp.asarray(x))))
