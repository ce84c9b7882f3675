"""The fp32-output forms of the port's flash attention (the plain
versions on the CPU) against the JAX package's ``_flash_fwd`` and
``_flash_bwd`` with ``out_dtype=jnp.float32`` in interpret mode: the
outputs ring attention merges.

bf16 operands drawn once with numpy, on the tile-edge shapes of
``tests/test_torch_flash_attention.py`` (JAX at the CUDA kernels'
tiling, 128 q rows by 64 keys), causal and not. The backward takes the
same lse and delta on both sides (JAX's forward's, and the fp32 output
against a drawn dO). Tolerance: 3e-2 absolute, as that file's bf16
cases (one bf16 rounding of P or dS at other points); the outputs must
be fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

CASES = {
    # name: ([batch*heads, seq, head_dim], causal)
    "diagonal_across_two_key_tiles": ((2, 384, 128), True),
    "one_row_past_a_tile": ((1, 129, 128), True),
    "ragged_causal": ((2, 1000, 128), True),
    "ragged_noncausal_d64": ((2, 130, 64), False),
    "second_warpgroup_past_seq": ((2, 100, 128), True),
    "one_and_a_half_tiles_noncausal": ((2, 192, 128), False),
    "ragged_causal_d96": ((2, 200, 96), True),
    "ragged_noncausal_d96": ((2, 130, 96), False),
    "ring_shard_causal": ((2, 256, 128), True),
    "ring_shard_noncausal": ((2, 256, 128), False),
}
TOL = 3e-2


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_outputs_match_jax(case):
    shape, causal = CASES[case]
    q, k, v, do = _inputs(shape, seed=shape[1] + shape[2])
    scale = shape[2] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    want_o, want_lse = jfa._flash_fwd(jq, jk, jv, scale, causal, 128, 64,
                                      True, out_dtype=jnp.float32)
    assert want_o.dtype == jnp.float32
    lse = np.array(want_lse)
    delta = (np.asarray(jdo.astype(jnp.float32))
             * np.asarray(want_o)).sum(-1, keepdims=True)
    want_grads = jfa._flash_bwd(jq, jk, jv, jdo, jnp.asarray(lse),
                                jnp.asarray(delta), scale, causal, 128, 64,
                                True, out_dtype=jnp.float32)

    tq, tk, tv, tdo = (torch.tensor(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    got_o, got_lse = tfa._flash_fwd(tq, tk, tv, scale, causal,
                                    out_dtype=torch.float32)
    got_grads = tfa._flash_bwd(tq, tk, tv, tdo, torch.from_numpy(lse),
                               torch.from_numpy(delta), scale, causal,
                               out_dtype=torch.float32)
    assert got_o.dtype == torch.float32
    assert _err(got_o.numpy(), want_o) < TOL
    assert _err(got_lse.numpy(), lse) < TOL
    for name, got, want in zip(("dq", "dk", "dv"), got_grads, want_grads):
        assert got.dtype == torch.float32, name
        assert want.dtype == jnp.float32, name
        assert _err(got.numpy(), want) < TOL, name


def test_default_output_dtype_is_the_operands():
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16)
                   for x in _inputs((1, 64, 32), seed=3))
    o, lse = tfa._flash_fwd(q, k, v, 0.125, True)
    grads = tfa._flash_bwd(q, k, v, do, lse, lse, 0.125, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grads)
    # fp32 output: the same values before the last rounding.
    o32, _ = tfa._flash_fwd(q, k, v, 0.125, True, out_dtype=torch.float32)
    assert torch.equal(o32.to(torch.bfloat16), o)
