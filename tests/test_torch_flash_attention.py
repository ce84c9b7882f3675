"""The port's flash attention (plain PyTorch path on the CPU) against the
JAX package's Pallas kernels run in interpret mode: forward, lse and the
dQ/dK/dV gradients, on inputs drawn once with numpy and fed to both.

Tolerances: fp32 2e-5 on the forward and lse, 1e-4 on the gradients
(the two sides sum in different orders: blockwise online softmax in
JAX, one full-row softmax in the plain version); bf16 3e-2 (one bf16
rounding of O, P or dS at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa


def _arrays(shape, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _jax(xs, dtype):
    return [jnp.asarray(x, dtype) for x in xs]


def _torch(xs, dtype, grad=False):
    return [torch.tensor(x, dtype=dtype, requires_grad=grad) for x in xs]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


FWD_CASES = {
    # name: (shape, causal, block_q, block_k, same_qkv)
    "matches_full_causal": ((2, 64, 4, 16), True, 32, 32, False),
    "matches_full_noncausal": ((2, 64, 4, 16), False, 32, 32, False),
    "single_block": ((1, 16, 2, 8), True, 128, 128, True),
    "uneven_blocks": ((1, 48, 2, 8), True, 32, 32, True),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_jax(case):
    shape, causal, bq, bk, same = FWD_CASES[case]
    xs = _arrays(shape, 1 if same else 3)
    if same:
        xs = xs * 3
    jq, jk, jv = _jax(xs, jnp.float32)
    want = jfa.flash_attention(jq, jk, jv, causal, None, bq, bk, True)
    tq, tk, tv = _torch(xs, torch.float32)
    got = tfa.flash_attention(tq, tk, tv, causal)
    assert got.shape == tq.shape
    assert _err(got.numpy(), want) < 2e-5


def test_forward_bf16_matches_jax():
    xs = _arrays((1, 64, 4, 16), 1) * 3
    jq, jk, jv = _jax(xs, jnp.bfloat16)
    want = jfa.flash_attention(jq, jk, jv, True, None, 32, 32, True)
    tq, tk, tv = _torch(xs, torch.bfloat16)
    got = tfa.flash_attention(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    assert _err(got.float().numpy(), want.astype(jnp.float32)) < 3e-2


@pytest.mark.parametrize("causal,seq,block", [(True, 64, 32), (False, 64, 32),
                                              (True, 40, 16)])
def test_lse_matches_jax(causal, seq, block):
    xs = _arrays((3, seq, 16), 3, seed=4)
    scale = 16 ** -0.5
    _, want = jfa._flash_fwd(*_jax(xs, jnp.float32), scale, causal, block,
                             block, True)
    _, got = tfa.flash_fwd_reference(*_torch(xs, torch.float32), scale,
                                     causal)
    assert tuple(got.shape) == (3, seq, 1)
    assert _err(got.numpy(), want) < 2e-5


BWD_CASES = {
    # name: (shape, causal, block_q, block_k, same_qkv)
    "grads_match_full": ((1, 64, 2, 16), True, 32, 32, False),
    "noncausal_grads": ((1, 32, 2, 8), False, 16, 16, True),
    "tail_block_grads_causal": ((1, 40, 2, 8), True, 16, 16, False),
    "tail_block_grads_noncausal": ((1, 40, 2, 8), False, 16, 16, False),
    "unequal_block_grads": ((1, 64, 2, 8), True, 16, 32, True),
}


def _grads(xs, causal, bq, bk, jdtype, tdtype, same):
    def lf(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, bq, bk, True)
        return (o.astype(jnp.float32) ** 2).sum()

    if same:
        jx = _jax(xs[:1], jdtype)[0]
        want = [jax.grad(lambda q: lf(q, q, q))(jx)]
        tx = _torch(xs[:1], tdtype, grad=True)[0]
        o = tfa.flash_attention(tx, tx, tx, causal)
        got = torch.autograd.grad((o.float() ** 2).sum(), (tx,))
    else:
        want = jax.grad(lf, argnums=(0, 1, 2))(*_jax(xs, jdtype))
        ts = _torch(xs, tdtype, grad=True)
        o = tfa.flash_attention(*ts, causal)
        got = torch.autograd.grad((o.float() ** 2).sum(), ts)
    return got, want


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_grads_match_jax(case):
    shape, causal, bq, bk, same = BWD_CASES[case]
    xs = _arrays(shape, 3, seed=1)
    got, want = _grads(xs, causal, bq, bk, jnp.float32, torch.float32, same)
    for g, w in zip(got, want):
        assert _err(g.numpy(), w) < 1e-4


def test_bf16_grads_match_jax():
    xs = _arrays((1, 64, 2, 16), 3, seed=2)
    got, want = _grads(xs, True, 32, 32, jnp.bfloat16, torch.bfloat16, False)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _err(g.float().numpy(), w.astype(jnp.float32)) < 3e-2


# The card tests' tile-edge shapes (a 128-row q tile with its diagonal
# across two 64-key tiles, one row past a tile, the second 64-row
# warpgroup of a q tile partly or wholly past the sequence, ragged tails
# causal and not, the head dims stored at their width and those stored
# zero-padded to the next 64 columns), with the heads cut to a few. The JAX
# side runs at the CUDA kernels' tiling: 128 q rows by 64 keys.
EDGE_CASES = {
    # name: ([batch, seq, heads, head_dim], causal)
    "diagonal_across_two_key_tiles": ((1, 384, 2, 128), True),
    "one_row_past_a_tile": ((1, 129, 1, 128), True),
    "ragged_causal": ((1, 1000, 2, 128), True),
    "ragged_noncausal_d64": ((1, 130, 2, 64), False),
    "ragged_causal_d64": ((1, 200, 3, 64), True),
    "second_warpgroup_past_seq": ((1, 100, 2, 128), True),
    "one_and_a_half_tiles_noncausal": ((1, 192, 2, 128), False),
    "ragged_causal_d96": ((1, 200, 2, 96), True),
    "ragged_noncausal_d80": ((1, 130, 2, 80), False),
    "ragged_causal_d32": ((1, 130, 2, 32), True),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_tile_edges_forward_and_lse_match_jax(case):
    shape, causal = EDGE_CASES[case]
    xs = _arrays(shape, 3, seed=shape[1] + shape[3])
    want = jfa.flash_attention(*_jax(xs, jnp.float32), causal, None, 128,
                               64, True)
    got = tfa.flash_attention(*_torch(xs, torch.float32), causal)
    assert _err(got.numpy(), want) < 2e-5
    b, s, h, d = shape
    flat = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * h, s, d)
            for x in xs]
    _, want_lse = jfa._flash_fwd(*_jax(flat, jnp.float32), d ** -0.5, causal,
                                 128, 64, True)
    _, got_lse = tfa.flash_fwd_reference(*_torch(flat, torch.float32),
                                         d ** -0.5, causal)
    assert _err(got_lse.numpy(), want_lse) < 2e-5


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_tile_edges_grads_match_jax(case):
    shape, causal = EDGE_CASES[case]
    xs = _arrays(shape, 3, seed=shape[1] + shape[3] + 1)
    got, want = _grads(xs, causal, 128, 64, jnp.float32, torch.float32,
                       False)
    for g, w in zip(got, want):
        assert _err(g.numpy(), w) < 1e-4


def test_kernel_wrappers_reject_cpu_tensors():
    # The CUDA wrappers never compute on the CPU: only the device-based
    # dispatch in flash_attention picks the plain version there.
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_fwd_cuda(q, q, q, 0.125, True)
    with pytest.raises(ValueError):
        tfa.flash_fwd_cuda(q, q, q, 0.125, True, out_dtype=torch.float32)
    counts = tfa.launch_counts()
    assert {"flash_fwd", "flash_dkv", "flash_dq", "flash_fwd_f32",
            "flash_dkv_f32", "flash_dq_f32"} <= set(counts)
    assert sum(counts.values()) == 0
