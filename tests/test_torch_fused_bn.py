"""The port's fused batch-norm op against the JAX package's ``bn_act``.

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode where the shape folds to 128 lanes and its jnp path
where it does not, as ``tests/test_fused_bn.py`` does; the port runs
``impl="pallas"``, which on CPU tensors is the kernels' plain versions.

Tolerances (max |port - jax| over max |jax|): fp32 1e-5 (the sums run
in another order); bf16 1e-2 (y, dx and dr are stored in bf16, one
rounding apart at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_bn as jbn
from horovod_tpu_torch.ops import fused_bn as tbn

EPS = 1e-5
# The shapes of tests/test_fused_bn.py: plain, folded (C < 128), an M
# with a small power-of-two factor, no fold, and a C whose block cap is
# not a power of two.
SHAPES = [(4, 8, 8, 256), (4, 8, 8, 64), (8, 7, 7, 128), (2, 5, 3, 96),
          (512, 1, 1, 384)]
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(shape, seed, residual):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if residual else None
    return x, g, gamma, beta, r


def _jax(shape, x, g, gamma, beta, r, relu, jdt):
    c = shape[-1]
    impl = ("interpret" if jbn._can_pallas(x.size // c, c) else "jnp")
    args = [jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta)]
    if r is not None:
        args.append(jnp.asarray(r, jdt))

    def f(x, gamma, beta, *rest):
        return jbn.bn_act(x, gamma, beta, residual=rest[0] if rest else None,
                          eps=EPS, relu=relu, impl=impl)

    (y, mean, var), vjp = jax.vjp(f, *args)
    cot = (jnp.asarray(g, jdt), jnp.zeros_like(mean), jnp.zeros_like(var))
    grads = vjp(cot)
    out = {"y": y, "mean": mean, "var": var, "dx": grads[0],
           "dgamma": grads[1], "dbeta": grads[2]}
    if r is not None:
        out["dr"] = grads[3]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _torch(x, g, gamma, beta, r, relu, tdt, impl="pallas"):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    rt = (torch.from_numpy(r).to(tdt).requires_grad_() if r is not None
          else None)
    y, mean, var = tbn.bn_act(xt, gt, bt, residual=rt, eps=EPS, relu=relu,
                              impl=impl)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    y.backward(torch.from_numpy(g).to(tdt))
    out = {"y": y, "mean": mean, "var": var, "dx": xt.grad,
           "dgamma": gt.grad, "dbeta": bt.grad}
    if r is not None:
        assert rt.grad.dtype == tdt
        out["dr"] = rt.grad
    return {k: v.detach().float().numpy() for k, v in out.items()}


def _assert_close(got, want, tol):
    assert set(got) == set(want)
    for name in want:
        err = np.max(np.abs(got[name] - want[name]))
        scale = max(np.max(np.abs(want[name])), 1e-30)
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bn_act_matches_jax(shape, relu, residual, dtype):
    _, jdt, tdt, tol = DTYPES[dtype]
    x, g, gamma, beta, r = _inputs(shape, seed=sum(shape), residual=residual)
    want = _jax(shape, x, g, gamma, beta, r, relu, jdt)
    got = _torch(x, g, gamma, beta, r, relu, tdt)
    _assert_close(got, want, tol)


@pytest.mark.parametrize("impl", ["auto", "jnp", "interpret"])
def test_every_impl_is_the_same_function(impl):
    x, g, gamma, beta, r = _inputs((4, 8, 8, 64), seed=3, residual=True)
    want = _torch(x, g, gamma, beta, r, True, torch.float32)
    got = _torch(x, g, gamma, beta, r, True, torch.float32, impl=impl)
    _assert_close(got, want, 0.0)


def test_bad_impl_raises():
    x = torch.ones(4, 4, 4, 64)
    with pytest.raises(ValueError, match="unknown bn_act impl"):
        tbn.bn_act(x, torch.ones(64), torch.zeros(64), impl="palas")


def test_inference_matches_jax():
    x, _, gamma, beta, r = _inputs((4, 8, 8, 64), seed=1, residual=True)
    rng = np.random.RandomState(2)
    rm = (rng.randn(64) * 0.1).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    for relu in (True, False):
        want = jbn.bn_act_inference(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
            jnp.asarray(beta), jnp.asarray(rm), jnp.asarray(rv),
            residual=jnp.asarray(r, jnp.bfloat16), eps=EPS, relu=relu)
        got = tbn.bn_act_inference(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(gamma),
            torch.from_numpy(beta), torch.from_numpy(rm),
            torch.from_numpy(rv), residual=torch.from_numpy(r).bfloat16(),
            eps=EPS, relu=relu)
        assert got.dtype == torch.bfloat16
        _assert_close({"y": got.float().numpy()},
                      {"y": np.asarray(want, np.float32)}, 1e-2)


def test_kernel_path_refuses_non_contiguous_operands():
    x = torch.randn(4, 64, 8, 8).permute(0, 2, 3, 1)   # NHWC view of NCHW
    gamma, beta = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="contiguous over"):
        tbn.bn_act(x, gamma, beta, impl="pallas")
    y, _, _ = tbn.bn_act(x, gamma, beta, impl="jnp")
    assert y.shape == x.shape


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(16, 64, dtype=torch.bfloat16)
    v = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.stats_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.norm_cuda(x, None, v, v, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bwd_reduce_cuda(x, x, None, v, v, v, v, True)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bwd_dx_cuda(x, x, None, v, v, v, v, v, v, 1 / 16, True)
    assert tbn.launch_counts() == {"bn_stats": 0, "bn_norm": 0,
                                   "bn_bwd_reduce": 0, "bn_bwd_dx": 0}


@pytest.mark.parametrize("m,c", [(3211264, 64), (802816, 256),
                                 (12544, 2048), (30, 96), (1, 5)])
def test_row_chunks_fill_the_card_and_stay_fixed(m, c):
    sms = 132
    for vec in (8, 1):
        g = tbn.row_chunks(m, c, vec, sms)
        tiles = -(-c // (8 * vec))
        assert 1 <= g <= 65535 and g <= -(-m // 32)
        assert g * tiles >= 8 * sms or g == -(-m // 32)
        assert g == tbn.row_chunks(m, c, vec, sms)


def test_vector_width():
    x = torch.zeros(8, 96, dtype=torch.bfloat16)
    assert tbn._vec_width(96, x) == 8
    assert tbn._vec_width(12, torch.zeros(8, 12, dtype=torch.bfloat16)) == 1
    assert tbn._vec_width(96, x.view(-1)[4:].view(-1, 4)) == 1
