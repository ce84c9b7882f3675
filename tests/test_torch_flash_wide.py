"""The port's flash attention at head dims above 256 (the ``_wide``
kernels' range) against the JAX package's, whose kernels take any head
dim (``horovod_tpu/ops/flash_attention.py``).

On the CPU the kernels' plain versions run (the kernels are held to
them on the card: ``chip_smoke.py`` phase 3c). Inputs are drawn with
numpy and handed to both packages.

- ``_flash_fwd`` / ``_flash_bwd`` at D in {272, 384}, causal and not,
  with ragged sq != sk, against JAX's ``_flash_fwd`` / ``_flash_bwd`` in
  interpret mode; fp32 and bf16. Tolerances (of max |JAX|) as
  ``tests/test_torch_flash_dtypes.py`` and
  ``tests/test_torch_flash_attention.py`` state them: fp32 2e-5 on O
  and lse (lse relative), 1e-4 on dQ, dK and dV; bf16 3e-2 (one bf16
  rounding of O, P or dS at other points), lse 1e-3.
- ``flash_attention`` and its gradients at the same head dims against
  JAX's ``flash_attention(..., interpret=True)``.
- The wrappers' padding to 128-column chunks (D = 272 runs at 384) on
  the plain versions is bit for bit the unpadded result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

DIMS = (272, 384)
SHAPES = ((True, 40, 40), (False, 24, 56), (True, 56, 24))  # causal, sq, sk
TOL = {"float32": (2e-5, 1e-4, 2e-5), "bfloat16": (3e-2, 3e-2, 1e-3)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_plain_fwd_bwd_match_jax(dtype, d, causal, sq, sk):
    tdt, jdt = DTYPES[dtype]
    tol, gtol, ltol = TOL[dtype]
    rs = np.random.RandomState(d + sq + 3 * sk + causal)
    q, do = (rs.standard_normal((2, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rs.standard_normal((2, sk, d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    want_o, want_lse = jfa._flash_fwd(jq, jk, jv, scale, causal, 16, 16,
                                      True)
    delta = np.sum(np.asarray(jdo, np.float32)
                   * np.asarray(want_o, np.float32), -1, keepdims=True)
    want_g = jfa._flash_bwd(jq, jk, jv, jdo, want_lse, jnp.asarray(delta),
                            scale, causal, 16, 16, True)
    tq, tk, tv, tdo = (torch.tensor(x).to(tdt) for x in (q, k, v, do))
    o, lse = tfa._flash_fwd(tq, tk, tv, scale, causal)
    grads = tfa._flash_bwd(tq, tk, tv, tdo,
                           torch.tensor(np.asarray(want_lse)),
                           torch.tensor(delta), scale, causal)
    assert o.dtype == tdt and all(g.dtype == tdt for g in grads)
    assert _rel(o.float(), want_o) <= tol
    lse_err = float(np.abs(lse.numpy() - np.asarray(want_lse)).max())
    if dtype == "float32":
        lse_err /= float(np.abs(np.asarray(want_lse)).max())
    assert lse_err <= ltol
    for got, want in zip(grads, want_g):
        assert _rel(got.float(), want) <= gtol


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", DIMS)
def test_flash_attention_and_gradients_match_jax(d, causal):
    rs = np.random.RandomState(d + causal)
    q, k, v, g = (rs.standard_normal((1, 24, 2, d)).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, None, None, True)
        return (o * g).sum(), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal)
    (to * torch.tensor(g)).sum().backward()
    assert _rel(to.detach(), jo) <= 2e-5
    for t, j in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad, j) <= 1e-4


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wide_padding_is_exact(dtype):
    tdt = DTYPES[dtype][0]
    rs = np.random.RandomState(0)
    q, k, v, do = (torch.tensor(rs.standard_normal((2, 33, 272))
                                .astype(np.float32)).to(tdt)
                   for _ in range(4))
    scale = 272 ** -0.5
    o, lse = tfa.flash_fwd_reference(q, k, v, scale, True)
    po, plse = tfa.fwd_padded(tfa.flash_fwd_reference, q, k, v, scale, True)
    assert torch.equal(po, o) and torch.equal(plse, lse)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = tfa.flash_bwd_reference(q, k, v, do, lse, delta, scale, True)
    got = tfa.bwd_padded(tfa.flash_bwd_reference, q, k, v, do, lse, delta,
                         scale, True)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
