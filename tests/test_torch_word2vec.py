"""The port's word2vec (``horovod_tpu_torch/models/word2vec.py``) against
the JAX package's ``horovod_tpu/models/word2vec.py``.

- ``nce_loss`` and its gradients on the same negatives: the ids
  ``jax.random.randint(rng, (N,), 0, vocab)`` draws inside JAX's loss go
  to the port's ``_nce_loss``; parameters carried by
  ``interop.word2vec_params_from_jax``. fp32, within 1e-6 relative on
  the loss and 1e-5 of max |JAX| on each gradient (the same sums in
  another order; ``logaddexp`` on both sides).
- ``skipgram_batch`` exact at several steps, windows and stream lengths.
- ``nearest`` equal to JAX's on untied data (no two similarities equal,
  so both top-k orders are defined).
- ``init_params``: JAX's shapes and distributions (uniform in (-1, 1),
  truncated normal within +-2/sqrt(dim), zero biases); ``nce_loss``
  draws its negatives from the generator it is given.
- ``DistributedOptimizer`` over Adagrad (the example's optimizer, with
  optax's accumulator start) steps bit for bit as the plain optimizer
  at world size 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import word2vec as jw2v
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import word2vec as tw2v


def _params(vocab=50, dim=16, seed=0):
    return jax.device_get(jw2v.init_params(vocab, dim,
                                           jax.random.PRNGKey(seed)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("batch,negatives,seed", [(8, 4, 0), (32, 16, 1),
                                                  (256, 64, 2)])
def test_nce_loss_and_gradients_match_jax(batch, negatives, seed):
    vocab, dim = 50, 16
    params = _params(vocab, dim, seed)
    rs = np.random.RandomState(seed)
    centers = rs.randint(0, vocab, batch).astype(np.int32)
    contexts = rs.randint(0, vocab, batch).astype(np.int32)
    rng = jax.random.PRNGKey(100 + seed)
    want, grads = jax.value_and_grad(jw2v.nce_loss)(
        params, jnp.asarray(centers), jnp.asarray(contexts), rng,
        negatives)
    neg_ids = np.asarray(jax.random.randint(rng, (negatives,), 0, vocab))
    tp = interop.word2vec_params_from_jax(params)
    loss = tw2v._nce_loss(tp, torch.tensor(centers).long(),
                          torch.tensor(contexts).long(),
                          torch.tensor(neg_ids).long())
    loss.backward()
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    for t, g in zip(tp, grads):
        assert _rel(t.grad, g) <= 1e-5


def test_softplus_is_logaddexp_far_out():
    x = torch.tensor([-30.0, -5.0, 0.0, 5.0, 20.0, 25.0, 40.0])
    want = np.asarray(jnp.logaddexp(0.0, jnp.asarray(x.numpy())))
    assert np.array_equal(tw2v._softplus(x).numpy(), want)


@pytest.mark.parametrize("n,step,batch,window", [
    (100, 0, 8, 1), (100, 7, 8, 1), (37, 5, 16, 2), (1000, 123, 256, 1),
    (20, 9, 32, 3)])
def test_skipgram_batch_is_exact(n, step, batch, window):
    data = np.random.RandomState(n).randint(0, 500, n).astype(np.int32)
    jc, jx = jw2v.skipgram_batch(jnp.asarray(data), step, batch, window)
    tc, tx = tw2v.skipgram_batch(torch.tensor(data), step, batch, window)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_nearest_matches_jax_on_untied_data(k):
    params = _params(200, 32, seed=3)
    ids = np.array([0, 5, 17, 199], np.int32)
    tp = interop.word2vec_params_from_jax(params)
    emb = tp.embeddings.detach()
    norm = emb / emb.norm(dim=-1, keepdim=True)
    sims = (norm[torch.tensor(ids).long()] @ norm.T).numpy()
    top = np.sort(sims, -1)[:, ::-1][:, :k + 2]
    assert (np.diff(top, axis=-1) < 0).all()   # untied where it matters
    want = np.asarray(jw2v.nearest(params, jnp.asarray(ids), k))
    got = tw2v.nearest(tp, torch.tensor(ids).long(), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_shapes_and_distributions():
    p = tw2v.init_params(1000, 64, torch.Generator().manual_seed(0),
                         device="cpu")
    j = _params(1000, 64)
    for t, a in zip(p, j):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        assert t.requires_grad and t.is_leaf
    emb, w, b = (t.detach() for t in p)
    assert -1.0 <= float(emb.min()) and float(emb.max()) < 1.0
    assert abs(float(emb.mean())) < 0.01 and abs(float(emb.std()) -
                                                 np.std(j[0])) < 0.01
    assert float(w.abs().max()) <= 2.0 / 8.0
    assert abs(float(w.std()) - np.std(j[1])) < 0.005
    assert float(b.abs().max()) == 0.0


def test_nce_loss_draws_from_its_generator():
    p = tw2v.init_params(100, 8, device="cpu")
    c = torch.arange(16)
    x = torch.arange(1, 17)
    a = tw2v.nce_loss(p, c, x, torch.Generator().manual_seed(5), 8)
    b = tw2v.nce_loss(p, c, x, torch.Generator().manual_seed(5), 8)
    d = tw2v.nce_loss(p, c, x, torch.Generator().manual_seed(6), 8)
    assert torch.equal(a, b) and not torch.equal(a, d)


def test_params_round_trip():
    params = _params()
    back = interop.word2vec_params_to_jax(
        interop.word2vec_params_from_jax(params))
    for a, b in zip(back, params):
        np.testing.assert_array_equal(a, np.asarray(b))
    jw2v.Word2VecParams(*back)   # JAX's named tuple takes them as they are


def test_distributed_adagrad_keeps_its_initial_accumulator():
    """word2vec trains on Adagrad(1.0) with optax's accumulator start of
    0.1, as JAX's example; through ``DistributedOptimizer`` at world 1 the
    steps are the plain optimizer's bit for bit (the wrapper once rebuilt
    the accumulators at the constructor's default of 0, and the loss
    rose)."""
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(7).zipf(1.3, 4000)
                              .clip(0, 499).astype(np.int64))
    runs = []
    for wrap in (False, True):
        params = tw2v.init_params(500, 16, torch.Generator().manual_seed(0),
                                  device="cpu")
        opt = torch.optim.Adagrad(params, lr=1.0,
                                  initial_accumulator_value=0.1, eps=1e-7)
        if wrap:
            opt = thvd.DistributedOptimizer(opt, named_parameters=list(
                zip(tw2v.Word2VecParams._fields, params)))
        losses = []
        for i in range(4):
            c, x = tw2v.skipgram_batch(tokens, i, 64)
            opt.zero_grad()
            loss = tw2v.nce_loss(params, c, x,
                                 torch.Generator().manual_seed(i), 8)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        runs.append((losses, [p.detach().clone() for p in params]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
