"""Skip-gram word2vec with an NCE loss.

Counterpart of ``horovod_tpu/models/word2vec.py``: parameters as a named
tuple of tensors, an NCE loss with negatives sampled uniformly per call,
deterministic skip-gram batches from a token stream, and nearest
neighbours by cosine similarity.

Negatives are drawn from an explicit ``torch.Generator`` (on the
parameters' device); the loss itself is :func:`_nce_loss` of the drawn
ids, so a test can hand it the ids ``jax.random.randint`` draws. The
logistic terms are ``torch.logaddexp(0, x)``, as JAX's ``jnp.logaddexp``
(``F.softplus`` switches to ``x`` above 20 and differs in the last
bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..topology import resolve_device


class Word2VecParams(NamedTuple):
    embeddings: torch.Tensor   # [vocab, dim] input embeddings
    nce_weights: torch.Tensor  # [vocab, dim] output (context) embeddings
    nce_biases: torch.Tensor   # [vocab]


def init_params(vocab_size: int, embedding_dim: int,
                generator: Optional[torch.Generator] = None, *,
                device: Union[str, torch.device, None] = None
                ) -> Word2VecParams:
    """Uniform(-1, 1) embeddings, normal NCE weights truncated at +-2 and
    scaled by 1/sqrt(dim), zero biases (the reference's initialisation).
    Drawn on the CPU from ``generator``, then moved to ``device`` (CUDA
    unless ``device="cpu"``), each a leaf that requires grad."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    emb = torch.empty(vocab_size, embedding_dim).uniform_(-1.0, 1.0,
                                                          generator=gen)
    nce_w = torch.empty(vocab_size, embedding_dim)
    torch.nn.init.trunc_normal_(nce_w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    nce_w *= 1.0 / embedding_dim ** 0.5
    return Word2VecParams(*(t.to(dev).requires_grad_() for t in
                            (emb, nce_w, torch.zeros(vocab_size))))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(torch.zeros_like(x), x)


def _nce_loss(params: Word2VecParams, centers: torch.Tensor,
              contexts: torch.Tensor, neg_ids: torch.Tensor) -> torch.Tensor:
    """The NCE loss of a skip-gram batch against the negatives
    ``neg_ids`` ([N] token ids)."""
    emb = params.embeddings[centers]                       # [B, D]
    true_w = params.nce_weights[contexts]                  # [B, D]
    true_b = params.nce_biases[contexts]                   # [B]
    true_logits = (emb * true_w).sum(-1) + true_b          # [B]
    neg_w = params.nce_weights[neg_ids]                    # [N, D]
    neg_b = params.nce_biases[neg_ids]                     # [N]
    neg_logits = emb @ neg_w.T + neg_b[None, :]            # [B, N]
    # Binary logistic: true pairs -> 1, sampled pairs -> 0.
    pos = _softplus(-true_logits)                          # -log sigmoid
    neg = _softplus(neg_logits).sum(-1)
    return (pos + neg).mean()


def nce_loss(params: Word2VecParams, centers: torch.Tensor,
             contexts: torch.Tensor, generator: torch.Generator,
             num_negatives: int = 64, vocab_size: Optional[int] = None
             ) -> torch.Tensor:
    """Noise-contrastive estimation loss for a skip-gram batch
    (``centers``/``contexts``: [B] token ids); ``num_negatives`` ids drawn
    uniformly from ``generator``."""
    vocab = vocab_size or params.embeddings.shape[0]
    neg_ids = torch.randint(0, vocab, (num_negatives,), generator=generator,
                            device=params.embeddings.device)
    return _nce_loss(params, centers, contexts, neg_ids)


def skipgram_batch(data: torch.Tensor, step: int, batch_size: int,
                   skip_window: int = 1):
    """Deterministic skip-gram pairs from a token stream: each center is
    paired with one neighbour, alternating left and right."""
    n = data.shape[0]
    ar = torch.arange(batch_size, device=data.device)
    idx = (step * batch_size + ar) % (n - 2 * skip_window) + skip_window
    offset = torch.where(ar % 2 == 0, -skip_window, skip_window)
    return data[idx], data[idx + offset]


def nearest(params: Word2VecParams, word_ids: torch.Tensor, k: int = 8
            ) -> torch.Tensor:
    """Top-k nearest token ids by cosine similarity, the word itself
    dropped (the reference's eval loop)."""
    emb = params.embeddings.detach()
    norm = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    sims = norm[word_ids] @ norm.T                         # [Q, vocab]
    return torch.topk(sims, k + 1).indices[:, 1:]
