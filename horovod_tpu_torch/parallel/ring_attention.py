"""Single-device attention of the sequence-parallel module.

Counterpart of ``full_attention`` in
``horovod_tpu/parallel/ring_attention.py``: the plain attention the
transformer uses below the flash threshold, in the same
``[batch, seq, heads, head_dim]`` layout. Ring and Ulysses attention are
later slices of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with fp32 scores; output in q's dtype."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
