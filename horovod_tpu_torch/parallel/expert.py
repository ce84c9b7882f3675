"""Expert parallelism: top-1 mixture-of-experts over the 'ep' axis.

Counterpart of ``horovod_tpu/parallel/expert.py`` (the Switch/GShard
pattern with static shapes):

  1. a router scores this rank's tokens against every expert;
  2. each token goes to its top-1 expert, at the next free slot of that
     expert's bucket of fixed capacity C; tokens past C are dropped;
  3. an ``all_to_all`` over 'ep' exchanges the buckets, so each rank
     holds the tokens every rank routed to ITS experts;
  4. the local experts' MLPs run as batched products;
  5. a second ``all_to_all`` returns the outputs, which go back to their
     tokens times the gate.

The routing is JAX's arithmetic: softmax in fp32, the first index of
the largest probability, a token's slot the running count of its
expert's earlier tokens, ``capacity = max(1, int(capacity_factor * t /
num_experts))``. JAX moves the tokens with dense one-hot
``[tokens, experts, capacity]`` einsums; here they move by index (a
gather into the buckets and one back), since each slot holds at most
one token: the same values, without the dense tensors (at 16384
tokens, 8 experts and capacity 4096, 2.1 GB of fp32 each).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from .collectives import all_to_all, axis_size


class Dispatch(NamedTuple):
    """Top-1 routing of ``t`` tokens, by index: each token's ``expert``,
    its ``slot`` in that expert's bucket (the running count), its
    ``gate`` (the expert's fp32 probability, differentiable) and whether
    it is kept (``slot < capacity``)."""
    expert: torch.Tensor    # [t] int64
    slot: torch.Tensor      # [t] int64
    gate: torch.Tensor      # [t] fp32
    keep: torch.Tensor      # [t] bool


def top1_dispatch(router_logits: torch.Tensor, capacity: int) -> Dispatch:
    """Top-1 routing with a fixed capacity per expert; ``router_logits``
    is ``[tokens, num_experts]``."""
    n_experts = router_logits.shape[1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)      # the first index on ties
    gate = probs.gather(1, expert[:, None])[:, 0]
    # Each expert's running count, scanned as E rows of t tokens: a scan
    # down the t rows of [t, E] gives the card only E columns to run.
    counts = F.one_hot(expert, n_experts).t().contiguous().cumsum(1)
    slot = counts.gather(0, expert[None])[0] - 1
    return Dispatch(expert, slot, gate, slot < capacity)


def dense_dispatch(d: Dispatch, num_experts: int, capacity: int):
    """JAX's ``(dispatch, combine)``, ``[tokens, experts, capacity]``
    fp32, rebuilt from the index form (for checks)."""
    t = d.expert.shape[0]
    dispatch = torch.zeros(t, num_experts, capacity)
    rows = torch.nonzero(d.keep)[:, 0]
    dispatch[rows, d.expert[rows], d.slot[rows]] = 1.0
    return dispatch, dispatch * d.gate[:, None, None]


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              num_experts: int, capacity_factor: float,
              mesh: Optional[DeviceMesh], axis: Optional[str],
              act: Callable[[torch.Tensor], torch.Tensor],
              dtype: torch.dtype = torch.bfloat16,
              drops: Optional[list] = None) -> torch.Tensor:
    """Top-1 MoE of this rank's tokens ``x`` ``[t, F]``, as JAX's
    ``moe_apply`` inside ``shard_map`` over ``axis``. ``params``: the
    replicated ``router`` ``[F, E]`` and this rank's experts ``wi``
    ``[E_local, F, H]`` and ``wo`` ``[E_local, H, F]``. The experts'
    products run in ``dtype``, the routing and the buckets in fp32; the
    result is in ``x``'s dtype. ``drops``, a list, receives the number of
    tokens dropped (a 0-d tensor on ``x``'s device)."""
    n_shards = axis_size(mesh, axis)
    if num_experts % n_shards:
        raise ValueError(f"num_experts ({num_experts}) must be divisible "
                         f"by the expert-parallel axis size ({n_shards})")
    e_local = num_experts // n_shards
    t, f = x.shape
    capacity = max(1, int(capacity_factor * t / num_experts))
    x32 = x.float()
    d = top1_dispatch(x32 @ params["router"], capacity)
    if drops is not None:
        drops.append((~d.keep).sum())
    # Slot of each kept token in the [E * C] buckets; a dropped token
    # points past them, at a row that is cut off.
    n_slots = num_experts * capacity
    dest = torch.where(d.keep, d.expert * capacity + d.slot, n_slots)
    token = torch.arange(t, device=x.device)
    # The token filling each slot; an empty slot reads the zero row t.
    src = torch.full((n_slots + 1,), t, dtype=torch.int64,
                     device=x.device).scatter_(0, dest, token)[:n_slots]
    buckets = F.pad(x32, (0, 0, 0, 1)).index_select(0, src)

    # Rank r receives the buckets of ITS experts from every rank:
    # [E, C, F] -> [n, E_l * C, F]; the all_to_all scatters dim 0 and
    # concatenates the arrivals on dim 1, so dim 0 then indexes the
    # source rank.
    buckets = buckets.reshape(n_shards, e_local * capacity, f)
    buckets = all_to_all(buckets, mesh, axis, split_axis=0, concat_axis=1)
    buckets = buckets.reshape(n_shards, e_local, capacity, f)
    buckets = buckets.transpose(0, 1).reshape(e_local, n_shards * capacity,
                                              f)
    h = act(torch.bmm(buckets.to(dtype), params["wi"].to(dtype)))
    y = torch.bmm(h, params["wo"].to(dtype)).float()
    # The return trip inverts the exchange.
    y = y.reshape(e_local, n_shards, capacity, f).transpose(0, 1)
    y = y.reshape(n_shards, e_local * capacity, f)
    y = all_to_all(y, mesh, axis, split_axis=0, concat_axis=1)
    y = y.reshape(n_slots, f)
    back = y.index_select(0, torch.where(d.keep, dest, 0))
    out = back * (d.gate * d.keep)[:, None]
    return out.to(x.dtype)


def moe_init(generator: Optional[torch.Generator] = None, *,
             num_experts: int, experts_per_shard: int, features: int,
             hidden: int) -> Dict[str, torch.Tensor]:
    """One MoE's fp32 parameters (the router replicated, the experts
    this rank's), with JAX's ``moe_init`` shapes and scales."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    scale_in = (1.0 / features) ** 0.5
    scale_hid = (1.0 / hidden) ** 0.5
    return {"router": normal(features, num_experts) * scale_in,
            "wi": normal(experts_per_shard, features, hidden) * scale_in,
            "wo": normal(experts_per_shard, hidden, features) * scale_hid}
