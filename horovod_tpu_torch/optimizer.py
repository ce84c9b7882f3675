"""DistributedOptimizer and the parameter/state broadcasts.

Counterpart of ``horovod_tpu/optimizer.py`` and of the torch-facing
design in ``horovod_tpu/torch/__init__.py``: ``DistributedOptimizer``
wraps a ``torch.optim.Optimizer`` in a dynamic subclass whose ``step()``
first averages every gradient over the ranks: one allreduce request
per gradient, named ``allreduce.<parameter name>`` as Horovod names
them, all submitted at once (``fused_allreduce_async``: one lock and one
CUDA fence for the list) before any is awaited, so the engine's planner
fuses them (per dtype, up to ``HOROVOD_FUSION_THRESHOLD`` bytes a
group). The averages are copied back into ``p.grad`` before the inner
``step()``. The broadcasts go through the engine too: only its thread
issues collectives.
"""

from __future__ import annotations

import contextlib
import io
import pickle
from typing import Dict, Iterable, Optional

import torch

from . import topology as _topo
from .compression import Compression
from .ops import collective as _coll


def allreduce_gradients(grads, *, average: bool = True,
                        compression=Compression.none, name: str = "grad"):
    """Average (or sum) a list or dict of gradient tensors over all ranks
    through fused buffers; returns the same structure."""
    keys = list(grads.keys()) if isinstance(grads, dict) else None
    vals = list(grads.values()) if keys is not None else list(grads)
    wire, ctxs = zip(*(compression.compress(g) for g in vals)) if vals \
        else ((), ())
    out = _coll.fused_allreduce_async(list(wire), average, name).wait()
    out = [compression.decompress(o, c) for o, c in zip(out, ctxs)]
    return dict(zip(keys, out)) if keys is not None else out


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin installed on a dynamic subclass of the wrapped optimizer."""

    def __init__(self, params, named_parameters, compression):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._synchronized = False
        self._should_synchronize = True
        named_parameters = list(named_parameters or [])
        all_ids = {id(v) for group in self.param_groups
                   for v in group["params"]}
        named_ids = {id(v) for _, v in named_parameters}
        if len(named_ids) != len(named_parameters):
            raise ValueError("named_parameters contains duplicate parameters")
        if not named_ids.issubset(all_ids):
            raise ValueError("named_parameters was not a subset of "
                             "optimizer.param_groups parameters")
        # Unnamed parameters are "allreduce.noname.<group>.<index>".
        self._names = {id(v): f"allreduce.{k}" for k, v in named_parameters}

    def synchronize(self) -> None:
        """Average every gradient over the ranks, in place."""
        params, wire, ctxs, names = [], [], [], []
        for i, group in enumerate(self.param_groups):
            for j, p in enumerate(group["params"]):
                if p.grad is None:
                    continue
                w, c = self._compression.compress(p.grad)
                params.append(p)
                wire.append(w)
                ctxs.append(c)
                names.append(self._names.get(id(p),
                                             f"allreduce.noname.{i}.{j}"))
        outs = _coll.fused_allreduce_async(wire, True, names=names).wait()
        with torch.no_grad():
            for p, o, c in zip(params, outs, ctxs):
                p.grad.copy_(self._compression.decompress(o, c))
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Run ``step()`` without synchronizing, after a manual
        ``synchronize()`` (e.g. to clip the averaged gradients)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize and not self._synchronized:
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, set_to_none: bool = True):
        self._synchronized = False
        return super(self.__class__, self).zero_grad(set_to_none=set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[Iterable] = None,
                         compression=Compression.none):
    """Wrap ``optimizer`` so that ``step()`` averages gradients over all
    ranks first. The wrapper is an instance of a subclass of the inner
    optimizer's class, sharing its param groups and hyperparameters."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Copy ``root_rank``'s parameters to every rank, in place. ``params``
    is a ``state_dict()``, a ``named_parameters()`` iterable or a list of
    tensors."""
    if isinstance(params, dict):
        named = list(params.items())
    else:
        named = [p if isinstance(p, tuple) else (None, p) for p in params]
    handles = [(t, _coll.broadcast_async(
        t, root_rank, None if k is None else f"broadcast.{k}"))
        for k, t in named]
    with torch.no_grad():
        for t, h in handles:
            t.copy_(h.wait())


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Broadcast a picklable object from ``root_rank``: its byte length,
    then its bytes, as uint8 tensors on this process's device."""
    dev = _topo.device()
    if _topo.rank() == root_rank:
        buf = io.BytesIO()
        pickle.dump(obj, buf)
        payload = torch.frombuffer(bytearray(buf.getvalue()),
                                   dtype=torch.uint8).to(dev)
        length = torch.tensor([payload.numel()], dtype=torch.int64,
                              device=dev)
    else:
        length = torch.zeros(1, dtype=torch.int64, device=dev)
    length = _coll.broadcast(length, root_rank,
                             name=f"{name or 'object'}.len")
    if _topo.rank() != root_rank:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=dev)
    payload = _coll.broadcast(payload, root_rank,
                              name=f"{name or 'object'}.data")
    if _topo.rank() == root_rank:
        return obj
    return pickle.loads(payload.cpu().numpy().tobytes())


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Make every rank's optimizer state equal ``root_rank``'s.

    The state's structure, hyperparameters and small host tensors travel
    as one pickled object; tensors on the device travel as in-place
    broadcasts into tensors shaped after the root's, so a rank whose
    optimizer has not stepped yet still receives the root's state."""
    dev = _topo.device()
    sd = optimizer.state_dict()
    device_tensors = []

    def strip(x):
        if torch.is_tensor(x) and x.device == dev and x.dim() > 0:
            device_tensors.append(x)
            return ("__device_tensor__", len(device_tensors) - 1,
                    tuple(x.shape), x.dtype)
        return x

    meta = {"param_groups": sd["param_groups"],
            "state": {pid: {k: strip(v) for k, v in st.items()}
                      for pid, st in sd["state"].items()}}
    meta = broadcast_object(meta, root_rank, name="optimizer_state")
    is_root = _topo.rank() == root_rank
    new_state: Dict = {}
    handles = []
    for pid, st in meta["state"].items():
        new_state[pid] = {}
        for k, v in st.items():
            if isinstance(v, tuple) and len(v) == 4 \
                    and v[0] == "__device_tensor__":
                t = (device_tensors[v[1]] if is_root
                     else torch.empty(v[2], dtype=v[3], device=dev))
                handles.append((pid, k, _coll.broadcast_async(
                    t, root_rank, f"optimizer_state.{pid}.{k}")))
                v = t
            new_state[pid][k] = v
    for pid, k, h in handles:
        new_state[pid][k] = h.wait()
    if not is_root:
        optimizer.load_state_dict({"state": new_state,
                                   "param_groups": meta["param_groups"]})
