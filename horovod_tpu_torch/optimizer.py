"""DistributedOptimizer and the parameter/state broadcasts.

Counterpart of the torch shim's ``DistributedOptimizer``
(``horovod_tpu/torch/__init__.py``): it wraps a ``torch.optim.Optimizer``
in a dynamic subclass of its class whose ``step()`` first averages
every gradient over the ranks.

Parameters are cut at construction into gradient buckets of about
``bucket_cap_mb`` MiB (default HOROVOD_TPU_TORCH_BUCKET_MB, the fusion
threshold's 64), taken in reverse registration order so that the
gradients backward finishes first share the first bucket. Each bucket
owns one flat buffer in its wire dtype. A parameter's post-accumulate
hook copies its gradient into the buffer; the bucket's last hook fires
one in-place allreduce of the whole buffer, named
``allreduce.bucket.<optimizer>.<index>``, while backward still runs.
``synchronize()`` fires what the hooks did not (an early ``step()``
mid-accumulation, a parameter without a gradient) in one submission,
waits for every bucket and copies each average back into ``p.grad``.
With ``gradient_as_bucket_view`` each ``p.grad`` is a view of its
bucket's buffer, so the copies in and out disappear. Under a blockwise
compressor each fp32 bucket carries an error-feedback residual: what
the wire dropped last step is added to the buffer before the next
allreduce. ``bucket_cap_mb=0``, or a compressor other than the stock
ones, keeps one hook and one request per gradient (named
``allreduce.<parameter name>``).

The broadcasts go through the engine too: only its thread issues
collectives.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import pickle
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from . import quantization as _quant
from . import topology as _topo
from .compression import Compression
from .ops import collective as _coll
from .utils import env as _env


def allreduce_gradients(grads, *, average: bool = True,
                        compression=Compression.none, name: str = "grad"):
    """Average (or sum) a list or dict of gradient tensors over all ranks
    through fused buffers; returns the same structure."""
    keys = list(grads.keys()) if isinstance(grads, dict) else None
    vals = list(grads.values()) if keys is not None else list(grads)
    wire, ctxs = zip(*(compression.compress(g) for g in vals)) if vals \
        else ((), ())
    out = _coll.fused_allreduce_async(list(wire), average, name,
                                      compression=compression).wait()
    out = [compression.decompress(o, c) for o, c in zip(out, ctxs)]
    return dict(zip(keys, out)) if keys is not None else out


class _GradBucket:
    """One bucket: a flat buffer in the wire dtype over a span of
    parameters, fired as one allreduce a step."""

    __slots__ = ("index", "params", "offsets", "numel", "buffer", "ready",
                 "name")

    def __init__(self, index: int, params: List[torch.Tensor],
                 dtype: torch.dtype, name: str):
        self.index = index
        self.params = params
        self.offsets = {}
        off = 0
        for p in params:
            n = p.numel()
            self.offsets[id(p)] = (off, n)
            off += n
        self.numel = off
        self.buffer = torch.zeros(off, dtype=dtype, device=params[0].device)
        self.ready: set = set()
        self.name = name

    def fill(self, p: torch.Tensor) -> None:
        off, n = self.offsets[id(p)]
        with torch.no_grad():
            # copy_ casts the gradient to the wire dtype: a cast
            # compressor's compress, fused into the pack.
            self.buffer[off:off + n].copy_(p.grad.detach().reshape(-1))

    def scatter(self, p: torch.Tensor) -> None:
        off, n = self.offsets[id(p)]
        with torch.no_grad():
            # ...and back (decompress).
            p.grad.copy_(self.buffer[off:off + n].view(p.grad.shape))

    def view_of(self, p: torch.Tensor) -> torch.Tensor:
        """``p``'s span of the buffer, shaped like ``p``."""
        off, n = self.offsets[id(p)]
        return self.buffer[off:off + n].view(p.shape)


_optimizer_ids = itertools.count(1)

_ALREADY_REDUCED = (
    "Gradient for this parameter was already allreduced this step. If you "
    "call backward() more than once per step, pass backward_passes_per_step="
    "<number of backward passes> to DistributedOptimizer.")


def _bucketable(compression) -> bool:
    """Buckets understand the stock compressors, whose transform is a
    dtype cast or a wire spec that the pack copy or the engine carries.
    Any other compressor (a subclass may compress arbitrarily) keeps the
    per-tensor path, where it runs as it is."""
    return compression in (Compression.none, Compression.fp16,
                           Compression.bf16, Compression.int8_blockwise,
                           Compression.fp8_blockwise)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin installed on a dynamic subclass of the wrapped optimizer."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, bucket_cap_mb=None,
                 gradient_as_bucket_view=None, skip_nonfinite_steps=None):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        # A blockwise compressor passes tensors through; its wire rides
        # the requests, and the engine quantizes.
        self._blockwise = compression if getattr(
            compression, "wire_spec", None) is not None else None
        self.backward_passes_per_step = backward_passes_per_step
        self._synchronized = False
        self._should_synchronize = True
        if skip_nonfinite_steps is None:
            skip_nonfinite_steps = _env.torch_skip_nonfinite()
        self._skip_nonfinite = bool(skip_nonfinite_steps)
        # Nonfinite gradient elements packed this step, on the device.
        self._nonfinite: Optional[torch.Tensor] = None
        named_parameters = list(named_parameters or [])
        all_ids = {id(v) for group in self.param_groups
                   for v in group["params"]}
        named_ids = {id(v) for _, v in named_parameters}
        if len(named_ids) != len(named_parameters):
            raise ValueError("named_parameters contains duplicate parameters")
        if not named_ids.issubset(all_ids):
            raise ValueError("named_parameters was not a subset of "
                             "optimizer.param_groups parameters")
        self._names = {id(v): f"allreduce.{k}" for k, v in named_parameters}
        for i, group in enumerate(self.param_groups):
            for j, v in enumerate(group["params"]):
                self._names.setdefault(id(v), f"allreduce.noname.{i}.{j}")
        self._handles = {}      # bucket index (or id(p)) -> engine handle
        self._wire_ctx = {}
        self._allreduce_delay = {id(v): backward_passes_per_step
                                 for group in self.param_groups
                                 for v in group["params"]}
        if bucket_cap_mb is None:
            bucket_cap_mb = _env.torch_bucket_mb()
        self._buckets: List[_GradBucket] = []
        self._param_bucket = {}
        self._bucket_residuals = {}
        self._grad_views = {}
        # Buckets fired by their last hook, and by synchronize().
        self.bucket_fires = {"hook": 0, "flush": 0}
        if bucket_cap_mb > 0 and _bucketable(compression):
            self._build_buckets(float(bucket_cap_mb) * 2 ** 20)
        if gradient_as_bucket_view is None:
            gradient_as_bucket_view = _env.torch_grad_view()
        if gradient_as_bucket_view and self._buckets:
            self._install_grad_views()
        self._register_hooks()

    # ------------------------------------------------------------- buckets

    def _wire_dtype(self, p: torch.Tensor) -> torch.dtype:
        """A cast compressor's wire dtype for a floating parameter, else
        the parameter's own (a blockwise wire quantizes in the engine)."""
        wd = getattr(self._compression, "wire_dtype", None)
        if wd is not None and p.dtype.is_floating_point:
            return wd
        return p.dtype

    def _build_buckets(self, cap_bytes: float) -> None:
        prefix = f"allreduce.bucket.{next(_optimizer_ids)}"
        params = [p for group in self.param_groups
                  for p in group["params"] if p.requires_grad]
        # Reverse registration order approximates the order backward
        # finishes gradients, so the first bucket fires first.
        open_spans = {}   # wire dtype -> [param list, bytes]
        spans = []
        for p in reversed(params):
            dt = self._wire_dtype(p)
            nbytes = p.numel() * p.element_size()
            span = open_spans.get(dt)
            if span is None or (span[1] + nbytes > cap_bytes and span[0]):
                span = [[], 0]
                spans.append(span)
                open_spans[dt] = span
            span[0].append(p)
            span[1] += nbytes
        for members, _ in spans:
            b = _GradBucket(len(self._buckets), members,
                            self._wire_dtype(members[0]),
                            f"{prefix}.{len(self._buckets)}")
            self._buckets.append(b)
            for p in members:
                self._param_bucket[id(p)] = b

    def set_bucket_cap_mb(self, bucket_cap_mb: float) -> None:
        """Cut the buckets anew under another cap, at a step boundary (no
        bucket in flight). The hooks look their bucket up at each call,
        so they follow; gradient views move into the new buffers with
        their contents; error-feedback residuals are bucket-shaped and
        start again from zero. Only a bucketed optimizer moves, and only
        to a positive cap: the hooks' kind is chosen at construction."""
        if self._handles:
            raise RuntimeError(
                "set_bucket_cap_mb while bucket collectives are in flight; "
                "call synchronize() or step() first")
        if not self._buckets or bucket_cap_mb <= 0:
            raise ValueError(
                "set_bucket_cap_mb moves an already bucketed optimizer to "
                "a positive cap (the hooks are chosen at construction)")
        had_views = bool(self._grad_views)
        # Clone aliased gradients out of the old buffers first, so none
        # is left aliasing storage the wire no longer reads.
        with torch.no_grad():
            for b in self._buckets:
                for p in b.params:
                    if p.grad is not None and id(p) in self._grad_views:
                        p.grad = p.grad.detach().clone()
        self._buckets = []
        self._param_bucket = {}
        self._bucket_residuals = {}
        self._grad_views = {}
        self._build_buckets(float(bucket_cap_mb) * 2 ** 20)
        if had_views:
            self._install_grad_views()

    def _install_grad_views(self) -> None:
        """Make each ``p.grad`` whose dtype is its bucket's a view of the
        bucket's buffer (a cast compressor's pack is a cast, which a view
        cannot hide), carrying over an existing gradient."""
        for b in self._buckets:
            for p in b.params:
                if b.buffer.dtype != p.dtype:
                    continue
                view = b.view_of(p)
                with torch.no_grad():
                    if p.grad is not None:
                        view.copy_(p.grad.detach())
                    else:
                        view.zero_()
                p.grad = view
                self._grad_views[id(p)] = view

    def _grad_is_view(self, p: torch.Tensor) -> bool:
        view = self._grad_views.get(id(p))
        return (view is not None and p.grad is not None
                and p.grad.data_ptr() == view.data_ptr())

    def _fire_buckets(self, buckets: List[_GradBucket], trigger: str) -> None:
        """Submit the buckets' in-place allreduces in one call, after the
        error feedback and the nonfinite count (both on the caller's
        stream, before the engine's fence)."""
        count = _topo.topology().numerics
        for b in buckets:
            if self._blockwise is not None \
                    and b.buffer.dtype == torch.float32:
                self._apply_error_feedback(b, self._blockwise.wire_spec)
            if count and b.buffer.dtype.is_floating_point:
                # On the device: read once, in step(), where the skip
                # decision needs it; a read here would stall backward.
                nf = b.numel - torch.isfinite(b.buffer).sum()
                self._nonfinite = nf if self._nonfinite is None \
                    else self._nonfinite + nf
            self.bucket_fires[trigger] += 1
        h = _coll.fused_allreduce_async_(
            [b.buffer for b in buckets], True,
            names=[b.name for b in buckets], compression=self._blockwise)
        for b, handle in zip(buckets, h.handles):
            self._handles[b.index] = handle

    def _apply_error_feedback(self, b: _GradBucket, spec: str) -> None:
        """The bucket's residual: the wire's input is the gradients plus
        last step's residual, and the new residual is that input less its
        local quantize-dequantize round trip (this rank's phase-1 wire
        contribution). Keyed and shaped by bucket, because the engine
        quantizes the bucket's buffer as one tensor."""
        res = self._bucket_residuals.get(b.index)
        if res is None:
            res = torch.zeros_like(b.buffer)
            self._bucket_residuals[b.index] = res
        with torch.no_grad():
            b.buffer.add_(res)
            torch.sub(b.buffer, _quant.local_roundtrip(b.buffer, spec),
                      out=res)

    # --------------------------------------------------------------- hooks

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._make_hook())

    def _make_hook(self):
        if self._buckets:
            def hook(p):
                b = self._param_bucket[id(p)]
                if id(p) in b.ready:
                    raise AssertionError(_ALREADY_REDUCED)
                self._allreduce_delay[id(p)] -= 1
                if self._allreduce_delay[id(p)] == 0:
                    view = self._grad_views.get(id(p))
                    if view is None:
                        b.fill(p)
                    elif not self._grad_is_view(p):
                        # The aliased gradient was replaced (say by
                        # zero_grad(set_to_none=True)): copy it home and
                        # alias it again for the next step.
                        b.fill(p)
                        with torch.no_grad():
                            p.grad = view
                    b.ready.add(id(p))
                    if len(b.ready) == len(b.params):
                        # The bucket's last gradient landed: fire it now,
                        # while backward works on the rest of the graph.
                        self._fire_buckets([b], "hook")
            return hook

        def hook(p):
            if id(p) in self._handles:
                raise AssertionError(_ALREADY_REDUCED)
            self._allreduce_delay[id(p)] -= 1
            if self._allreduce_delay[id(p)] == 0:
                self._handles[id(p)] = self._allreduce_grad_async(p)
        return hook

    def _allreduce_grad_async(self, p):
        wire, ctx = self._compression.compress(p.grad)
        self._wire_ctx[id(p)] = ctx
        name = self._names[id(p)]
        if wire is p.grad:
            return _coll.allreduce_async_(p.grad, True, name, self._blockwise)
        return _coll.allreduce_async(wire, True, name,
                                     compression=self._blockwise)

    def synchronize(self) -> None:
        """Fire what the hooks did not, wait for every allreduce and put
        the averaged gradients into ``p.grad``. A parameter still
        accumulating (an early ``step()``) is reduced too, so no rank
        steps on gradients of its own."""
        if self._buckets:
            self._synchronize_buckets()
            return
        for group in self.param_groups:
            for p in group["params"]:
                if (p.requires_grad and p.grad is not None
                        and id(p) not in self._handles):
                    self._handles[id(p)] = self._allreduce_grad_async(p)
        params_by_id = {id(p): p for group in self.param_groups
                        for p in group["params"]}
        pids = list(self._handles)
        outs = _coll.synchronize_many([self._handles[i] for i in pids])
        with torch.no_grad():
            for pid, out in zip(pids, outs):
                p = params_by_id[pid]
                ctx = self._wire_ctx.pop(pid, None)
                if out is not p.grad:
                    p.grad.copy_(self._compression.decompress(out, ctx)
                                 .reshape(p.grad.shape))
                self._allreduce_delay[pid] = self.backward_passes_per_step
        self._handles.clear()
        self._synchronized = True

    def _synchronize_buckets(self) -> None:
        partial = []
        for b in self._buckets:
            if b.index in self._handles:
                continue
            for p in b.params:
                if p.grad is not None and id(p) not in b.ready:
                    if not self._grad_is_view(p):
                        b.fill(p)
                    b.ready.add(id(p))
            if b.ready:
                partial.append(b)
        if partial:
            self._fire_buckets(partial, "flush")
        fired = sorted(self._handles)
        _coll.synchronize_many([self._handles[i] for i in fired])
        for i in fired:
            b = self._buckets[i]
            for p in b.params:
                if id(p) in b.ready and p.grad is not None:
                    # The result landed in the buffer: views see it, the
                    # copy path copies it back.
                    if not self._grad_is_view(p):
                        b.scatter(p)
                    self._allreduce_delay[id(p)] = \
                        self.backward_passes_per_step
            b.ready.clear()
        self._handles.clear()
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
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without skip_synchronize() "
                    "after optimizer.synchronize(); this allreduces every "
                    "gradient again. Wrap step() in "
                    "optimizer.skip_synchronize().")
            self.synchronize()
        self._synchronized = False
        nonfinite, self._nonfinite = self._nonfinite, None
        if self._skip_nonfinite and nonfinite is not None \
                and int(nonfinite):
            # Every rank ran the same collectives; only the update is
            # skipped, so the averaged NaN/Inf never reach the weights.
            warnings.warn("skip_nonfinite_steps: nonfinite gradient "
                          "elements this step; optimizer update skipped")
            return None
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(); "
                "this would discard in-flight allreduced gradients.")
        if self._grad_views and not args and "set_to_none" not in kwargs:
            # Zero the views in place, so they survive; an explicit
            # set_to_none=True drops them and the hooks alias again.
            kwargs["set_to_none"] = False
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[
                             Iterable[Tuple[str, torch.Tensor]]] = None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         bucket_cap_mb: Optional[float] = None,
                         gradient_as_bucket_view: Optional[bool] = None,
                         skip_nonfinite_steps: Optional[bool] = None):
    """Wrap ``optimizer`` so that ``step()`` averages gradients over all
    ranks first. The wrapper is an instance of a subclass of the inner
    optimizer's class, sharing its param groups and hyperparameters.

    ``bucket_cap_mb``: the buckets' size target in MiB; None reads
    HOROVOD_TPU_TORCH_BUCKET_MB (default 64, the fusion threshold), 0
    keeps one hook and one request per gradient.
    ``gradient_as_bucket_view``: alias each ``p.grad`` into its bucket's
    buffer, so autograd accumulates into the collective's payload (no
    pack or scatter copies, the same results); None reads
    HOROVOD_TPU_TORCH_GRAD_VIEW (default off).
    ``skip_nonfinite_steps``: when the buckets packed NaN or Inf
    gradient elements this step (counted under HOROVOD_TPU_NUMERICS=1),
    ``step()`` still synchronizes but skips the inner update; None reads
    HOROVOD_TPU_TORCH_SKIP_NONFINITE (default off)."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, bucket_cap_mb,
               gradient_as_bucket_view, skip_nonfinite_steps)


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
