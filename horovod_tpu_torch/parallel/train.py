"""Training steps: the flagship transformer (data parallel, or over a
mesh with tensor and sequence parallelism) and the image models.

``build_train_step`` is the counterpart of ``build_train_step`` in
``horovod_tpu/parallel/train.py`` for the 'dp' axis: each rank computes
the mean loss of its batch shard and its gradients;
``DistributedOptimizer`` averages the gradients over the ranks (the JAX
step's psum of ``loss / n_data`` gradients), in buckets its gradient
hooks fire during backward, before the inner optimizer's update; the
reported loss is the global mean. A step starts with the optimizer's
own ``zero_grad()``, which keeps gradient views (without views it sets
the gradients to None).

With a ``mesh``, ``build_train_step`` builds :class:`MeshTrainStep`,
the counterpart of the JAX step itself (``horovod_tpu/parallel/
train.py``): every rank holds its shard of the parameters
(``param_specs``: tp blocks, ep experts) and of the batch (batch over
'dp', or over ``(dcn_axis, 'dp')`` jointly, sequence over the config's
'sp'), runs the model's own collectives (the row-parallel psum, the
ring's shifts, Ulysses' and the experts' all-to-alls), and then follows
JAX's gradient rule. Each data shard's loss is its local mean over
``n_data`` (the product of 'dp', 'sp' and the dcn axis), masked to zero
except at tp and ep index 0; backward, with psum's backward a psum;
then each gradient is summed over every mesh axis its parameter is not
split over (:func:`reduce_gradients`), and the inner optimizer steps.
The reported loss is the sum over all axes: the global mean. This step
does not go through the collective engine: the engine negotiates
Horovod's named requests over the whole world, while the JAX step's
reductions are in-program psums over mesh axes, which every rank of an
axis's group issues in the same order (coalesced collectives on the
mesh's groups).

Two modes of the mesh step change the reduction, as in JAX. With
``dcn_axis`` (an outer data axis that crosses nodes) the gradients that
sum over both it and 'dp' take the hierarchical path
(``collectives.hierarchical_psum_tree``: reduce-scatter over 'dp', the
1/dp span summed over the dcn axis, exact or through the ``dcn_wire``
block quantizer, all-gather over 'dp'). Handed a ZeRO-1 optimizer
(``make_optimizer(model, zero1=True)`` or ``zero.zero1_init``), the
step skips 'dp' in the reduction and the optimizer's own
``psum_scatter`` sums over it (``parallel/zero.py``).

``build_pipeline_train_step`` is the counterpart of JAX's pipelined
step over 'pp': the flagship cut into ``n_layers / (pp·V)``-layer
chunks (:class:`PipelineModel`, JAX's pipeline layout through
:func:`to_pipeline_params`), the embedding and the loss head on every
rank, the schedules of ``parallel/pipeline.py`` in between, every
gradient written to ``.grad`` and the inner optimizer stepped.

``build_image_train_step`` is the counterpart of one step of
``bench.py``'s ``build_step`` (the ResNet-50 headline) and of
``examples/jax_synthetic_benchmark.py``'s step, for any classifier of
the conv zoo: mean softmax cross-entropy of integer labels over fp32
logits, the BN running stats updated from this rank's batch (a sync-BN
model's, from the global batch: its ``[2C]`` statistics all-reduce runs
on its mesh's group inside the forward), the gradients averaged over
the ranks in the engine's hook-fired buckets, then the inner step.
Dropout draws from a generator on the step's device seeded from
``(seed, step)`` each step, as JAX folds the step index into its
dropout key.
"""

from __future__ import annotations

import functools
import math
from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .. import topology as _topo
from ..models.layers import set_dropout_generator
from ..models.transformer import Transformer, TransformerConfig, param_specs
from ..ops import collective as _coll
from ..optimizer import DistributedOptimizer
from .collectives import axis_size, hierarchical_psum_tree, psum
from .mesh import (dcn_axes, place, shard_tensor, shard_tree, spec_axes,
                   spec_of)
from .zero import Zero1Optimizer, zero1_init

DATA_AXES = ("dp", "sp")
MODEL_AXES = ("tp", "ep")


class TrainStep:
    """``step(model, optimizer, tokens, targets) -> loss``.

    ``optimizer`` must come from :meth:`make_optimizer` (or be any
    :func:`DistributedOptimizer`); ``tokens``/``targets`` are this rank's
    ``[B_local, S]`` shard. The returned loss is a 0-d fp32 tensor, the
    mean over every rank's tokens."""

    def __init__(self, cfg: TransformerConfig,
                 optimizer_factory: Callable[[Iterable], torch.optim.Optimizer],
                 device: torch.device):
        self.cfg = cfg
        self.optimizer_factory = optimizer_factory
        self.device = device

    def make_model(self, **kwargs) -> Transformer:
        return Transformer(self.cfg, device=self.device, **kwargs)

    def make_optimizer(self, model: Transformer):
        return DistributedOptimizer(
            self.optimizer_factory(model.parameters()),
            named_parameters=model.named_parameters())

    def __call__(self, model: Transformer, optimizer, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        if not hasattr(optimizer, "synchronize"):
            raise TypeError("the train step needs a DistributedOptimizer "
                            "(see TrainStep.make_optimizer)")
        tokens = tokens.to(model.device, non_blocking=True)
        targets = targets.to(model.device, non_blocking=True)
        optimizer.zero_grad()
        loss = model.loss_fn(tokens, targets)
        loss.backward()
        optimizer.step()
        return _coll.allreduce(loss.detach().float(), average=True,
                               name="train_step.loss")


def _step_device(device) -> torch.device:
    if device is None:
        device = (_topo.device() if _topo.is_initialized()
                  else _topo.resolve_device(None))
    return _topo.resolve_device(device)


def reduce_gradients(model: nn.Module, specs: Dict, mesh: DeviceMesh,
                     skip: Iterable[str] = (),
                     hierarchical: Optional[Tuple[str, str]] = None,
                     dcn_wire: Optional[str] = None) -> None:
    """JAX's reduction rule, in place: each parameter's gradient summed
    over every mesh axis not in its spec, leaving out the axes in
    ``skip`` (ZeRO-1 sums over 'dp' in its own psum_scatter). The
    gradients that miss the same axes go together, one coalesced
    collective per axis. With ``hierarchical=(ici_axis, dcn_axis)`` the
    gradients that miss both take the two-stage reduction
    (``hierarchical_psum_tree``, its cross-node leg quantized by
    ``dcn_wire``), whatever the axes' sizes, as in JAX; the others keep
    the plain sums."""
    axes = [a for a in mesh.mesh_dim_names if a not in skip]
    groups = defaultdict(list)
    for name, p in model.named_parameters():
        have = set(spec_axes(spec_of(specs, name)))
        missing = tuple(a for a in axes if a not in have)
        if missing and p.grad is not None:
            groups[missing].append(p.grad)
    for missing, grads in groups.items():
        if hierarchical and set(hierarchical) <= set(missing):
            ici, dcn = hierarchical
            for g, r in zip(grads, hierarchical_psum_tree(
                    grads, mesh, ici, dcn, wire=dcn_wire)):
                g.copy_(r)
            missing = tuple(a for a in missing if a not in hierarchical)
        missing = tuple(a for a in missing if axis_size(mesh, a) > 1)
        if not missing:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        for a in missing:
            dist.all_reduce(flat, group=mesh.get_group(a))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class MeshTrainStep:
    """``step(model, optimizer, tokens, targets) -> loss`` over a mesh.

    ``model`` comes from :meth:`make_model` (this rank's shard of the
    parameters), ``optimizer`` from :meth:`make_optimizer` (the inner
    optimizer over the shard, or with ``zero1=True`` the ZeRO-1 wrapper,
    which selects the ZeRO-1 reduction); ``tokens``/``targets`` are this
    rank's ``[B / (dcn * dp), S / sp]`` block (:meth:`shard_batch` cuts
    it from the global batch). The returned loss is a 0-d fp32 tensor,
    the global mean, on every rank."""

    def __init__(self, cfg: TransformerConfig,
                 optimizer_factory: Callable[[Iterable],
                                             torch.optim.Optimizer],
                 mesh: DeviceMesh, device: torch.device,
                 dcn_axis: Optional[str] = None,
                 dcn_wire: Optional[str] = None,
                 dcn_hierarchical: bool = True):
        names = mesh.mesh_dim_names
        for axis in (cfg.tp_axis, cfg.sp_axis, cfg.ep_axis):
            if axis and axis not in names:
                raise ValueError(f"config axis {axis!r} is not a mesh axis "
                                 f"(axes: {names})")
        if dcn_axis == "auto":
            found = [a for a in dcn_axes(mesh)
                     if a not in (cfg.tp_axis, cfg.sp_axis, cfg.ep_axis)]
            dcn_axis = found[0] if found else None
        if dcn_axis is not None:
            if dcn_axis not in names:
                raise ValueError(f"dcn_axis {dcn_axis!r} is not a mesh axis "
                                 f"(axes: {sorted(names)})")
            if "dp" not in names:
                raise ValueError("hierarchical reduction needs an in-slice "
                                 f"'dp' axis under dcn_axis {dcn_axis!r}")
        self.cfg = cfg
        self.optimizer_factory = optimizer_factory
        self.mesh = mesh
        self.device = device
        self.dcn_axis = dcn_axis
        self.dcn_wire = dcn_wire
        self.hierarchical = (("dp", dcn_axis)
                             if dcn_axis is not None and dcn_hierarchical
                             else None)
        self.specs = param_specs(cfg)
        self.sizes, self.coords = place(mesh)
        self.n_data = math.prod(self.sizes.get(a, 1) for a in DATA_AXES)
        if dcn_axis is not None:
            self.n_data *= self.sizes[dcn_axis]
            batch = (dcn_axis, "dp")
        else:
            batch = "dp" if "dp" in self.sizes else None
        self.data_spec = (batch, cfg.sp_axis)

    def shard_params(self, params: Dict) -> Dict:
        """This rank's slice of a global parameter tree."""
        return shard_tree(params, self.specs, self.sizes, self.coords)

    def shard_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``[B, S]`` batch."""
        return shard_tensor(batch, self.data_spec, self.sizes, self.coords)

    def make_model(self, **kwargs) -> Transformer:
        return Transformer(self.cfg, device=self.device, mesh=self.mesh,
                           **kwargs)

    def make_optimizer(self, model: Transformer, zero1: bool = False):
        """The inner optimizer over ``model``'s parameters; with
        ``zero1`` the ZeRO-1 wrapper over 'dp' (``zero.zero1_init``)."""
        if not zero1:
            return self.optimizer_factory(model.parameters())
        opt = zero1_init(self.optimizer_factory, model,
                         self.sizes.get("dp", 1), self.mesh,
                         param_specs=self.specs)
        self._check_zero1(opt)
        return opt

    def _check_zero1(self, opt: Zero1Optimizer) -> None:
        """JAX's refusals of a ZeRO-1 state for this step."""
        if self.dcn_axis is not None:
            raise ValueError(
                "ZeRO-1 optimizer state and dcn_axis hierarchical "
                "reduction are mutually exclusive: ZeRO-1's psum_scatter "
                "already owns the 'dp'-space reduction")
        if "dp" not in self.sizes:
            raise ValueError("ZeRO-1 optimizer state requires a 'dp' mesh "
                             "axis to shard over")
        dp = self.sizes["dp"]
        if opt.n_shards != dp:
            raise ValueError(
                f"the ZeRO-1 state was built for n_shards={opt.n_shards} "
                f"but this mesh's 'dp' axis has {dp} shards; the flat-shard "
                "padding depends on the shard count, so rebuild the state "
                f"with zero1_init(..., n_shards={dp}) for this mesh")
        for spec in _spec_leaves(self.specs):
            if "dp" in spec_axes(spec):
                raise ValueError(
                    "ZeRO-1 shards moments over 'dp' and requires "
                    f"dp-replicated parameters; spec {spec} already uses "
                    "'dp'")

    def __call__(self, model: Transformer, optimizer, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        zero1 = isinstance(optimizer, Zero1Optimizer)
        if zero1:
            self._check_zero1(optimizer)
        tokens = tokens.to(model.device, non_blocking=True)
        targets = targets.to(model.device, non_blocking=True)
        optimizer.zero_grad()
        loss = model.loss_fn(tokens, targets) / self.n_data
        # Model ranks past index 0 hold copies of the same loss: masked,
        # each data shard counts once, and the masked ranks still get
        # their cotangents through the collectives' backward.
        if any(self.coords[a] for a in MODEL_AXES if a in self.coords):
            loss = torch.where(loss.new_zeros((), dtype=torch.bool), loss,
                               0.0)
        loss.backward()
        if zero1:
            reduce_gradients(model, self.specs, self.mesh, skip=("dp",))
        else:
            reduce_gradients(model, self.specs, self.mesh,
                             hierarchical=self.hierarchical,
                             dcn_wire=self.dcn_wire)
        optimizer.step()
        return psum(loss.detach().float(), self.mesh,
                    self.mesh.mesh_dim_names)


def _spec_leaves(tree):
    """The specs (tuples) of a spec tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, list):
        yield tree
        return
    for sub in tree:
        yield from _spec_leaves(sub)


def build_train_step(cfg: TransformerConfig,
                     optimizer_factory: Callable[[Iterable],
                                                 torch.optim.Optimizer],
                     *, device: Union[str, torch.device, None] = None,
                     mesh: Optional[DeviceMesh] = None,
                     dcn_axis: Optional[str] = None,
                     dcn_wire: Optional[str] = None,
                     dcn_hierarchical: bool = True
                     ) -> Union[TrainStep, MeshTrainStep]:
    """The train step for ``cfg``. ``optimizer_factory(params)`` builds
    the inner ``torch.optim`` optimizer. ``device`` defaults to the one
    ``init()`` chose, else CUDA. With a ``mesh`` it is the mesh step
    (a config with ``tp_axis``/``sp_axis``/``ep_axis`` needs one);
    without, the dp step through ``DistributedOptimizer``.

    ``dcn_axis`` names an outer data axis of the mesh that crosses nodes
    (``"auto"``: the first of ``mesh.dcn_axes``, which honours
    ``HOROVOD_TPU_DCN_AXES``, that is no model axis of ``cfg``): the
    batch splits over ``(dcn_axis, 'dp')`` jointly, and the gradients
    reduce hierarchically, the cross-node leg block-quantized when
    ``dcn_wire`` names a spec (``"int8x256"``, ``"fp8x256"``).
    ``dcn_hierarchical=False`` keeps the layout and sums with flat
    psums, the baseline the bytes are compared against."""
    dev = _step_device(device)
    if mesh is not None:
        return MeshTrainStep(cfg, optimizer_factory, mesh, dev,
                             dcn_axis=dcn_axis, dcn_wire=dcn_wire,
                             dcn_hierarchical=dcn_hierarchical)
    if cfg.tp_axis or cfg.sp_axis or cfg.ep_axis or dcn_axis:
        raise ValueError("a config with tp_axis/sp_axis/ep_axis, or a "
                         "dcn_axis, needs mesh= "
                         "(parallel.mesh.create_mesh)")
    return TrainStep(cfg, optimizer_factory, dev)


def _step_seed(seed: int, step: int) -> int:
    """A generator seed from ``(seed, step)``: every step's dropout masks
    differ, and a replayed step draws the same ones."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class ImageTrainStep:
    """``step(model, optimizer, images, labels) -> loss``.

    ``images`` are this rank's NHWC ``[B_local, H, W, C]`` shard and
    ``labels`` its ``[B_local]`` integer classes. The model is in train
    mode during the step, so each BN normalises with the batch
    statistics (this rank's, or the axis's for sync BN) and updates its
    running ones. The returned loss is a 0-d fp32 tensor, the mean over
    every rank's images. ``steps`` counts the steps taken; a model from
    :meth:`make_model` draws its dropout masks from the step's
    generator, which step ``i`` reseeds from ``(seed, i)``."""

    def __init__(self, model_factory: Callable[..., nn.Module],
                 optimizer_factory: Callable[[Iterable],
                                             torch.optim.Optimizer],
                 device: torch.device, seed: int = 0):
        self.model_factory = model_factory
        self.optimizer_factory = optimizer_factory
        self.device = device
        self.seed, self.steps = seed, 0
        self._dropout = torch.Generator(device=device)

    def make_model(self, **kwargs) -> nn.Module:
        model = self.model_factory(device=self.device, **kwargs)
        set_dropout_generator(model, self._dropout)
        return model

    def make_optimizer(self, model: nn.Module):
        return DistributedOptimizer(
            self.optimizer_factory(model.parameters()),
            named_parameters=model.named_parameters())

    def __call__(self, model: nn.Module, optimizer, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        if not hasattr(optimizer, "synchronize"):
            raise TypeError("the train step needs a DistributedOptimizer "
                            "(see ImageTrainStep.make_optimizer)")
        images = images.to(self.device, non_blocking=True)
        labels = labels.to(self.device, non_blocking=True).long()
        self._dropout.manual_seed(_step_seed(self.seed, self.steps))
        self.steps += 1
        model.train()
        optimizer.zero_grad()
        loss = F.cross_entropy(model(images).float(), labels)
        loss.backward()
        optimizer.step()
        return _coll.allreduce(loss.detach().float(), average=True,
                               name="image_train_step.loss")


def build_image_train_step(model_factory: Callable[..., nn.Module],
                           optimizer_factory: Callable[[Iterable],
                                                       torch.optim.Optimizer],
                           *, device: Union[str, torch.device, None] = None,
                           seed: int = 0) -> ImageTrainStep:
    """The dp train step of a conv-zoo classifier (``ResNet50``,
    ``VGG16``, ``InceptionV3``, ``MnistConvNet``, ...).
    ``model_factory(device=..., **kwargs)`` builds the model (e.g.
    ``functools.partial(ResNet50, num_classes=1000, bn_impl="pallas")``);
    ``optimizer_factory(params)`` the inner optimizer, e.g.
    ``SGD(lr=0.01 * size, momentum=0.9)`` as ``bench.py`` uses. ``device``
    defaults to the one ``init()`` chose, else CUDA; ``seed`` seeds the
    dropout masks."""
    return ImageTrainStep(model_factory, optimizer_factory,
                          _step_device(device), seed)


# ---------------------------------------------------------------------------
# The pipelined flagship over 'pp'
# ---------------------------------------------------------------------------

_DENSE_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "wi", "wo_mlp")


def _check_pipeline_cfg(cfg: TransformerConfig, mesh: Optional[DeviceMesh],
                        num_virtual: int, stages: Optional[int] = None
                        ) -> int:
    """JAX's refusals, in JAX's order, and the stage count: the mesh's
    'pp' size, or ``stages`` for virtual stages in one process (no
    mesh)."""
    if mesh is not None:
        names = mesh.mesh_dim_names
        if "pp" not in names:
            raise ValueError("build_pipeline_train_step needs a 'pp' mesh "
                             f"axis (axes: {sorted(names)})")
    for ax, name in ((cfg.tp_axis, "tp"), (cfg.sp_axis, "sp"),
                     (cfg.ep_axis, "ep")):
        if ax:
            raise ValueError(
                f"pipeline train step does not compose with {name} "
                "parallelism yet; build the config with "
                f"{name}_axis=None")
    if cfg.num_experts:
        raise ValueError("pipeline train step supports dense layers "
                         "only (num_experts=0): MoE layer dicts are not "
                         "homogeneous across the stage stack")
    n = stages
    if mesh is not None:
        n = axis_size(mesh, "pp")
        extra = [a for a in names if a != "pp" and axis_size(mesh, a) > 1]
        if extra:
            raise ValueError("pipeline train step shards over 'pp' only; "
                             f"fold or drop mesh axes {extra}")
    if cfg.n_layers % (n * num_virtual):
        raise ValueError(
            f"n_layers ({cfg.n_layers}) must divide evenly into "
            f"pp ({n}) x num_virtual ({num_virtual}) stage chunks")
    return n


def to_pipeline_params(cfg: TransformerConfig, params: Dict,
                       num_stages: int, num_virtual: int = 1) -> Dict:
    """``init_params``' tree in the pipeline layout: ``{"embed", "pos",
    "ln_f", "stages"}``, each stages leaf ``[n_pp, V, layers_per_chunk,
    ...]``: slot ``[r, v]`` holds chunk-stage ``v·n + r``'s layers in
    order (V = 1: contiguous stages)."""
    nV = num_stages * num_virtual
    lpc = cfg.n_layers // nV
    layers = params["layers"]
    stages = {}
    for key in layers[0]:
        arr = torch.stack([torch.stack([layers[c * lpc + i][key]
                                        for i in range(lpc)])
                           for c in range(nV)])
        stages[key] = arr.reshape((num_virtual, num_stages)
                                  + arr.shape[1:]).transpose(0, 1)
    return {"embed": params["embed"], "pos": params["pos"],
            "ln_f": params["ln_f"], "stages": stages}


def from_pipeline_params(cfg: TransformerConfig, pparams: Dict,
                         num_stages: int, num_virtual: int = 1) -> Dict:
    """The inverse of :func:`to_pipeline_params`."""
    nV = num_stages * num_virtual
    lpc = cfg.n_layers // nV
    flat = {k: s.transpose(0, 1).reshape((nV * lpc,) + s.shape[3:])
            for k, s in pparams["stages"].items()}
    return {"embed": pparams["embed"], "pos": pparams["pos"],
            "ln_f": pparams["ln_f"],
            "layers": [{k: f[i] for k, f in flat.items()}
                       for i in range(nV * lpc)]}


def pipeline_param_specs(cfg: TransformerConfig) -> Dict:
    """Partition specs of the pipeline layout: the stage stacks split
    their leading n_pp axis over 'pp'; embed, pos and ln_f replicate
    (the embedding and the loss head run on every rank)."""
    return {"embed": (), "pos": (), "ln_f": (),
            "stages": {k: ("pp",) for k in _DENSE_LAYER_KEYS}}


class PipelineModel(nn.Module):
    """One 'pp' rank's part of the pipelined flagship: ``embed``, ``pos``
    and ``ln_f``, replicated, and its V chunks of ``n_layers / (pp·V)``
    layers, ``chunks[v][i]`` the i-th layer of chunk-stage ``v·n +
    rank``. ``params`` is the rank's block of the pipeline layout
    (stages leaves ``[1, V, layers_per_chunk, ...]``)."""

    def __init__(self, cfg: TransformerConfig, params: Dict,
                 device: torch.device):
        super().__init__()
        from ..models.transformer import _Layer
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"].clone())
        self.pos = nn.Parameter(params["pos"].clone())
        self.ln_f = nn.Parameter(params["ln_f"].clone())
        stages = params["stages"]
        _, V, lpc = next(iter(stages.values())).shape[:3]
        self.chunks = nn.ModuleList(
            nn.ModuleList(_Layer({k: s[0, v, i] for k, s in stages.items()})
                          for i in range(lpc))
            for v in range(V))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


class PipelineTrainStep:
    """``step(model, optimizer, tokens_mb, targets_mb) -> loss`` over
    'pp', the counterpart of JAX's ``build_pipeline_train_step`` step.

    ``model`` is this rank's :class:`PipelineModel` (:meth:`make_model`),
    ``optimizer`` the inner optimizer over it (:meth:`make_optimizer`);
    ``tokens_mb``/``targets_mb`` are ``[m, micro_batch, S]``, the same
    on every rank ('pp' splits layers, not data). The embedding runs on
    every rank; its gradient is the pullback of the schedule's input
    gradients (summed over 'pp'). The head (final layernorm, the tied
    projection under ``cfg.logits_bf16`` and the mean NLL, on full
    logits per microbatch: ``cfg.loss_chunk`` is not used, as in JAX)
    rides the schedule's ``loss_params``, so ``embed``'s gradient is
    the sum of both paths. The step zeroes the gradients, runs the
    schedule, writes every gradient to ``.grad`` and steps the
    optimizer. The returned loss is a 0-d fp32 tensor, the mean over
    the microbatches, the same on every rank."""

    def __init__(self, cfg: TransformerConfig,
                 optimizer_factory: Callable[[Iterable],
                                             torch.optim.Optimizer],
                 ring, mesh: Optional[DeviceMesh], schedule: str,
                 num_virtual: int, cost_backward: float,
                 device: torch.device):
        self.cfg = cfg
        self.optimizer_factory = optimizer_factory
        self.ring = ring
        self.mesh = mesh
        self.n = ring.n
        self.schedule = schedule
        self.num_virtual = num_virtual
        self.cost_backward = cost_backward
        self.device = device
        self.specs = pipeline_param_specs(cfg)
        self._remat = {}
        if cfg.remat_policy == "dots":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts
            from ..models.transformer import _save_dots
            self._remat["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)

    def schedule_info(self, num_microbatches: int):
        """The schedule's static budget at this stage count
        (``pipeline.schedule_info``)."""
        from .pipeline import schedule_info
        return schedule_info(self.schedule, self.n, num_microbatches,
                             num_virtual=self.num_virtual,
                             cost_bwd=self.cost_backward)

    def _rank(self, rank: Optional[int]) -> int:
        if rank is not None:
            return rank
        if self.mesh is None:
            raise ValueError("virtual stages need the rank of the model")
        return self.ring.ranks[0]

    def shard_params(self, pparams: Dict, rank: Optional[int] = None
                     ) -> Dict:
        """Rank ``rank``'s block (default: this rank's) of a tree in the
        pipeline layout."""
        return shard_tree(pparams, self.specs, {"pp": self.n},
                          {"pp": self._rank(rank)})

    def shard_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """The ``[m, micro_batch, S]`` batch on the step's device (it is
        replicated over 'pp')."""
        return batch.to(self.device)

    def make_model(self, params: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None,
                   rank: Optional[int] = None) -> PipelineModel:
        """Rank ``rank``'s model (default: this rank's) from its block
        ``params``, or cut from a tree drawn from ``generator``."""
        if params is None:
            from ..models.transformer import init_params
            params = self.shard_params(
                to_pipeline_params(self.cfg, init_params(self.cfg, generator),
                                   self.n, self.num_virtual), rank)
        return PipelineModel(self.cfg, params, self.device)

    def make_optimizer(self, model: PipelineModel) -> torch.optim.Optimizer:
        return self.optimizer_factory(model.parameters())

    def _stage(self, chunk, x):
        from torch.utils.checkpoint import checkpoint
        from ..models.transformer import _block
        for p in chunk:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_block, p, x, self.cfg, use_reentrant=False,
                               **self._remat)
            else:
                x = _block(p, x, self.cfg)
        return x

    def _head_loss(self, lp, y, targets):
        from ..models.transformer import _layernorm, project_logits
        logits = project_logits(lp["embed"], _layernorm(y, lp["ln_f"]),
                                self.cfg)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    def _embed(self, model: PipelineModel, tokens_mb):
        dt = self.cfg.dtype
        s = tokens_mb.shape[-1]
        return model.embed.to(dt)[tokens_mb] + model.pos[:s].to(dt)

    def __call__(self, model, optimizer, tokens_mb: torch.Tensor,
                 targets_mb: torch.Tensor) -> torch.Tensor:
        from .pipeline import _leaves, _value_and_grad_chunks
        virtual = self.mesh is None
        models = list(model) if virtual else [model]
        opts = list(optimizer) if virtual else [optimizer]
        tokens_mb = tokens_mb.to(models[0].device, non_blocking=True)
        targets_mb = targets_mb.to(models[0].device, non_blocking=True)
        xs, chunks, lps = [], [], []
        for mdl, opt in zip(models, opts):
            opt.zero_grad()
            xs.append(self._embed(mdl, tokens_mb))
            chunks.append([[layer.tree() for layer in c]
                           for c in mdl.chunks])
            lps.append({"ln_f": mdl.ln_f, "embed": mdl.embed})
        results = _value_and_grad_chunks(
            self.ring, self._stage, self._head_loss, chunks,
            [x.detach() for x in xs], schedule=self.schedule,
            num_virtual=self.num_virtual,
            loss_aux=[targets_mb] * len(models), loss_params=lps,
            return_input_grads=True)
        for mdl, opt, x, cs, (_, grads, lp_grads, xg) in zip(
                models, opts, xs, chunks, results):
            x.backward(xg)
            d_ln_f, d_embed = lp_grads
            # Tied embedding: the input path's pullback + the head's.
            mdl.embed.grad = mdl.embed.grad + d_embed
            mdl.ln_f.grad = d_ln_f
            for c, gs in zip(cs, grads):
                for p, g in zip(_leaves(c), gs):
                    p.grad = g
            opt.step()
        return results[0][0]


def _pipeline_step(cfg, mesh, ring, optimizer_factory, schedule,
                   num_virtual, cost_backward, device):
    interleaved = schedule == "interleaved"
    if interleaved and num_virtual < 2:
        raise ValueError("interleaved needs num_virtual >= 2")
    if not interleaved and num_virtual != 1:
        raise ValueError(f"schedule {schedule!r} uses num_virtual=1")
    if schedule == "zb-h1" and cfg.remat and cfg.remat_policy == "dots":
        raise ValueError(
            "zb-h1 runs two backward passes through each microbatch's "
            "graph (Bx, then W), and torch's selective checkpoint "
            "(remat_policy='dots') allows one; use remat_policy='full' "
            "or another schedule")
    return PipelineTrainStep(cfg, optimizer_factory, ring, mesh, schedule,
                             num_virtual, cost_backward,
                             _step_device(device))


def build_pipeline_train_step(cfg: TransformerConfig, mesh: DeviceMesh,
                              optimizer_factory: Callable[
                                  [Iterable], torch.optim.Optimizer], *,
                              schedule: str = "1f1b", num_virtual: int = 1,
                              cost_backward: float = 2.0,
                              device: Union[str, torch.device, None] = None
                              ) -> PipelineTrainStep:
    """The pipeline-parallel train step of the flagship over the mesh's
    'pp' axis (every other axis of size 1): each rank runs ``n_layers /
    (pp · V)`` decoder blocks per chunk (under ``checkpoint`` with
    ``cfg.remat``), on the schedule ``"gpipe"``, ``"1f1b"``,
    ``"interleaved"`` (``num_virtual`` >= 2 chunks a rank) or
    ``"zb-h1"``. The microbatch count is the batch's leading axis.
    ``cost_backward`` enters only :meth:`PipelineTrainStep.schedule_info`.
    ``device`` defaults to the one ``init()`` chose, else CUDA."""
    from .pipeline import _GroupRing
    _check_pipeline_cfg(cfg, mesh, num_virtual)
    return _pipeline_step(cfg, mesh, _GroupRing(mesh, "pp"),
                          optimizer_factory, schedule, num_virtual,
                          cost_backward, device)


def _virtual_pipeline_train_step(cfg: TransformerConfig, stages: int,
                                 optimizer_factory, *, schedule="1f1b",
                                 num_virtual=1, cost_backward=2.0,
                                 device=None) -> PipelineTrainStep:
    """The same step over ``stages`` virtual stages in this process: one
    model and one optimizer per stage (``make_model(rank=r)``), passed
    to the step as lists in rank order."""
    from .pipeline import _LocalRing
    n = _check_pipeline_cfg(cfg, None, num_virtual, stages)
    return _pipeline_step(cfg, None, _LocalRing(n), optimizer_factory,
                          schedule, num_virtual, cost_backward, device)
