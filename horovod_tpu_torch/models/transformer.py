"""Flagship decoder-only Transformer LM.

Counterpart of ``horovod_tpu/models/transformer.py``: the same config,
parameter tree, partition specs and numerics. Parameters are fp32 and
cast to ``cfg.dtype`` at each use, so gradients land in fp32 on fp32
masters. Weights keep the JAX ``x @ W`` layout (``wq`` is ``[d, d]``,
``wi`` is ``[d, f]``, ``embed`` is ``[vocab, d]`` and tied to the output
projection). GELU is the tanh approximation, as ``jax.nn.gelu``'s
default is; layernorm has no bias, eps 1e-5, and runs in fp32.

With ``tp_axis``/``sp_axis`` the model runs as one shard of a mesh (the
``mesh`` argument, from ``parallel.mesh.create_mesh``), as JAX's
functions run inside ``shard_map``: it holds this rank's slices of the
weights (:func:`param_specs`: Q/K/V and ``wi`` split on their output
columns over 'tp', ``wo`` and ``wo_mlp`` on their input rows, one psum
after each), takes this rank's sequence shard, and attends over 'sp' by
ring attention (``sp_impl="ring"``) or Ulysses (``"ulysses"``). With
``num_experts`` every odd layer's MLP is a top-1 mixture of experts
(``parallel/expert.py``) whose experts split over ``ep_axis``; under
'tp' each tp rank routes its 1/tp of the tokens and an ``all_gather``
over 'tp' joins the outputs, so the experts' work is done once per tp
group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.flash_attention import flash_attention
from ..parallel.collectives import all_gather, axis_index, axis_size, psum
from ..parallel.expert import moe_apply, moe_init
from ..parallel.mesh import place, shard_tree
from ..parallel.ring_attention import full_attention, ring_attention
from ..parallel.ulysses import ulysses_attention
from ..topology import resolve_device

# Attended length from which ``use_flash=None`` picks the flash kernels.
FLASH_MIN_SEQ = 1024


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    # None derives the largest head count dividing d_model with
    # head_dim >= 128, exactly as the JAX config does.
    n_heads: Optional[int] = None
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: Any = torch.bfloat16
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    sp_impl: str = "ring"
    # None: flash kernels on CUDA from FLASH_MIN_SEQ attended tokens, at
    # any dtype, full attention otherwise. True forces flash_attention (its
    # plain version on the CPU).
    use_flash: Optional[bool] = None
    # The Pallas kernels' tile size in JAX. The Hopper kernels' tiles are
    # fixed by their design (128 q rows by 64 keys) and the plain version
    # has none, so here it is accepted and changes nothing.
    flash_block: Optional[int] = None
    num_experts: int = 0
    capacity_factor: float = 2.0
    remat: bool = True
    remat_policy: str = "full"
    logits_bf16: bool = False
    loss_chunk: int = 0

    def __post_init__(self):
        if self.n_heads is None:
            n = max(1, self.d_model // 128)
            while self.d_model % n:
                n -= 1
            object.__setattr__(self, "n_heads", n)
        if self.num_experts and not self.ep_axis:
            raise ValueError(
                "num_experts > 0 requires ep_axis (the expert-parallel mesh "
                "axis the MoE all_to_all routes over)")
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got "
                f"{self.remat_policy!r}")
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk must be >= 0, got {self.loss_chunk}")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model ({self.d_model}) must be divisible "
                             f"by n_heads ({self.n_heads})")


def _is_moe(cfg: TransformerConfig, i: int) -> bool:
    return bool(cfg.num_experts) and i % 2 == 1


def param_specs(cfg: TransformerConfig) -> Dict:
    """The partition spec of every parameter, the tree of JAX's
    ``param_specs`` with each ``PartitionSpec`` a tuple
    (``parallel.mesh``): Q/K/V and ``wi`` split on their output columns
    over 'tp' (column-parallel), ``wo`` and ``wo_mlp`` on their input
    rows (row-parallel: one psum per block), a MoE's experts over 'ep',
    everything else replicated (dp and sp shard data, not
    parameters)."""
    tp, ep = cfg.tp_axis, cfg.ep_axis
    layers = []
    for i in range(cfg.n_layers):
        spec = {"ln1": (), "ln2": (),
                "wq": (None, tp), "wk": (None, tp), "wv": (None, tp),
                "wo": (tp, None)}
        if _is_moe(cfg, i):
            spec["moe"] = {"router": (), "wi": (ep, None, None),
                           "wo": (ep, None, None)}
        else:
            spec.update(wi=(None, tp), wo_mlp=(tp, None))
        layers.append(spec)
    return {"embed": (), "pos": (), "ln_f": (), "layers": layers}


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None) -> Dict:
    """The parameter tree of the JAX ``init_params`` (same names, shapes
    and scales; a MoE layer holds a ``moe`` subtree in place of ``wi``
    and ``wo_mlp``), fp32 on the CPU, drawn from ``generator``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5

    def dense(shape, s):
        return torch.randn(shape, generator=generator,
                           dtype=torch.float32) * s

    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": torch.ones(d), "ln2": torch.ones(d),
                 "wq": dense((d, d), scale), "wk": dense((d, d), scale),
                 "wv": dense((d, d), scale), "wo": dense((d, d), scale)}
        if _is_moe(cfg, i):
            # Every expert at init: the global tree, cut over 'ep' later.
            layer["moe"] = moe_init(generator, num_experts=cfg.num_experts,
                                    experts_per_shard=cfg.num_experts,
                                    features=d, hidden=f)
        else:
            layer.update(wi=dense((d, f), scale),
                         wo_mlp=dense((f, d), f ** -0.5))
        layers.append(layer)
    return {"embed": dense((cfg.vocab, d), 1.0),
            "pos": dense((cfg.max_seq, d), 0.02),
            "ln_f": torch.ones(d), "layers": layers}


def _layernorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * g).to(x.dtype)


def _use_flash(cfg: TransformerConfig, x: torch.Tensor, s: int) -> bool:
    """The flash kernels for ``s`` attended tokens: as ``cfg.use_flash``
    says, else on CUDA from FLASH_MIN_SEQ at any dtype, as JAX's policy
    takes its compiled kernels on the TPU from 1024."""
    if cfg.use_flash is not None:
        return cfg.use_flash
    return x.is_cuda and s >= FLASH_MIN_SEQ


def _local_heads(cfg: TransformerConfig, tp_n: int) -> int:
    if cfg.n_heads % tp_n:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must be divisible by the tensor-"
            f"parallel axis size ({tp_n})")
    return cfg.n_heads // tp_n


def _attention(q, k, v, cfg: TransformerConfig,
               mesh: Optional[DeviceMesh]):
    s = q.shape[1]
    if cfg.sp_axis and cfg.sp_impl == "ulysses":
        # The local attention runs over the whole sequence, so the auto
        # policy compares s * sp.
        flash = _use_flash(cfg, q, s * axis_size(mesh, cfg.sp_axis))
        return ulysses_attention(q, k, v, mesh=mesh, axis=cfg.sp_axis,
                                 causal=True, use_flash=flash)
    flash = _use_flash(cfg, q, s)
    if cfg.sp_axis:
        # Each ring step attends a q shard to a kv shard, so the policy
        # keys on the shard length.
        return ring_attention(q, k, v, mesh=mesh, axis=cfg.sp_axis,
                              causal=True, use_flash=flash)
    if flash:
        return flash_attention(q, k, v, True)
    return full_attention(q, k, v, causal=True)


def _moe(p: Dict[str, torch.Tensor], y: torch.Tensor,
         cfg: TransformerConfig, mesh: Optional[DeviceMesh],
         drops: Optional[list]) -> torch.Tensor:
    """The MoE MLP of a block. Under 'tp' each tp rank routes its 1/tp of
    the tokens, so every parameter's gradient stays a partial sum over
    'tp', as the train step's reduction rule wants; an ``all_gather``
    joins the outputs (its backward is a psum_scatter)."""
    b, s, d = y.shape
    tokens = y.reshape(b * s, d)
    tp_n = axis_size(mesh, cfg.tp_axis)
    if tp_n > 1:
        t_local = tokens.shape[0] // tp_n
        i = axis_index(mesh, cfg.tp_axis)
        tokens = tokens[i * t_local:(i + 1) * t_local]
    out = moe_apply(p, tokens, num_experts=cfg.num_experts,
                    capacity_factor=cfg.capacity_factor, mesh=mesh,
                    axis=cfg.ep_axis,
                    act=functools.partial(F.gelu, approximate="tanh"),
                    dtype=cfg.dtype, drops=drops)
    if tp_n > 1:
        out = all_gather(out, mesh, cfg.tp_axis, dim=0)
    return out.reshape(b, s, d)


def _block(p: Dict, x: torch.Tensor, cfg: TransformerConfig,
           mesh: Optional[DeviceMesh] = None,
           drops: Optional[list] = None) -> torch.Tensor:
    """One pre-norm decoder block of this rank; x is [B, S_local, d] in
    cfg.dtype. Under 'tp' the Q/K/V slices give the local heads and the
    out-projections' partial sums meet in a psum. A block whose ``p``
    holds a ``moe`` subtree runs :func:`_moe` as its MLP."""
    d = cfg.d_model
    h = _local_heads(cfg, axis_size(mesh, cfg.tp_axis))
    hd = d // cfg.n_heads
    dt = cfg.dtype
    y = _layernorm(x, p["ln1"])
    b, s, _ = y.shape
    q = (y @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (y @ p["wk"].to(dt)).reshape(b, s, h, hd)
    v = (y @ p["wv"].to(dt)).reshape(b, s, h, hd)
    attn = _attention(q, k, v, cfg, mesh)
    o = attn.reshape(b, s, h * hd) @ p["wo"].to(dt)
    if cfg.tp_axis:
        o = psum(o, mesh, cfg.tp_axis)   # row-parallel out-projection
    x = x + o
    y = _layernorm(x, p["ln2"])
    if "moe" in p:
        return x + _moe(p["moe"], y, cfg, mesh, drops)
    hmid = F.gelu(y @ p["wi"].to(dt), approximate="tanh")
    m = hmid @ p["wo_mlp"].to(dt)
    if cfg.tp_axis:
        m = psum(m, mesh, cfg.tp_axis)
    return x + m


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of the
    matmuls without batch dimensions (every ``x @ W``; the attention's
    batched products are not among them), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def project_logits(embed: torch.Tensor, h: torch.Tensor,
                   cfg: TransformerConfig) -> torch.Tensor:
    """The tied output projection, fp32 logits: in ``cfg.dtype`` then
    cast with ``cfg.logits_bf16``, else in fp32."""
    if cfg.logits_bf16:
        return (h @ embed.to(cfg.dtype).T).float()
    return h.float() @ embed.T


class _Layer(nn.Module):
    """A layer's parameters; a subtree (``moe``) is a child module."""

    def __init__(self, params: Dict):
        super().__init__()
        for name, t in params.items():
            if isinstance(t, dict):
                self.add_module(name, _Layer(t))
            else:
                self.register_parameter(name, nn.Parameter(t.clone()))

    def tree(self) -> Dict:
        """The parameters as the nested dict ``_block`` takes."""
        out = dict(self.named_parameters(recurse=False))
        out.update((name, m.tree()) for name, m in self.named_children())
        return out


class Transformer(nn.Module):
    """The flagship LM as an ``nn.Module``. It runs on CUDA unless
    ``device="cpu"`` is passed; ``params`` (a tree as from
    :func:`init_params`) defaults to one drawn from ``generator``.

    When ``cfg`` names ``tp_axis``, ``sp_axis`` or ``ep_axis``, ``mesh``
    must hold those axes, and the model is this rank's shard: ``params``
    is then this rank's slice of the tree (``parallel.mesh.shard_tree``
    under :func:`param_specs`), and a tree drawn from ``generator`` is
    the global one, cut to this rank's slice.

    ``moe_drops``, when set to a list, receives each MoE layer's count
    of dropped tokens at every forward (0-d tensors on the device; a
    remat recompute adds its own)."""

    def __init__(self, cfg: TransformerConfig, *,
                 params: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[DeviceMesh] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.moe_drops: Optional[list] = None
        for axis in (cfg.tp_axis, cfg.sp_axis, cfg.ep_axis):
            if axis and (mesh is None or axis not in mesh.mesh_dim_names):
                raise ValueError(
                    f"the config's mesh axis {axis!r} is not an axis of "
                    f"the model's mesh "
                    f"({None if mesh is None else mesh.mesh_dim_names})")
        if cfg.tp_axis:
            _local_heads(cfg, axis_size(mesh, cfg.tp_axis))
        if params is None:
            params = init_params(cfg, generator)
            if cfg.tp_axis or cfg.ep_axis:
                params = shard_tree(params, param_specs(cfg), *place(mesh))
        self.embed = nn.Parameter(params["embed"].clone())
        self.pos = nn.Parameter(params["pos"].clone())
        self.ln_f = nn.Parameter(params["ln_f"].clone())
        self.layers = nn.ModuleList(_Layer(lp) for lp in params["layers"])
        self.to(dev)

    def checkpoint_layouts(self, shapes=None) -> Dict:
        """``{key in state_dict(): LeafLayout}`` of the parameters a mesh
        splits across ranks (``parallel.mesh.spec_layout`` under
        :func:`param_specs`): the sharded checkpoint engine writes each
        block once and restores this rank's. ``shapes`` is taken for
        the protocol's sake; every parameter exists from the start."""
        if self.mesh is None:
            return {}
        from ..checkpoint.layout import dtype_name
        from ..parallel.mesh import place, spec_axes, spec_layout, spec_of
        sizes = place(self.mesh)[0]
        specs = param_specs(self.cfg)
        out = {}
        for name, p in self.named_parameters():
            spec = spec_of(specs, name)
            shape = list(p.shape)
            for d, entry in enumerate(spec):
                for a in spec_axes((entry,)):
                    shape[d] *= sizes[a]
            ll = spec_layout(shape, dtype_name(p), spec, self.mesh)
            if not ll.replicated:
                out[f"[{name!r}]"] = ll
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def apply_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S_local] int -> hidden [B, S_local, d] after the
        final norm. Under 'sp' this rank's tokens start at position
        ``axis_index(sp) * S_local``."""
        cfg = self.cfg
        dt = cfg.dtype
        s = tokens.shape[1]
        start = axis_index(self.mesh, cfg.sp_axis) * s if cfg.sp_axis else 0
        x = self.embed.to(dt)[tokens] + self.pos[start:start + s].to(dt)
        remat = {}
        if cfg.remat_policy == "dots":
            remat["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
        for layer in self.layers:
            p = layer.tree()
            if cfg.remat:
                x = checkpoint(_block, p, x, cfg, self.mesh, self.moe_drops,
                               use_reentrant=False, **remat)
            else:
                x = _block(p, x, cfg, self.mesh, self.moe_drops)
        return _layernorm(x, self.ln_f)

    def _project_logits(self, h: torch.Tensor) -> torch.Tensor:
        return project_logits(self.embed, h, self.cfg)

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:  # noqa: A003
        """Logits [B, S, vocab] in fp32. (Shadows ``nn.Module.apply(fn)``
        to keep the JAX package's name for the forward pass.)"""
        return self._project_logits(self.apply_hidden(tokens))

    forward = apply

    def loss_fn(self, tokens: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
        """Next-token cross-entropy, mean over this rank's tokens. With
        ``cfg.loss_chunk`` the projection and log-softmax run over
        sequence chunks under checkpointing, so the fp32 [B, S, V]
        logits never exist at once."""
        cfg = self.cfg
        if not cfg.loss_chunk:
            logits = self.apply(tokens)
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1))
        h = self.apply_hidden(tokens)
        b, s, _ = h.shape
        chunk = min(cfg.loss_chunk, s)
        if s % chunk:
            raise ValueError(
                f"loss_chunk ({chunk}) must divide the local sequence ({s})")

        def chunk_nll(hs, tg):
            logits = self._project_logits(hs)
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   tg.reshape(-1), reduction="sum")

        total = sum(
            checkpoint(chunk_nll, h[:, c * chunk:(c + 1) * chunk],
                       targets[:, c * chunk:(c + 1) * chunk],
                       use_reentrant=False)
            for c in range(s // chunk))
        return total / (b * s)
