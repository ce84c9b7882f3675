"""ElasticState — commit/rollback training state that survives worker loss.

Counterpart of ``horovod_tpu/elastic/state.py``. Built on the checkpoint
convention (``utils/checkpoint.py``: rank-0 atomic save,
broadcast-on-restore) and extended with the elastic contract:

  commit(step)   durably record the wrapped trees as of ``step``:
                 rank 0 writes ``<dir>/<step>.pkl`` then atomically
                 repoints ``<dir>/LATEST``; every rank keeps an
                 in-memory host copy for I/O-free rollback; a barrier
                 collective keeps ranks from racing past an unfinished
                 commit.
  rollback()     restore the wrapped trees from the last in-memory
                 commit (same process — e.g. after a caught
                 WorkerFailure, before re-entering the step loop).
  restore()      cold-start path for a (re)joined process: load the
                 LATEST commit from disk on rank 0 and broadcast it so
                 every rank resumes from identical state. With no commit
                 on disk the *initial* trees are broadcast from rank 0
                 instead (Horovod's broadcast-on-start recipe).

Backends (``backend=``):

  ``"pickle"``   the default — the rank-0 single-pickle convention above.
  ``"sharded"``  rides :class:`~horovod_tpu_torch.checkpoint.
                 CheckpointEngine`: each process writes only its shards
                 (a ZeRO-1 optimizer's moments, a tensor-parallel
                 model's blocks), serialization happens on a background
                 thread (``commit`` returns after the host copy; the
                 engine's two-phase manifest/LATEST flip keeps every
                 instant crash-consistent), and ``restore`` reads from
                 the shared checkpoint directory on every rank — only
                 the resolved step is broadcast. Requires a directory on
                 a filesystem all ranks share.

Both backends keep the last N commits (``HOROVOD_TPU_CHECKPOINT_KEEP``,
default 10, 0 = unlimited; the commit ``LATEST`` names is never
deleted). The state directory defaults to ``HOROVOD_TPU_ELASTIC_DIR``;
without one, commits are memory-only (rollback works, a relaunched
worker starts from the initial trees).

A named tree is a tree of tensors (dicts, lists, tuples), a plain dict
such as a loader cursor, an ``nn.Module`` or an optimizer (a
``torch.optim.Optimizer``, a ``DistributedOptimizer``, a
``Zero1Optimizer``). A module or optimizer commits its ``state_dict()``
and is restored **in place** through ``load_state_dict``, so a train
step keeps its parameter objects and their hooks. An object with
``checkpoint_layouts()`` (``Zero1Optimizer``, a ``Transformer`` on a
mesh) writes and restores only this rank's blocks on the sharded
backend::

    state = ElasticState(model=model, optimizer=opt,
                         data=loader.commit_cursor())
    state.restore()
    for step in range(state.step, total_steps):
        loss = train_step(model, opt, *next(loader).data)
        if (step + 1) % commit_every == 0:
            state.data = loader.commit_cursor()
            state.commit(step + 1)

``state.step`` is the step index training should resume from — 0 before
any commit, the committed ``step`` argument after.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import topology as _topo
from ..checkpoint.reader import state_template
from ..checkpoint.writer import fsync_dir
from ..utils.checkpoint import host_copy, restore_checkpoint, \
    save_checkpoint
from ..utils.env import checkpoint_keep

_log = logging.getLogger(__name__)

ELASTIC_DIR_ENV = "HOROVOD_TPU_ELASTIC_DIR"
_LATEST = "LATEST"
_BACKENDS = ("pickle", "sharded")
_PKL_RE = re.compile(r"^(\d+)\.pkl$")


def _stateful(x: Any) -> bool:
    """A module or optimizer: committed through ``state_dict()``."""
    return isinstance(x, (nn.Module, torch.optim.Optimizer)) or (
        hasattr(x, "state_dict") and hasattr(x, "load_state_dict"))


def _like_devices(new: Any, old: Any) -> Any:
    """``new`` with each tensor moved to the device of the tensor at the
    same place in ``old`` (a plain tree keeps its devices through a
    rollback or a pickle restore)."""
    if isinstance(new, torch.Tensor):
        return new.to(old.device) if isinstance(old, torch.Tensor) else new
    if isinstance(new, dict) and isinstance(old, dict):
        out = new.copy()
        for k, v in new.items():
            out[k] = _like_devices(v, old.get(k))
        return out
    if isinstance(new, (list, tuple)) and isinstance(old, (list, tuple)) \
            and len(new) == len(old) and not hasattr(type(new), "_fields"):
        return type(new)(_like_devices(a, b) for a, b in zip(new, old))
    return new


class ElasticState:
    """Named trees, modules and optimizers with commit/rollback/restore
    semantics."""

    def __init__(self, directory: Optional[str] = None,
                 backend: str = "pickle",
                 keep_last: Optional[int] = None, **trees: Any):
        if not trees:
            raise ValueError(
                "ElasticState needs at least one named tree, e.g. "
                "ElasticState(model=model, optimizer=opt)")
        if backend not in _BACKENDS:
            raise ValueError(
                f"unknown checkpoint backend {backend!r}; "
                f"choose from {_BACKENDS}")
        # All bookkeeping attrs go through object.__setattr__ so the
        # tree-name __setattr__ below stays unambiguous.
        object.__setattr__(self, "_dir",
                           directory or os.environ.get(ELASTIC_DIR_ENV))
        object.__setattr__(self, "_backend", backend)
        object.__setattr__(self, "_keep",
                           checkpoint_keep() if keep_last is None
                           else int(keep_last))
        object.__setattr__(self, "_engine", None)
        object.__setattr__(self, "_trees", dict(trees))
        object.__setattr__(self, "_committed", None)
        object.__setattr__(self, "step", 0)
        if backend == "sharded" and not self._dir:
            raise ValueError(
                "backend='sharded' needs a checkpoint directory on a "
                "shared filesystem (directory= or "
                f"{ELASTIC_DIR_ENV})")

    # ----------------------------------------------------- tree access

    def __getattr__(self, name: str) -> Any:
        trees = object.__getattribute__(self, "_trees")
        if name in trees:
            return trees[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "step":
            object.__setattr__(self, name, value)
            return
        self._trees[name] = value

    def tree_names(self):
        return tuple(self._trees)

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def engine(self):
        """The sharded backend's :class:`CheckpointEngine`."""
        return self._get_engine()

    # ------------------------------------------------------- internals

    def _latest_path(self) -> Optional[str]:
        return os.path.join(self._dir, _LATEST) if self._dir else None

    def _state(self) -> Dict[str, Any]:
        """Every tree as committed: an object's ``state_dict()``."""
        return {name: t.state_dict() if _stateful(t) else t
                for name, t in self._trees.items()}

    def _snapshot(self) -> Dict[str, Any]:
        # Host copies: the next optimizer step overwrites parameters and
        # moments in place, so the rollback copy must not alias them.
        return {"step": int(self.step), "trees": host_copy(self._state())}

    def _layouts(self, shapes: Optional[Dict[str, tuple]] = None):
        """The sharded leaves' layouts, keyed in the committed tree:
        those of every object with ``checkpoint_layouts``. ``shapes``
        (a manifest's saved shapes) lets a fresh object name the leaves
        its state does not hold yet."""
        out = {}
        for name, t in self._trees.items():
            if not hasattr(t, "checkpoint_layouts"):
                continue
            pre = f"[{name!r}]"
            sub = None if shapes is None else {
                k[len(pre):]: s for k, s in shapes.items()
                if k.startswith(pre)}
            for k, ll in t.checkpoint_layouts(sub).items():
                out[pre + k] = ll
        return out

    def _is_rank0(self) -> bool:
        return not _topo.is_initialized() or _topo.rank() == 0

    def _process_count(self) -> int:
        return _topo.size() if _topo.is_initialized() else 1

    def _adopt(self, payload: Dict[str, Any]) -> None:
        """Take ``payload``'s trees: objects load theirs in place, plain
        trees are replaced (tensors on their devices as before)."""
        for name, tree in payload["trees"].items():
            cur = self._trees.get(name)
            if _stateful(cur):
                cur.load_state_dict(tree)
            else:
                self._trees[name] = _like_devices(tree, cur)
        object.__setattr__(self, "step", int(payload["step"]))

    def _get_engine(self):
        if self._engine is None:
            from ..checkpoint import CheckpointEngine
            object.__setattr__(
                self, "_engine",
                CheckpointEngine(self._dir, keep_last=self._keep))
        return self._engine

    # ------------------------------------------------------- contract

    def commit(self, step: Optional[int] = None,
               block: bool = False) -> "ElasticState":
        """Durably record the current trees as of ``step``.

        Ordering guarantee (both backends): the LATEST pointer is
        repointed only after the commit data is fully on disk, so a
        crash at any instant leaves LATEST naming a complete commit.

        Pickle backend: rank 0 serializes the whole state and the
        closing barrier means no rank runs past a commit its peers have
        not durably finished. Sharded backend: ``commit`` returns after
        the host copy; serialization, the cross-rank commit barrier and
        the LATEST flip run on the engine's background thread (joined by
        the next commit, ``wait()``, or ``block=True``) — until the flip,
        LATEST keeps naming the previous complete commit."""
        if step is not None:
            object.__setattr__(self, "step", int(step))
        snap = self._snapshot()
        object.__setattr__(self, "_committed", snap)
        from ..observability import flight_recorder as _flight
        _flight.recorder().note("checkpoint",
                                ("commit", int(self.step), self._backend))
        if self._backend == "sharded":
            # The engine copies from the host snapshot (memory to
            # memory), not from the device a second time.
            self._get_engine().save(snap["trees"], self.step,
                                    extra={"elastic": True}, block=block,
                                    layouts=self._layouts())
            return self
        if self._dir and self._is_rank0():
            os.makedirs(self._dir, exist_ok=True)
            save_checkpoint(snap, self._dir, step=self.step)
            tmp = self._latest_path() + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self.step))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._latest_path())
            fsync_dir(self._dir)
            self._gc_pickle()
        self._barrier(f"elastic.commit.{self.step}")
        return self

    def wait(self) -> "ElasticState":
        """Join an in-flight sharded commit (no-op for pickle)."""
        if self._engine is not None:
            self._engine.wait()
        return self

    def rollback(self) -> "ElasticState":
        """Restore trees from the last in-memory commit (no I/O). With
        no commit yet, this is a no-op on the initial trees."""
        if self._committed is not None:
            self._adopt(host_copy(self._committed))
        return self

    def restore(self, step: Optional[int] = None) -> "ElasticState":
        """(Re)join path: adopt the last durable commit — or the initial
        trees — identically on every rank.

        Rank 0 resolves ``step`` (explicit, else LATEST, else none);
        with the pickle backend the broadcast built into
        ``restore_checkpoint`` ships the payload to all ranks. The
        sharded backend instead has EVERY rank read from the shared
        directory through the engine (the manifest resharding path) —
        only the resolved step is broadcast. A corrupt shard makes the
        engine fall back to an older commit, and ``step`` is then that
        commit's."""
        resolved = step
        if resolved is None and self._dir and self._is_rank0():
            if self._backend == "sharded":
                resolved = self._get_engine().latest_step()
            else:
                latest = self._latest_path()
                if latest and os.path.exists(latest):
                    with open(latest) as f:
                        resolved = int(f.read().strip())
        multi = self._process_count() > 1
        if multi:
            # Every rank must agree whether a commit exists before anyone
            # enters the conditional load (a split decision deadlocks the
            # broadcast). Rank 0 announces the resolved step.
            from ..optimizer import broadcast_object
            resolved = broadcast_object(resolved, root_rank=0,
                                        name="elastic.restore.step")
        if resolved is None:
            if multi:
                from ..optimizer import broadcast_object
                self._adopt(broadcast_object(self._snapshot(), root_rank=0,
                                             name="elastic.restore.init"))
            object.__setattr__(self, "_committed", self._snapshot())
            return self
        if self._backend == "sharded":
            self._restore_sharded(int(resolved))
        else:
            payload = restore_checkpoint(self._dir, step=int(resolved),
                                         broadcast=multi)
            self._adopt(payload)
        object.__setattr__(self, "_committed", self._snapshot())
        _log.info("restored elastic state at step %d", self.step)
        return self

    def _restore_sharded(self, step: int) -> None:
        engine = self._get_engine()
        template = {name: state_template(t) if _stateful(t) else t
                    for name, t in self._trees.items()}

        def layouts(man):
            return self._layouts({e["key"]: tuple(e["shape"])
                                  for e in man["leaves"]})

        trees = engine.restore(step=step, template=template,
                               layouts=layouts, grow=True)
        self._adopt({"step": engine.restored_step, "trees": trees})

    # -------------------------------------------------------- plumbing

    def _gc_pickle(self) -> None:
        """Keep-last-N retention for the pickle backend (rank 0, after
        the LATEST flip). Never deletes the step LATEST names."""
        if self._keep <= 0:
            return
        steps = []
        for name in os.listdir(self._dir):
            m = _PKL_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        steps.sort()
        keep = set(steps[-self._keep:])
        keep.add(int(self.step))
        for s in steps:
            if s not in keep:
                try:
                    os.remove(os.path.join(self._dir, f"{s}.pkl"))
                except OSError:
                    pass

    def _barrier(self, name: str) -> None:
        """Commit barrier: a tiny allreduce every rank must enter. Only
        meaningful (and only run) across processes."""
        if self._process_count() <= 1:
            return
        from ..ops import collective as _coll
        _coll.allreduce(torch.zeros(1, device=_topo.device()),
                        average=False, name=name)
