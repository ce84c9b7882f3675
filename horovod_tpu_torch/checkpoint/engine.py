"""CheckpointEngine — sharded, asynchronous, crash-atomic commits.

Counterpart of ``horovod_tpu/checkpoint/engine.py``, on the same files:
a tree saved here and by the JAX engine gives the same shard bytes and
``manifest.json``, and either package restores the other's commits.

The train-loop contract:

  ``save(tree, step)``  copies this process's shards device->host (a
  blocking copy: the next optimizer step overwrites parameters and
  moments in place) and returns; serialization, fsync, the commit
  barrier, the rank-0 manifest write and the LATEST flip all happen on
  a background thread. The loop blocks only for the snapshot, plus, if
  the *previous* save is still in flight, for joining it. ``blocked_s``
  sums the seconds the loop spent inside ``save``; ``save_s`` is the
  last commit's seconds from ``save`` to its LATEST flip.

Two-phase commit (crash at ANY instant leaves the previous complete
commit restorable):

  phase 1   every process writes its shard files + crc32 sidecars into
            ``<root>/step-<N>/``; a barrier confirms all of phase 1.
  phase 2   rank 0 assembles ``manifest.json`` from the shared layouts
            and the sidecar checksums, writes it atomically, then flips
            ``<root>/LATEST`` (atomic rename + dir fsync). A second
            barrier keeps any rank from racing past a commit its peers
            have not observed.

The barrier is a named allreduce through the collective engine
(``ops/collective.py``), submitted from the writer thread: the engine
orders ops by name through rank 0, so it neither waits on nor reorders
the gradient buckets the main thread submits meanwhile.

Restore walks committed steps newest-first: a :exc:`CorruptShardError`
in the requested step logs, counts, and falls back to the previous
commit (``strict=True`` raises instead); ``restored_step`` names the
step that was read. ``restore_addressable`` is the elastic-resharding
path — each rank reads only the shard-file spans overlapping its *new*
layout's blocks.

Retention: ``keep_last`` committed steps survive (default
``HOROVOD_TPU_CHECKPOINT_KEEP``, 0 = unlimited); GC runs on rank 0
after each commit and never touches the step LATEST names.

The engine records JAX's ``hvdtpu_checkpoint_*`` families (bytes and
shards written, save and restore seconds, seconds the loop blocked,
GC'd steps, corrupt shards, the last committed step) and a
flight-recorder ``checkpoint`` note per commit.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..observability import flight_recorder as _flight
from ..observability import registry as _obs
from ..utils import env as _env
from . import manifest as _manifest
from .fingerprint import fingerprint_leaf
from .layout import (LeafLayout, Shard, full_index, shard_data, tree_keys,
                     tree_layout)
from .reader import CorruptShardError, read_block, read_tree
from .writer import AsyncWriter, atomic_write_bytes, read_sidecar, \
    write_shard

_log = logging.getLogger(__name__)

Layouts = Dict[str, LeafLayout]


def _metrics():
    """JAX's ``hvdtpu_checkpoint_*`` families
    (``horovod_tpu/checkpoint/engine.py:58-88``)."""
    r = _obs.registry()
    return {
        "bytes": r.counter(
            "hvdtpu_checkpoint_bytes_written_total",
            "Checkpoint bytes written by this process (payload + "
            "sidecars + manifest)").labels(),
        "shards": r.counter(
            "hvdtpu_checkpoint_shards_written_total",
            "Shard files written by this process").labels(),
        "save": r.histogram(
            "hvdtpu_checkpoint_save_seconds",
            "End-to-end save duration: snapshot through commit",
            buckets=_obs.LATENCY_BUCKETS).labels(),
        "blocked": r.counter(
            "hvdtpu_checkpoint_blocked_seconds_total",
            "Seconds the training loop was blocked inside save() — "
            "snapshot plus joining a previous in-flight write"),
        "restore": r.histogram(
            "hvdtpu_checkpoint_restore_seconds",
            "Restore duration", buckets=_obs.LATENCY_BUCKETS).labels(),
        "gc": r.counter(
            "hvdtpu_checkpoint_gc_steps_total",
            "Committed steps deleted by keep-last-N retention"),
        "corrupt": r.counter(
            "hvdtpu_checkpoint_corrupt_shards_total",
            "Shards that failed crc32/shape verification on restore"),
        "last_step": r.gauge(
            "hvdtpu_checkpoint_last_committed_step",
            "Step of the last commit this process finished"),
    }


def verify_fingerprint(key: str, arr, man: dict, where: str = "") -> None:
    """Recompute one leaf's value fingerprint and check it against the
    manifest. No-op for manifests without fingerprints or for keys the
    manifest does not digest. Raises :exc:`CorruptShardError` on
    mismatch — the shard bytes matched their crc32, but the VALUES are
    not what was saved (corruption upstream of serialization)."""
    fps = man.get("fingerprints") or {}
    want = fps.get(key)
    if want is None:
        return
    got = fingerprint_leaf(key, arr)
    if (got[0] != float(want[0]) or got[1] != int(want[1])
            or got[2] != int(want[2])):
        raise CorruptShardError(
            os.path.join(where, key) if where else key,
            f"value fingerprint mismatch: got [norm={got[0]!r}, "
            f"crc={got[1]}, n={got[2]}], manifest says [norm="
            f"{float(want[0])!r}, crc={int(want[1])}, n={int(want[2])}]")


class SaveHandle:
    """Ticket for one in-flight save; resolved by engine.wait()."""

    def __init__(self, step: int, directory: str):
        self.step = step
        self.directory = directory
        self.committed = False


class CheckpointEngine:
    """Sharded async checkpoint engine over one root directory.

    ``process_index`` / ``process_count`` default to this rank and the
    world size (one process standalone without ``init()``); tests pass
    them explicitly, with each simulated process's ``layouts``, to save
    a multi-process layout from one process. ``barrier`` defaults to a
    tiny named allreduce when the world has more than one rank and a
    no-op otherwise.
    """

    def __init__(self, directory: str, *,
                 keep_last: Optional[int] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 barrier: Optional[Callable[[str], None]] = None,
                 mesh_axes: Optional[Dict[str, int]] = None):
        self.directory = directory
        self.keep_last = _env.checkpoint_keep() if keep_last is None \
            else int(keep_last)
        pi, pc = self._topology_defaults()
        self.process_index = pi if process_index is None \
            else int(process_index)
        self.process_count = pc if process_count is None \
            else int(process_count)
        self.mesh_axes = dict(mesh_axes or {})
        self._barrier = barrier if barrier is not None \
            else self._default_barrier
        self._writer = AsyncWriter()
        self._inflight: Optional[SaveHandle] = None
        self.blocked_s = 0.0
        self._m = _metrics()
        self.save_s: Optional[float] = None
        self.restore_s: Optional[float] = None
        self.restored_step: Optional[int] = None

    # ------------------------------------------------------------ save

    def save(self, tree: Any, step: int, *, extra: Optional[dict] = None,
             block: bool = False, layouts: Optional[Layouts] = None
             ) -> SaveHandle:
        """Snapshot this process's shards and commit asynchronously.

        ``layouts`` gives the leaves sharded across processes (their
        value in ``tree`` is this process's block); every other leaf is
        replicated and written by process 0. Returns as soon as the
        device->host snapshot is done (and any previous save is joined).
        ``block=True`` waits for the commit — equivalent to ``save(...);
        wait()``.
        """
        t0 = time.perf_counter()
        self.wait()  # back-pressure: join the previous in-flight write
        layouts = tree_layout(tree, layouts)
        values = dict(tree_keys(tree))
        # Device->host snapshot of OUR shards only (the blocking part),
        # each with whether it is the whole leaf.
        mine: List[Tuple[str, str, Any, bool]] = []
        for i, (key, ll) in enumerate(layouts.items()):
            for j, shard in enumerate(ll.shards):
                if shard.process != self.process_index:
                    continue
                mine.append((_manifest.shard_filename(i, j), key,
                             shard_data(values[key], shard, ll),
                             shard.index == full_index(ll.shape)))
        step = int(step)
        sdir = _manifest.step_dir(self.directory, step)
        os.makedirs(sdir, exist_ok=True)
        handle = SaveHandle(step, sdir)
        self._inflight = handle
        pcount = self.process_count
        extra = dict(extra or {})

        def _job():
            self._write_and_commit(handle, layouts, mine, pcount, extra,
                                   t0)

        self._writer.submit(_job)
        blocked = time.perf_counter() - t0
        self.blocked_s += blocked
        self._m["blocked"].inc(blocked)
        if block:
            self.wait()
        return handle

    def _write_and_commit(self, handle: SaveHandle, layouts: Layouts,
                          mine: List[Tuple[str, str, Any, bool]],
                          pcount: int, extra: dict, t0: float) -> None:
        # Per-leaf VALUE fingerprints for the manifest: rank 0 writes the
        # manifest and digests every leaf it holds whole, from the
        # snapshot the shards come from (a later in-memory corruption
        # cannot retroactively "verify"), here off the train loop.
        fps = None
        if self.process_index == 0:
            fps = {key: fingerprint_leaf(key, arr)
                   for _, key, arr, whole in mine if whole}
        written = 0
        for filename, _, arr, _ in mine:
            crc, nbytes = write_shard(handle.directory, filename, arr)
            written += nbytes
        self._m["shards"].inc(len(mine))
        # Phase boundary: every rank's shards durable before anyone
        # writes (or trusts) a manifest.
        self._barrier(f"ckpt.shards.{handle.step}")
        if self.process_index == 0:
            written += self._commit_rank0(handle, layouts, pcount, extra,
                                          fps)
        self._barrier(f"ckpt.commit.{handle.step}")
        handle.committed = True
        self.save_s = time.perf_counter() - t0
        self._m["bytes"].inc(written)
        self._m["last_step"].set(handle.step)
        self._m["save"].observe(self.save_s)
        _flight.recorder().note("checkpoint",
                                ("commit", handle.step, "sharded"))

    def _commit_rank0(self, handle: SaveHandle, layouts: Layouts,
                      pcount: int, extra: dict,
                      fps: Optional[Dict[str, list]] = None) -> int:
        shard_meta: Dict[str, List[dict]] = {}
        for i, (key, ll) in enumerate(layouts.items()):
            metas = []
            for j in range(len(ll.shards)):
                filename = _manifest.shard_filename(i, j)
                crc, nbytes = read_sidecar(handle.directory, filename)
                metas.append({"file": filename, "crc32": crc,
                              "nbytes": nbytes})
            shard_meta[key] = metas
        man = _manifest.manifest_dict(
            handle.step, pcount, layouts, shard_meta,
            mesh_axes=self.mesh_axes, extra=extra, fingerprints=fps)
        data = _manifest.dumps(man)
        atomic_write_bytes(
            os.path.join(handle.directory, _manifest.MANIFEST), data)
        # THE commit point: LATEST now names a fully durable step.
        atomic_write_bytes(os.path.join(self.directory, _manifest.LATEST),
                           (_manifest.step_dirname(handle.step) + "\n")
                           .encode())
        self._gc(handle.step)
        return len(data)

    def wait(self) -> Optional[SaveHandle]:
        """Join the in-flight save (no-op when idle); re-raises a
        background write failure."""
        handle, self._inflight = self._inflight, None
        self._writer.wait()
        return handle

    @property
    def busy(self) -> bool:
        return self._writer.busy

    def close(self) -> None:
        self.wait()
        self._writer.close()

    # --------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        return _manifest.read_latest(self.directory)

    def steps(self) -> List[int]:
        return _manifest.list_steps(self.directory)

    def restore(self, step: Optional[int] = None, *, template: Any = None,
                strict: bool = False,
                layouts: Union[Layouts, Callable[[dict], Layouts],
                               None] = None,
                grow: bool = False) -> Any:
        """Full-tree restore (every leaf assembled to global shape,
        except the sharded leaves ``layouts`` names: this process's
        block of each). ``layouts`` may be a function of the manifest.
        ``template`` and ``grow`` as in :func:`reader.read_tree`.

        Walks candidate steps newest-first starting at ``step`` (default
        LATEST): a corrupt shard counts, logs, and falls back to the
        previous commit unless ``strict``."""
        t0 = time.perf_counter()
        for cand, last in self._candidates(step, strict):
            try:
                man = _manifest.read_manifest(self.directory, cand)
                sdir = _manifest.step_dir(self.directory, cand)
                tree = read_tree(
                    sdir, man, template=template,
                    layouts=layouts(man) if callable(layouts) else layouts,
                    grow=grow,
                    verify=lambda k, v: verify_fingerprint(k, v, man, sdir))
                self.restored_step = cand
                self.restore_s = time.perf_counter() - t0
                self._m["restore"].observe(self.restore_s)
                return tree
            except CorruptShardError as e:
                self._corrupt(e, cand, strict or last)

    def restore_manifest(self, step: Optional[int] = None) -> dict:
        step = self._resolve(step)
        return _manifest.read_manifest(self.directory, step)

    def restore_addressable(self, layouts: Layouts,
                            step: Optional[int] = None, *,
                            process_index: Optional[int] = None,
                            strict: bool = False
                            ) -> Dict[str, List[Tuple[Shard, Any]]]:
        """Resharded restore: read ONLY the saved spans overlapping this
        process's blocks under a NEW target layout (different process
        count / mesh than at save time).

        Returns ``{leaf key: [(target Shard, block array), ...]}`` for
        the shards ``layouts`` assigns to ``process_index`` (default:
        this engine's). Fully-replicated target leaves are returned to
        every process (each reads them from the shared directory)."""
        proc = self.process_index if process_index is None \
            else int(process_index)
        t0 = time.perf_counter()
        for cand, last in self._candidates(step, strict):
            try:
                man = _manifest.read_manifest(self.directory, cand)
                sdir = _manifest.step_dir(self.directory, cand)
                entries = {e["key"]: e for e in man["leaves"]}
                out: Dict[str, List[Tuple[Shard, Any]]] = {}
                for key, ll in layouts.items():
                    if key not in entries:
                        raise KeyError(
                            f"checkpoint step {cand} has no leaf {key!r}")
                    wanted = ll.shards if ll.replicated else \
                        ll.shards_of(proc)
                    blocks = []
                    saved_shape = tuple(
                        int(d) for d in entries[key]["shape"])
                    for shard in wanted:
                        block = read_block(sdir, entries[key],
                                           shard.index or None)
                        # Fingerprint verification needs the WHOLE leaf
                        # value; a resharded read only materializes it
                        # when this block covers the full saved shape.
                        if (not shard.index
                                or tuple((a, b) for a, b in shard.index)
                                == tuple((0, d) for d in saved_shape)):
                            verify_fingerprint(key, block, man, sdir)
                        blocks.append((shard, block))
                    out[key] = blocks
                self.restored_step = cand
                self.restore_s = time.perf_counter() - t0
                self._m["restore"].observe(self.restore_s)
                return out
            except CorruptShardError as e:
                self._corrupt(e, cand, strict or last)

    def _resolve(self, step: Optional[int]) -> int:
        if step is not None:
            return int(step)
        latest = self.latest_step()
        if latest is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.directory!r}")
        return latest

    def _candidates(self, step: Optional[int], strict: bool):
        """(step, is_last_candidate) pairs newest-first: the requested
        step, then — unless strict — every older committed step."""
        start = self._resolve(step)
        if strict:
            return [(start, True)]
        older = [s for s in self.steps() if s < start]
        chain = [start] + sorted(older, reverse=True)
        return [(s, i == len(chain) - 1) for i, s in enumerate(chain)]

    def _corrupt(self, e: CorruptShardError, step: int,
                 is_last: bool) -> None:
        self._m["corrupt"].inc()
        if is_last:
            raise e
        _log.warning("step %d unrestorable (%s); falling back to the "
                     "previous commit", step, e.reason)

    # -------------------------------------------------------------- gc

    def _gc(self, committed_step: int) -> None:
        """Keep the last ``keep_last`` committed steps (rank 0, after a
        successful commit). Never deletes the step LATEST names; also
        sweeps older aborted (manifest-less) step directories."""
        if self.keep_last <= 0:
            return
        latest = self.latest_step()
        committed = self.steps()
        keep = set(committed[-self.keep_last:])
        keep.add(committed_step)
        if latest is not None:
            keep.add(latest)
        floor = min(keep) if keep else committed_step
        for name in os.listdir(self.directory):
            m = _manifest._STEP_RE.match(name)
            if not m:
                continue
            s = int(m.group(1))
            drop = (s in committed and s not in keep) or \
                (s not in committed and s < floor)
            if drop:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                self._m["gc"].inc()

    # -------------------------------------------------------- plumbing

    @staticmethod
    def _topology_defaults() -> Tuple[int, int]:
        from .. import topology as _topo
        if not _topo.is_initialized():
            return 0, 1
        t = _topo.topology()
        return t.rank, t.size

    def _default_barrier(self, name: str) -> None:
        if self.process_count <= 1:
            return
        from .. import topology as _topo
        if not _topo.is_initialized() or _topo.size() <= 1:
            return  # a simulated multi-process layout in one process
        from ..ops import collective as _coll
        dev = _topo.device()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)   # the writer thread's own device
        _coll.allreduce(torch.zeros(1, device=dev), average=False, name=name)
