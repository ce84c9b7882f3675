"""``checkpoint_hook``: the train loop's async save on the sharded engine.

Counterpart of ``checkpoint_hook`` in the JAX package's torch shim
(``horovod_tpu/torch/__init__.py``): the same tree, ``{"model":
model.state_dict(), "optimizer": optimizer.state_dict()}`` as plain
nested dicts of host leaves, so the two write the same manifest and
shard bytes for the same fp32 model. Its leaves are CPU tensor copies,
not numpy arrays, so bf16 and fp16 tensors are taken too (the shim's
``.numpy()`` refuses bf16).
"""

from __future__ import annotations

from typing import Any

import torch


def host_tree(sd: Any) -> Any:
    """A ``state_dict`` as plain dicts and lists of CPU tensor copies
    (other leaves as they are)."""
    if isinstance(sd, torch.Tensor):
        return sd.detach().to("cpu", copy=True)
    if isinstance(sd, dict):
        return {k: host_tree(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return [host_tree(v) for v in sd]
    return sd


def checkpoint_hook(directory=None, *, engine=None, model=None,
                    optimizer=None, every: int = 100, extra=None):
    """Async save hook for the torch training loop on the sharded
    checkpoint engine.

    Returns ``save(step)``: call it once per step; every ``every`` steps
    it copies ``model.state_dict()`` / ``optimizer.state_dict()`` to the
    host (a replicated tree: rank 0 writes it) and hands it to the
    engine, which serializes and commits atomically in the background.
    The returned callable exposes ``save.engine`` (e.g. for
    ``engine.wait()`` at train end) and forces a blocking commit with
    ``save(step, block=True)``. Restore with ``engine.restore()`` (plain
    nested dicts, no template needed), then
    ``model.load_state_dict``/``optimizer.load_state_dict``.

    ``extra`` is a JSON-able dict recorded in every commit's manifest.
    """
    if (directory is None) == (engine is None):
        raise ValueError("pass exactly one of directory= or engine=")
    if engine is None:
        from .engine import CheckpointEngine
        engine = CheckpointEngine(directory)

    def save(step: int, block: bool = False):
        if step % every:
            return None
        tree = {}
        if model is not None:
            tree["model"] = host_tree(model.state_dict())
        if optimizer is not None:
            tree["optimizer"] = host_tree(optimizer.state_dict())
        if not tree:
            raise ValueError("checkpoint_hook needs model= and/or "
                             "optimizer=")
        return engine.save(tree, step=step, block=block, extra=extra)

    save.engine = engine
    return save
