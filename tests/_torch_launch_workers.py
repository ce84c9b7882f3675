"""Worker functions the port's launcher tests ship to spawned ranks.

The launcher pickles a worker function by reference where
``cloudpickle`` is absent (as on the card's machine), so the functions
live here, importable at module level: the tests put this directory on
the workers' ``PYTHONPATH``. Nothing here imports JAX or the JAX
package, so a worker starts with torch alone.
"""

import os


def rank_env():
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


def fail_on_rank1():
    if os.environ["RANK"] == "1":
        raise RuntimeError("boom on rank 1")
    return "ok"


def gloo_world():
    """The world ``init`` builds from the launcher's env alone."""
    import horovod_tpu_torch as hvd
    topo = hvd.init(device="cpu")
    out = (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
           topo.backend)
    hvd.shutdown()
    return out


def quadratic(total_steps, commit_every, kill_at, replay_from=None):
    """The elastic acceptance worker of ``tests/test_elastic.py``, on the
    port: a 4-dim quadratic descent whose data is a function of (step,
    rank), gradients averaged over the world. Rank 1 SIGKILLs itself at
    ``kill_at`` in generation 0; ``replay_from`` restores that commit and
    never commits (the clean replay)."""
    import signal

    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.process_rank()
    gen = hvd.generation()
    state = hvd.ElasticState(params={"w": torch.zeros(4)})
    state.restore(step=replay_from)
    w = state.params["w"].clone()
    start = int(state.step)
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])
    for step in range(start, total_steps):
        if gen == 0 and r == 1 and step == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        scale = 1.0 + 0.1 * ((step * 7 + r * 3) % 5)
        grad = scale * (w - target)
        grad = hvd.allreduce(grad, average=True, name=f"g.{step}")
        w = w - 0.1 * grad
        state.params = {"w": w}
        if replay_from is None and (step + 1) % commit_every == 0:
            state.commit(step + 1)
    size = hvd.size()
    hvd.shutdown()
    return {"w": w.tolist(), "gen": gen, "size": size, "start": start}


def adaptive_quadratic(total_steps, commit_every, outdir):
    """:func:`quadratic` under the adaptation policy
    (``tests/test_torch_adaptation.py``): every step's allreduce goes
    through the engine, a commit every ``commit_every`` steps. When the
    policy's eviction fails this rank's op, rank 0 writes its
    ``hvdtpu_adaptation_*`` families and the typed error to
    ``outdir/gen<G>_rank0.pkl`` and the error ends the generation."""
    import pickle

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import SlowRankFailure
    from horovod_tpu_torch.observability import registry as treg

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.process_rank()
    gen = hvd.generation()
    state = hvd.ElasticState(params={"w": torch.zeros(4)})
    state.restore()
    w = state.params["w"].clone()
    start = int(state.step)
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])
    steps = []
    try:
        for step in range(start, total_steps):
            scale = 1.0 + 0.1 * ((step * 7 + r * 3) % 5)
            grad = hvd.allreduce(scale * (w - target), average=True,
                                 name=f"g.{step}")
            w = w - 0.1 * grad
            state.params = {"w": w}
            if (step + 1) % commit_every == 0:
                state.commit(step + 1)
            steps.append(step)
    except SlowRankFailure as e:
        if r == 0:
            out = {k: v["values"] for k, v in
                   treg.snapshot("hvdtpu_adaptation_").items()}
            out["error"] = (type(e).__name__, e.rank)
            with open(os.path.join(outdir, f"gen{gen}_rank0.pkl"),
                      "wb") as f:
                pickle.dump(out, f)
        raise
    size = hvd.size()
    hvd.shutdown()
    return {"w": w.tolist(), "gen": gen, "size": size, "start": start,
            "steps": steps}


def serve_tp(params, model_kw, engine_kw, prompts, max_new_tokens):
    """The port's engine at tp = world size on gloo ranks: every rank
    builds it over its heads of ``params`` (a numpy tree); rank 0 submits
    ``prompts`` at once, runs them to the end and drains (its stop
    message ends the followers' loop). Rank 0 returns the tokens and the
    step messages it sent."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.mesh import place, shard_tree
    from horovod_tpu_torch.serving import (InferenceEngine, ServingConfig,
                                           tp_mesh)

    torch.set_num_threads(1)
    n = int(os.environ["WORLD_SIZE"])
    mesh = tp_mesh(n, "cpu")

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tensors(v) for v in tree]
        return torch.from_numpy(np.array(tree, np.float32))

    cfg = tfm.TransformerConfig(dtype=torch.float32, tp_axis="tp",
                                **model_kw)
    model = tfm.Transformer(cfg, device="cpu", mesh=mesh, params=shard_tree(
        tensors(params), tfm.param_specs(cfg), *place(mesh)))
    eng = InferenceEngine(model, ServingConfig(**engine_kw), device="cpu")
    out = None
    if eng.leader:
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        eng.run_until_idle()
        eng.drain()
        out = {"tokens": [r.result(timeout=60) for r in reqs],
               "messages": eng.step_channel.sent}
    else:
        eng.follow()
    dist.destroy_process_group()
    return out
