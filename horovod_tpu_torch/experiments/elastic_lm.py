"""The flagship LM under the elastic driver: the worker of
``chip_smoke.py``'s phase 23.

    from horovod_tpu_torch.elastic import run_elastic
    from horovod_tpu_torch.experiments import elastic_lm
    run_elastic(elastic_lm.train, args=(6, 2, 3), min_np=1, max_np=1,
                state_dir=DIR)

:func:`train` lives at module level: without ``cloudpickle`` the
launcher ships a function by reference. Each process it runs in calls
``init()`` (the rendezvous from the launcher's env), builds the 111M
flagship of phase 5 (vocab 32000, d_model 768, 12 layers, d_ff 3072, 6
heads of 128, seq 2048, bf16, no remat) from seed 0 with AdamW,
wraps both in ``ElasticState(backend="sharded")`` over
``HOROVOD_TPU_ELASTIC_DIR``, restores, and trains from the restored
step to ``steps`` on batches of 8 x 2049 tokens drawn from the step's
own seed (so a batch does not depend on where a generation started),
committing after every ``commit_every`` steps. In generation 0, after
step ``kill_after``, it waits for its commits to be durable, writes the
time to ``<dir>/killed_at`` and SIGKILLs itself: the apparatus of a
lost worker. (The ``crash_at`` fault clause of ROADMAP Queue 1 item 5c
kills at an enqueue tick, before the commit need be durable.)

It returns a summary: the generation, the step it started from, the
restore's seconds, each step's loss and K1-K3 launches, the wall time of
its first step's start, and a sha256 of the bytes of every parameter
and AdamW moment, which two runs compare for bit equality.
"""

from __future__ import annotations

import hashlib
import os
import signal
import time
from typing import Optional

import torch

FLAGSHIP = dict(vocab=32000, d_model=768, n_layers=12, d_ff=3072,
                max_seq=2048)
BATCH = 8


def _digest(t: torch.Tensor) -> str:
    b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()


def train(steps: int, commit_every: int, kill_after: Optional[int],
          device: str = "cuda", width: Optional[dict] = None,
          dtype: torch.dtype = torch.bfloat16) -> dict:
    """One elastic worker (see the module docstring). ``commit_every``
    0 commits nothing; ``kill_after`` None never kills. ``device`` and
    ``width`` exist for a rehearsal on the CPU at a small width."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ElasticState
    from horovod_tpu_torch.elastic.state import ELASTIC_DIR_ENV
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.train import build_train_step

    hvd.init(device=device)
    gen = hvd.generation()
    w = dict(FLAGSHIP, **(width or {}))
    cfg = tfm.TransformerConfig(dtype=dtype, remat=False, **w)
    step_fn = build_train_step(cfg, lambda p: torch.optim.AdamW(
        p, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        device=device)
    model = step_fn.make_model(generator=torch.Generator().manual_seed(0))
    opt = step_fn.make_optimizer(model)
    state = ElasticState(backend="sharded", model=model, optimizer=opt)
    dev = hvd.device()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    state.restore()
    sync()
    restore_s = time.perf_counter() - t0
    start = int(state.step)

    losses, launches, t_first = [], [], None
    for step in range(start, steps):
        tok = torch.randint(0, cfg.vocab, (BATCH, cfg.max_seq + 1),
                            generator=torch.Generator().manual_seed(
                                1000 + step)).to(dev)
        if t_first is None:
            t_first = time.time()
        fa.reset_launch_counts()
        losses.append(float(step_fn(model, opt, tok[:, :-1], tok[:, 1:])))
        counts = fa.launch_counts()
        launches.append({k: counts[k] for k in
                         ("flash_fwd", "flash_dkv", "flash_dq")})
        if commit_every and (step + 1) % commit_every == 0:
            state.commit(step + 1)
        if gen == 0 and kill_after is not None and step + 1 == kill_after:
            state.wait()   # the last commit is durable before the loss
            with open(os.path.join(os.environ[ELASTIC_DIR_ENV],
                                   "killed_at"), "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
    state.wait()
    out = {"generation": gen, "start": start, "restore_s": restore_s,
           "losses": losses, "launches": launches, "t_first": t_first,
           "params": {k: _digest(v) for k, v in model.state_dict().items()},
           "moments": [{k: _digest(v) for k, v in st.items()
                        if torch.is_tensor(v)}
                       for st in opt.state.values()]}
    hvd.shutdown()
    return out
