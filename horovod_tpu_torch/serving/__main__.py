"""CLI: ``python -m horovod_tpu_torch.serving --checkpoint-dir DIR``.

Counterpart of ``python -m horovod_tpu.serving``: the same flags and the
same ``[serving] ready on :PORT`` line. It rebuilds the flagship
Transformer from a sharded checkpoint's manifest (the architecture
rides in its ``extra``, ``loader.transformer_extra``), loads its
parameters onto the card (``--device``, CUDA by default) and serves
``/generate``, ``/healthz`` and ``/readyz`` until SIGTERM drains it.
``--framework torch`` serves the model subtree of a ``checkpoint_hook``
commit; ``jax`` (the default) a params tree at the manifest root, as
JAX's trainers commit it.

``--fleet N`` makes this process a supervisor instead: it spawns N
replica processes of itself (``fleet.py``, each with ``--device``
forwarded; on one card they share it), fronts them with the failover
router (``router.py``) on ``--port``, restarts a crashed replica from
the same checkpoint and, with ``--autoscale-max``, grows and shrinks
the fleet on the QoS signals.

``--tp N`` serves on N ranks, one process a card: JAX's replica is one
process over N devices, the port's is N processes. Run plainly, this
process becomes their parent: it starts N ranks of the same command
through the runner's launcher (``torch.distributed``'s env rendezvous;
output tagged ``[rank]``), forwards SIGTERM to rank 0, and exits with
them. A rank runs on ``cuda:LOCAL_RANK`` (gloo with ``--device cpu``)
and loads only its own shard of the commit. Rank 0 alone binds HTTP
and metrics, prints ``ready on :PORT`` and schedules; the others follow
its step messages (``InferenceEngine.follow``). A rank that dies takes
the replica down with a non-zero exit, the others terminated; a parent
that dies takes its ranks with it (their parent watchdog). Started in a
world of N ranks already (``WORLD_SIZE`` = N: the runner's ``-np N``),
each process is one rank.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _replica_argv(args) -> list:
    """The argv tail a fleet replica needs: every model and engine
    knob, without --fleet/--port/--replica-id (the supervisor owns
    those)."""
    argv = ["--checkpoint-dir", args.checkpoint_dir,
            "--block-size", str(args.block_size),
            "--kv-blocks", str(args.kv_blocks),
            "--slots", str(args.slots),
            "--max-new-tokens", str(args.max_new_tokens),
            "--temperature", str(args.temperature),
            "--seed", str(args.seed),
            "--framework", args.framework,
            "--host", "127.0.0.1"]
    if args.device is not None:
        argv += ["--device", args.device]
    if args.step is not None:
        argv += ["--step", str(args.step)]
    if args.tp is not None:
        argv += ["--tp", str(args.tp)]
    if args.max_queue is not None:
        argv += ["--max-queue", str(args.max_queue)]
    if args.eos_id is not None:
        argv += ["--eos-id", str(args.eos_id)]
    if args.kv_quant is not None:
        argv += ["--kv-quant", args.kv_quant]
    if args.prefix_cache:
        argv += ["--prefix-cache"]
    if args.prefill_chunk is not None:
        argv += ["--prefill-chunk", str(args.prefill_chunk)]
    if args.session_leases is not None:
        argv += ["--session-leases", str(args.session_leases)]
    if args.reserved_slots is not None:
        argv += ["--reserved-slots", str(args.reserved_slots)]
    if args.draft_checkpoint_dir is not None:
        argv += ["--draft-checkpoint-dir", args.draft_checkpoint_dir]
        argv += ["--spec-tokens", str(args.spec_tokens)]
    return argv


def _run_fleet(args, parser) -> int:
    """Supervisor mode: no model in this process. The replicas own the
    card; this process owns processes, probes and routing."""
    from ..observability import flight_recorder as _flight
    from ..observability.export import maybe_start_exporters
    from ..utils import env as _env
    from . import reqtrace as _reqtrace
    from .fleet import Fleet
    from .router import Router

    maybe_start_exporters()      # the router's own hvdtpu_fleet_* families
    _flight.maybe_install_hooks()
    # The supervisor's blackbox identity: rank n (replicas are 0..n-1),
    # so its dump never collides with replica 0's in a shared directory.
    _flight.recorder().configure(rank=args.fleet, world=args.fleet + 1)
    # The router writes its REQUEST/DISPATCH/FAILOVER spans; replicas
    # start their own writers from the inherited HOROVOD_TPU_REQTRACE.
    _reqtrace.maybe_start(role="router")

    fleet = Fleet(args.fleet, _replica_argv(args))
    router = Router(fleet, port=(args.port if args.port is not None
                                 else _env.serving_port()),
                    host=args.host)
    autoscaler = None
    if args.autoscale_max is not None:
        from .qos import AutoscalerConfig, FleetAutoscaler
        amin = args.autoscale_min if args.autoscale_min is not None \
            else args.fleet
        cfg = AutoscalerConfig(
            amin, args.autoscale_max,
            high_load=_env.qos_scale_high(),
            low_load=_env.qos_scale_low(),
            sustain_s=_env.qos_scale_sustain_s(),
            cooldown_s=_env.qos_scale_cooldown_s())
        autoscaler = FleetAutoscaler(
            fleet, cfg, signals=router.qos_signals,
            interval_s=_env.qos_scale_interval_s())
        fleet.on_alert = autoscaler.note_alert
    print(f"[fleet] spawning {args.fleet} replica(s) from "
          f"{args.checkpoint_dir}", file=sys.stderr, flush=True)
    fleet.start()
    try:
        fleet.wait_ready(600.0)
    except TimeoutError as e:
        fleet.stop()
        parser.error(str(e))
    router.start()
    if autoscaler is not None:
        autoscaler.start()
        # The bounds from the config this process built: the autoscaler
        # keeps it on its state (JAX's CLI reads a `config` attribute the
        # autoscaler lacks and dies here).
        print(f"[fleet] autoscaler on: {cfg.min_replicas}"
              f"..{cfg.max_replicas} replicas",
              file=sys.stderr, flush=True)
    print(f"[fleet] routing on :{router.port} across {args.fleet} "
          "replica(s) (/generate, /healthz, /readyz)",
          file=sys.stderr, flush=True)

    import signal
    import threading
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    while not stop.wait(0.2):
        pass
    print("[fleet] stopping: draining replicas", file=sys.stderr,
          flush=True)
    if autoscaler is not None:
        autoscaler.stop()
    router.shutdown()
    fleet.stop()
    return 0


def _exit_code(rc: int) -> int:
    """A rank's return code as an exit status: 128 + N for signal N."""
    return rc if rc >= 0 else 128 - rc


def _serve_ranks(argv: list, tp: int, grace_s: float = 30.0) -> int:
    """``--tp N`` outside a launched world: start N ranks of this very
    command through the launcher and exit with them. SIGTERM/SIGINT go
    to rank 0, which drains and stops the followers. The first rank to
    exit non-zero ends the replica (the others terminated); a rank 0 that
    exits 0 gives the followers ``grace_s`` to leave."""
    import signal
    from ..runner.launcher import launch
    job = launch([sys.executable, "-m", "horovod_tpu_torch.serving", *argv],
                 np=tp)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: job.signal(signal.SIGTERM, [0]))
    t_lead = None
    while True:
        rcs = [w.poll() for w in job.workers]
        bad = next((rc for rc in rcs if rc not in (None, 0)), None)
        if bad is None and rcs[0] == 0 and None in rcs:
            t_lead = t_lead or time.monotonic()
            if time.monotonic() - t_lead > grace_s:
                bad = 1
        if bad is not None or None not in rcs:
            if bad is not None:
                print(f"[serving] a rank exited {bad}: stopping the "
                      f"replica's {tp} ranks", file=sys.stderr, flush=True)
                job.terminate()
            for w in job.workers:
                w.wait(timeout=10.0)   # flush the ranks' last lines
            return 0 if bad is None else _exit_code(bad)
        time.sleep(0.1)


def main(argv=None) -> int:
    from ..runner.launcher import watch_launcher
    from ..utils import env as _env

    argv = list(sys.argv[1:] if argv is None else argv)
    watch_launcher()   # a launched process leaves with its launcher

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving",
        description="Serve a sharded checkpoint: decode with "
                    "continuous batching — one replica, or a supervised "
                    "fleet behind the failover router (--fleet N).")
    parser.add_argument("--checkpoint-dir", required=True,
                        help="sharded checkpoint root (the directory "
                             "holding step-N/ + LATEST)")
    parser.add_argument("--step", type=int, default=None,
                        help="step to serve (default: LATEST)")
    parser.add_argument("--port", type=int, default=None,
                        help="HTTP port (default: "
                             "$HOROVOD_TPU_SERVING_PORT or 8400; 0 = "
                             "ephemeral); with --fleet, the ROUTER's "
                             "port (replicas bind ephemeral ports)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--fleet", type=int, default=None,
                        help="supervise N replica processes behind the "
                             "failover router (docs/serving.md#fleet): "
                             "crash detection, restart, queue-depth-"
                             "aware routing, zero-dropped-request "
                             "failover")
    parser.add_argument("--replica-id", type=int, default=None,
                        help="(internal, set by the fleet supervisor) "
                             "this replica's index — names its "
                             "blackbox dump and fault-spec rank")
    parser.add_argument("--framework", choices=("jax", "torch"),
                        default="jax",
                        help="checkpoint flavor: 'jax' (params tree at "
                             "the manifest root) or 'torch' (a "
                             "checkpoint_hook commit; the model "
                             "subtree is served)")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel width (default 1): N ranks, "
                             "one process a card, rank i on "
                             "cuda:LOCAL_RANK; only rank 0 serves HTTP")
    parser.add_argument("--device", default=None,
                        help="the card to serve on (default: cuda); "
                             "'cpu' runs on the CPU; with --fleet, every "
                             "replica's")
    parser.add_argument("--block-size", type=int, default=16,
                        help="KV-cache block size in tokens")
    parser.add_argument("--kv-blocks", type=int, default=128,
                        help="KV pool size in blocks (scratch included)")
    parser.add_argument("--slots", type=int, default=8,
                        help="decode batch width (concurrent "
                             "generations)")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="bounded admission queue (default: "
                             "$HOROVOD_TPU_SERVING_QUEUE or 32; "
                             "past it /generate returns 429)")
    parser.add_argument("--max-new-tokens", type=int, default=64,
                        help="per-request default generation budget")
    parser.add_argument("--eos-id", type=int, default=None,
                        help="stop token id (default: max-tokens only)")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy; > 0 = seeded sampling")
    parser.add_argument("--seed", type=int, default=0,
                        help="sampling PRNG seed")
    parser.add_argument("--kv-quant", choices=("int8", "fp8"),
                        default=None,
                        help="quantize the KV pool (wire-format absmax "
                             "blocks, about 2x the resident sequences "
                             "of a bf16 pool; docs/serving.md#speed-"
                             "levers)")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="share read-only KV blocks between "
                             "requests with a common prompt prefix "
                             "(system prompts prefill once per replica)")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="chunked prefill: consume long prompts as "
                             "chunks of at most this many tokens, at "
                             "most one chunk between decode ticks — "
                             "bounds decode-tick tail latency under "
                             "long-prompt bursts (docs/serving.md#"
                             "chunked-prefill; budget via "
                             "$HOROVOD_TPU_SERVING_TICK_BUDGET_MS)")
    parser.add_argument("--reserved-slots", type=int, default=None,
                        help="decode-batch slots reserved for the "
                             "'interactive' priority class "
                             "(docs/serving.md#qos): bulk/default "
                             "admission stops once occupancy would "
                             "leave fewer than this many free slots "
                             "(default: $HOROVOD_TPU_SERVING_RESERVED_"
                             "SLOTS or 0)")
    parser.add_argument("--autoscale-max", type=int, default=None,
                        help="with --fleet: enable SLO-driven "
                             "autoscaling up to this many replicas "
                             "(docs/serving.md#qos); scale-ups need "
                             "sustained pressure, scale-downs drain "
                             "via /readyz")
    parser.add_argument("--autoscale-min", type=int, default=None,
                        help="autoscaler floor (default: the --fleet "
                             "value)")
    parser.add_argument("--session-leases", type=int, default=None,
                        help="max session KV leases held per replica "
                             "(session affinity, docs/serving.md#"
                             "session-affinity; 0 disables; "
                             "default 8)")
    parser.add_argument("--draft-checkpoint-dir", default=None,
                        help="drafter checkpoint for speculative "
                             "decoding (a shrunk transformer sharing "
                             "the vocab; same manifest convention)")
    parser.add_argument("--draft-step", type=int, default=None,
                        help="drafter step to serve (default: LATEST)")
    parser.add_argument("--spec-tokens", type=int, default=4,
                        help="speculative verify width k: the drafter "
                             "proposes k-1 tokens per step, the "
                             "flagship verifies them in one [slots, k] "
                             "forward (needs --draft-checkpoint-dir)")
    args = parser.parse_args(argv)

    if args.tp is not None and args.tp < 1:
        parser.error(f"--tp {args.tp} must be >= 1")
    if args.fleet is not None:
        if args.fleet < 1:
            parser.error(f"--fleet {args.fleet} must be >= 1")
        if args.replica_id is not None:
            parser.error("--fleet and --replica-id are mutually "
                         "exclusive (the supervisor assigns ids)")
        if args.autoscale_max is not None:
            amin = args.autoscale_min if args.autoscale_min is not None \
                else args.fleet
            if not (1 <= amin <= args.fleet <= args.autoscale_max):
                parser.error(
                    f"--autoscale-min {amin} <= --fleet {args.fleet} "
                    f"<= --autoscale-max {args.autoscale_max} required")
        return _run_fleet(args, parser)
    if args.autoscale_max is not None or args.autoscale_min is not None:
        parser.error("--autoscale-min/--autoscale-max need --fleet")
    tp = args.tp or 1
    if tp > 1:
        if args.device is not None and ":" in args.device:
            parser.error(f"--device {args.device} at --tp {tp}: each rank "
                         "takes cuda:LOCAL_RANK; pass --device cuda")
        if os.environ.get("WORLD_SIZE") != str(tp):
            return _serve_ranks(argv, tp)

    replica_id = args.replica_id if args.replica_id is not None \
        else _env.replica_id()
    if replica_id is not None:
        # Before anything resolves faults: the injector keys on it.
        os.environ["HOROVOD_TPU_REPLICA_ID"] = str(replica_id)

    import torch
    from ..checkpoint import CheckpointEngine
    from ..models.transformer import Transformer
    from ..observability import flight_recorder as _flight
    from ..observability.export import maybe_start_exporters, server_port
    from ..topology import resolve_device
    from . import reqtrace as _reqtrace
    from .engine import InferenceEngine, ServingConfig, tp_mesh
    from .loader import (TORCH_MODEL_PREFIX, config_from_manifest,
                         load_params, serving_config)
    from .server import ServingServer

    device = resolve_device(args.device)
    mesh, tp_rank = None, 0
    if tp > 1:
        # One rank of tp: its card, the world's 'tp' mesh, its shard.
        mesh = tp_mesh(tp, device)
        tp_rank = int(os.environ["RANK"])
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        print(f"[serving] rank {tp_rank} of {tp} pid {os.getpid()} on "
              f"{device}", file=sys.stderr, flush=True)
    if tp_rank == 0:
        # The telemetry JAX's replica arms through hvd.init(): the
        # metrics endpoint (HOROVOD_TPU_METRICS_PORT=0 under a fleet:
        # announced on the ready line, scraped by the router), the
        # crash hooks, and the recorder's identity, rank = replica id at
        # world 0, generation = incarnation. Rank 0 only: the others
        # serve nothing.
        maybe_start_exporters()
        gen = int(os.environ.get("HOROVOD_TPU_ELASTIC_GENERATION", "0")
                  or 0)
        rank, world = ((replica_id, 0) if replica_id is not None
                       else (0, 1))
        _flight.recorder().configure(rank=rank, world=world,
                                     generation=gen)
        _flight.recorder().note("init", (rank, world, gen))
        _flight.maybe_install_hooks()
        # Per-request tracing: one catapult file per replica incarnation
        # under HOROVOD_TPU_REQTRACE.
        _reqtrace.maybe_start()

    # Each rank reads the shard-file spans of its own blocks.
    eng = CheckpointEngine(args.checkpoint_dir, process_index=tp_rank,
                           process_count=tp)
    man = eng.restore_manifest(args.step)
    cfg = serving_config(config_from_manifest(man), mesh)
    key_prefix = TORCH_MODEL_PREFIX if args.framework == "torch" else ""
    params = load_params(args.checkpoint_dir, cfg, mesh, step=args.step,
                         engine=eng, key_prefix=key_prefix, device=device)
    model = Transformer(cfg, params=params, device=device, mesh=mesh)
    del params
    print(f"[serving] step {man['step']}: d_model={cfg.d_model} "
          f"layers={cfg.n_layers} heads={cfg.n_heads} "
          f"vocab={cfg.vocab} tp={tp} framework={args.framework} "
          f"device={device}", file=sys.stderr)

    drafter = None
    if args.draft_checkpoint_dir is not None:
        deng = CheckpointEngine(args.draft_checkpoint_dir,
                                process_index=tp_rank, process_count=tp)
        dman = deng.restore_manifest(args.draft_step)
        draft_cfg = serving_config(config_from_manifest(dman), mesh)
        drafter = Transformer(draft_cfg, device=device, mesh=mesh,
                              params=load_params(
                                  args.draft_checkpoint_dir, draft_cfg,
                                  mesh, step=args.draft_step, engine=deng,
                                  device=device))
        print(f"[serving] drafter step {dman['step']}: "
              f"d_model={draft_cfg.d_model} layers={draft_cfg.n_layers} "
              f"(spec_tokens={args.spec_tokens})", file=sys.stderr)

    config = ServingConfig(
        block_size=args.block_size, kv_blocks=args.kv_blocks,
        max_batch_slots=args.slots,
        max_queue=args.max_queue if args.max_queue is not None
        else _env.serving_queue(),
        max_new_tokens=args.max_new_tokens, eos_id=args.eos_id,
        temperature=args.temperature, seed=args.seed,
        kv_quant=args.kv_quant,
        spec_tokens=(args.spec_tokens if drafter is not None else 0),
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        session_leases=(args.session_leases
                        if args.session_leases is not None else 8),
        reserved_slots=(args.reserved_slots
                        if args.reserved_slots is not None
                        else _env.serving_reserved_slots()))
    engine = InferenceEngine(model, config, drafter=drafter, device=device)
    if not engine.leader:
        engine.follow()   # until rank 0 drains
        torch.distributed.destroy_process_group()
        return 0
    server = ServingServer(engine, port=args.port, host=args.host)
    server.install_signal_handlers()
    server.start()
    mport = server_port()
    tail = f" metrics=:{mport}" if mport is not None else ""
    if replica_id is not None:
        tail += f" replica={replica_id}"
    # "ready on :PORT" is what a supervisor and the tests parse: keep
    # the phrase. On stdout: a supervisor owns that pipe.
    print(f"[serving] ready on :{server.port} (/generate, /healthz, "
          f"/readyz){tail}", flush=True)
    server.serve_forever()   # at tp > 1 its drain stops the followers
    if mesh is not None:
        ch = engine.step_channel
        print(f"[serving] tp step messages: {ch.sent} sent; the first "
              f"{ch.first_s * 1e3:.3f} ms (the group's setup), then "
              f"{ch.send_s / max(ch.sent - 1, 1) * 1e3:.4f} ms of host "
              "time a message", file=sys.stderr, flush=True)
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
