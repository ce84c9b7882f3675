"""CLI launcher: ``python -m horovod_tpu_torch.runner -np 4 python train.py``.

Counterpart of ``python -m horovod_tpu.runner``, with every one of its
flags. The reference has no dedicated CLI (bare ``mpirun`` per
docs/running.md:1-45); this plays mpirun's role for the port. Slots
follow mpirun's ``-H host:slots`` syntax; output is tag-prefixed per
rank; each rank gets ``torch.distributed``'s env rendezvous
(:mod:`.launcher`).

Worker discovery (``--discovery {hostfile,ssh,tpu-pod}``) resolves the
host list through the :class:`horovod_tpu_torch.elastic.HostProvider`
interface instead of a literal ``-H`` string. ``--elastic``
additionally survives worker loss: the job shrinks to the surviving
hosts (never below ``--min-np``), relaunches, and grows back when
replacements appear (docs/elastic.md).

``--serve`` runs ``python -m horovod_tpu_torch.serving`` (one process;
at ``--tp N`` it starts its own N ranks). SIGTERM is forwarded to the
workers, which drain and exit on their own (a server's graceful drain).
``--adaptation`` arms rank 0's adaptation policy in every worker
(``HOROVOD_TPU_ADAPTATION=1``, ROADMAP Queue 1 item 5c). ``--autotune``
is refused: the port has no global tuner (item 5e) yet.
"""

from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a distributed horovod_tpu_torch job "
                    "(the mpirun of the port).")
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="total number of worker processes (default "
                             "with --discovery: every discovered slot)")
    parser.add_argument("-H", "--hosts", default=None,
                        help="host slots, mpirun syntax: host1:2,host2:2 "
                             "(default: localhost); with --discovery ssh "
                             "these are the candidates to probe")
    parser.add_argument("--discovery", default=None,
                        choices=["hostfile", "ssh", "tpu-pod"],
                        help="resolve workers through a HostProvider: "
                             "a hostfile, ssh-probed -H candidates, or "
                             "the GCE metadata server of a TPU pod")
    parser.add_argument("--hostfile", default=None,
                        help="hostfile path for --discovery hostfile "
                             "(lines: 'host slots=N', 'host:N', 'host')")
    parser.add_argument("--metadata-addr", default=None,
                        help="metadata server base URL for --discovery "
                             "tpu-pod (default: $HOROVOD_TPU_METADATA_ADDR "
                             "or the real GCE endpoint)")
    parser.add_argument("--elastic", action="store_true",
                        help="survive worker loss: shrink to the "
                             "remaining hosts (>= --min-np), relaunch, "
                             "grow back when hosts return")
    parser.add_argument("--min-np", type=int, default=1,
                        help="elastic: smallest world size to continue "
                             "with (default 1)")
    parser.add_argument("--max-np", type=int, default=None,
                        help="elastic: largest world size to grow to "
                             "(default: -np, else all discovered slots)")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="elastic: relaunch budget (default 3)")
    parser.add_argument("--failure-timeout", type=float, default=30.0,
                        help="elastic: seconds before stalls/heartbeat "
                             "loss escalate to WorkerFailure (default 30)")
    parser.add_argument("--state-dir", default=None,
                        help="elastic: ElasticState commit directory, "
                             "exported as HOROVOD_TPU_ELASTIC_DIR")
    parser.add_argument("--timeline", default=None,
                        help="write collective timelines: a plain path "
                             "traces rank 0 only; a path with a {rank} "
                             "placeholder (e.g. /tmp/trace.{rank}.json) "
                             "traces EVERY rank with clock-alignment "
                             "headers for `python -m "
                             "horovod_tpu.tools.trace merge` "
                             "(docs/tracing.md); exported as "
                             "HOROVOD_TPU_TIMELINE")
    parser.add_argument("--fault-spec", default=None,
                        help="deterministic fault injection "
                             "(docs/adaptation.md), e.g. "
                             "'rank=2:delay=80ms:from_step=50; "
                             "rank=1:crash_at=30'; exported as "
                             "HOROVOD_TPU_FAULT_SPEC to every worker "
                             "generation")
    parser.add_argument("--adaptation", action="store_true",
                        help="arm the rank-0 adaptation policy "
                             "(docs/adaptation.md): on sustained "
                             "straggler lateness the coordinator shrinks "
                             "fusion groups, then moves allreduces on "
                             "bf16, int8 and fp8 wires, then evicts the "
                             "straggler (elastic); exported as "
                             "HOROVOD_TPU_ADAPTATION=1")
    parser.add_argument("--autotune", action="store_true",
                        help="the GLOBAL online autotuner "
                             "(docs/autotune.md); refused: the port has "
                             "none yet (ROADMAP Queue 1 item 5e)")
    parser.add_argument("--blackbox-dir", default=None,
                        help="flight-recorder crash-dump directory "
                             "(docs/postmortem.md): on a crash, "
                             "SIGTERM, stall escalation or eviction "
                             "each rank writes blackbox-rank{rank}"
                             ".jsonl here for `python -m "
                             "horovod_tpu.tools.postmortem`; exported "
                             "as HOROVOD_TPU_BLACKBOX")
    parser.add_argument("--history-dir", default=None,
                        help="telemetry history directory "
                             "(docs/health.md): each rank appends "
                             "windowed registry deltas to "
                             "history-rank{rank}.jsonl here every "
                             "HOROVOD_TPU_HISTORY_INTERVAL (5 s) and "
                             "the online health detectors run over "
                             "the live window; read with `python -m "
                             "horovod_tpu.tools.health`; exported as "
                             "HOROVOD_TPU_HISTORY")
    parser.add_argument("--serve", action="store_true",
                        help="serving mode (docs/serving.md): the "
                             "worker command becomes `python -m "
                             "horovod_tpu_torch.serving` and remaining "
                             "arguments are passed to it, e.g. "
                             "`python -m horovod_tpu_torch.runner "
                             "--serve -- --checkpoint-dir /ckpts --tp "
                             "2` (at --tp N it starts N ranks itself)")
    parser.add_argument("--fleet", type=int, default=None,
                        help="with --serve: supervise N serving "
                             "replicas behind the failover router "
                             "(docs/serving.md#fleet) — shorthand for "
                             "passing --fleet N to `python -m "
                             "horovod_tpu_torch.serving`")
    parser.add_argument("--timeout", type=float, default=None,
                        help="overall job timeout in seconds")
    parser.add_argument("--no-tag-output", action="store_true",
                        help="do not prefix worker output with [rank]")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="worker command, e.g. python train.py")
    args = parser.parse_args(argv)

    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if args.fleet is not None and not args.serve:
        parser.error("--fleet requires --serve")
    if args.serve:
        # Serving is one front-end process per host (which itself
        # supervises --fleet N replica processes); the remaining argv
        # belongs to `python -m horovod_tpu_torch.serving`.
        fleet = ["--fleet", str(args.fleet)] \
            if args.fleet is not None else []
        command = [sys.executable, "-m", "horovod_tpu_torch.serving"] \
            + fleet + command
        if args.num_proc is None and not args.discovery:
            args.num_proc = 1
    elif not command:
        parser.error("missing worker command")

    if args.autotune:
        parser.error("--autotune: the port has no global autotuner yet "
                     "(ROADMAP Queue 1 item 5e)")

    extra_env = {}
    if args.fault_spec:
        # Validate at launch: a typo'd fault harness must fail here, not
        # silently inject nothing in the workers.
        from ..adaptation.faults import parse_spec
        parse_spec(args.fault_spec)
        extra_env["HOROVOD_TPU_FAULT_SPEC"] = args.fault_spec
    if args.adaptation:
        extra_env["HOROVOD_TPU_ADAPTATION"] = "1"
    if args.timeline:
        # Propagated UNEXPANDED: each worker resolves its own {rank}
        # (utils/env.resolved_timeline_path), so the same value serves
        # the single-writer and all-ranks capture modes — and elastic
        # relaunches keep rank-correct paths across generations.
        extra_env["HOROVOD_TPU_TIMELINE"] = args.timeline
    if args.blackbox_dir:
        extra_env["HOROVOD_TPU_BLACKBOX"] = args.blackbox_dir
    if args.history_dir:
        extra_env["HOROVOD_TPU_HISTORY"] = args.history_dir

    provider = None
    hosts = args.hosts
    np = args.num_proc
    if args.discovery:
        from ..elastic.discovery import get_provider
        provider = get_provider(args.discovery, hosts=args.hosts,
                                hostfile=args.hostfile,
                                metadata_addr=args.metadata_addr)
        slots = provider.discover()
        if not slots:
            parser.error(f"--discovery {args.discovery} found no workers")
        hosts = ",".join(f"{h}:{s}" for h, s in slots)
        if np is None:
            np = sum(s for _, s in slots)
        print(f"[discovery:{args.discovery}] "
              f"{len(slots)} host(s), {sum(s for _, s in slots)} slot(s): "
              f"{hosts}", file=sys.stderr)

    if args.elastic:
        from ..elastic.driver import run_elastic_command
        from ..elastic.failure import FailureConfig
        config = FailureConfig(failure_timeout_s=args.failure_timeout,
                               max_restarts=args.max_restarts)
        try:
            return run_elastic_command(
                command, min_np=args.min_np,
                max_np=args.max_np if args.max_np is not None else np,
                provider=provider, hosts=hosts,
                state_dir=args.state_dir, config=config,
                extra_env=extra_env or None,
                tag_output=not args.no_tag_output,
                run_timeout=args.timeout)
        except KeyboardInterrupt:
            return 130

    if np is None:
        parser.error("-np is required (or use --discovery to size the "
                     "job from the discovered slots)")

    from .launcher import launch

    job = launch(command, np=np, hosts=hosts,
                 extra_env=extra_env or None,
                 tag_output=not args.no_tag_output)
    # SIGTERM reaches the workers, which drain and exit on their own
    # (the wait below returns their code); the workers run in sessions
    # of their own, so without this a SIGTERM here would orphan them.
    prev = signal.signal(signal.SIGTERM,
                         lambda *_: job.signal(signal.SIGTERM))
    try:
        return job.wait(timeout=args.timeout)
    except KeyboardInterrupt:
        job.terminate()
        return 130
    finally:
        signal.signal(signal.SIGTERM, prev)


if __name__ == "__main__":
    sys.exit(main())
