"""``llm-consensus route`` — the fleet router in front of N gateways (port
of ``llm_consensus_tpu/cli/route.py``).

Where ``serve`` makes ONE process resident, ``route`` fronts many of
them: it places each request on its home replica by consistent hash of
the coalescing cache key (identical concurrent requests collapse to one
execution fleet-wide), tracks replica health with hysteresis off their
``/healthz`` + ``/statsz``, fails streams over to a healthy replica when
one dies mid-decode (emitted-prefix replay — the client sees a pause,
never a dropped or duplicated chunk), and — with ``--spillover-models``
— degrades to the remote-API providers when the whole device fleet is
dead or saturated, tagging the response ``degraded: remote``.

Replicas arrive two ways: statically via ``--replica`` (repeatable or
comma-separated), and dynamically — gateways started with
``serve --announce http://router:port`` register themselves by periodic
heartbeat and age out when they stop beating.

The environment is read once, through ``utils/knobs.py``
(``fleet_settings``, ``elastic_settings``, ``http_settings``), and its
settings go to the router, the health monitor and the elastic controller
as arguments; flags win over knobs.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional, TextIO

from llm_consensus_tpu_torch.utils import knobs


def parse_route_args(argv: list[str]):
    from llm_consensus_tpu_torch.cli.main import CLIError

    parser = argparse.ArgumentParser(
        prog="llm-consensus route",
        description="Route consensus requests over a fleet of gateways.",
    )
    parser.add_argument("--replica", "-replica", action="append", default=[],
                        metavar="URL",
                        help="Gateway replica base URL (repeat or "
                             "comma-separate); more may join via "
                             "serve --announce heartbeats")
    parser.add_argument("--host", "-host", default="127.0.0.1",
                        help="Bind address (default 127.0.0.1)")
    parser.add_argument("--port", "-port", type=int, default=8081,
                        help="Bind port (0 = OS-assigned)")
    parser.add_argument("--poll-s", "-poll-s", type=float, default=None,
                        help="Replica health-poll interval in seconds "
                             "(default LLMC_FLEET_POLL_S or 2.0)")
    parser.add_argument("--saturation", "-saturation", type=float,
                        default=None,
                        help="load_score at/above which placement "
                             "overflows to the next ring replica "
                             "(default LLMC_FLEET_SATURATION or 0.85)")
    parser.add_argument("--spillover", "-spillover", default=None,
                        choices=["off", "saturated"],
                        help="Remote-API degradation policy: 'saturated' "
                             "spills eligible requests when no live "
                             "replica can take them (default when "
                             "--spillover-models is set; else 'off')")
    parser.add_argument("--spillover-models", "-spillover-models",
                        default="", metavar="LIST",
                        help="Comma-separated remote panel models for the "
                             "spillover lane (OpenAI/Anthropic/Google "
                             "catalog names)")
    parser.add_argument("--spillover-judge", "-spillover-judge", default="",
                        help="Remote judge model for the spillover lane "
                             "(defaults to the CLI's default judge)")
    parser.add_argument("--data-dir", "-data-dir", default="data",
                        help="Run-dir root for spillover executions")
    parser.add_argument("--save", "-save", action="store_true",
                        help="Persist spillover run dirs (off by default: "
                             "the replicas own persistence)")
    parser.add_argument("--min-replicas", "-min-replicas", type=int,
                        default=None,
                        help="Elastic floor: the scale controller never "
                             "shrinks the serving pool below this "
                             "(default LLMC_ELASTIC_MIN_REPLICAS or 1)")
    parser.add_argument("--max-replicas", "-max-replicas", type=int,
                        default=None,
                        help="Elastic ceiling: the scale controller never "
                             "grows the serving pool above this "
                             "(default LLMC_ELASTIC_MAX_REPLICAS or 8)")
    parser.add_argument("--quiet", "-quiet", "-q", action="store_true",
                        help="Suppress the banner and request log")
    parser.add_argument("--events", "-events", action="store_true",
                        help="Record router telemetry (route/poll spans, "
                             "fleet.* counters) into the process recorder")
    ns = parser.parse_args(argv)

    replicas = [
        u.strip()
        for arg in ns.replica for u in arg.split(",") if u.strip()
    ]
    for url in replicas:
        if not url.startswith(("http://", "https://")):
            raise CLIError(
                f"--replica {url!r}: expected an http(s) base URL"
            )
    spill_models = [
        m.strip() for m in ns.spillover_models.split(",") if m.strip()
    ]
    policy = ns.spillover
    if policy is None:
        policy = "saturated" if spill_models else "off"
    if policy != "off" and not spill_models:
        raise CLIError(
            "--spillover requires --spillover-models (the remote panel)"
        )
    return ns, replicas, spill_models, policy


def route_main(
    argv: list[str],
    *,
    stdout: TextIO,
    stderr: TextIO,
    install_signal_handlers: bool = True,
    shutdown: Optional[threading.Event] = None,
) -> int:
    """The ``route`` subcommand body; returns the process exit code.
    ``shutdown`` is the stop signal (tests and in-process harnesses set
    it; production wires SIGTERM/SIGINT to it)."""
    from llm_consensus_tpu_torch import obs, serve
    from llm_consensus_tpu_torch.cli.main import DEFAULT_JUDGE, CLIError
    from llm_consensus_tpu_torch.serve.router import SpilloverPolicy

    ns, replicas, spill_models, policy = parse_route_args(argv)
    fleet = knobs.fleet_settings()
    elastic = knobs.elastic_settings()

    if ns.events and obs.recorder() is None:
        obs.install(obs.Recorder(max_events=knobs.telemetry_settings()["events_max"]))

    spill_registry = None
    spill_judge = None
    if spill_models:
        from llm_consensus_tpu_torch.providers.registry import remote_registry

        spill_judge = ns.spillover_judge or DEFAULT_JUDGE
        try:
            spill_registry = remote_registry(spill_models, spill_judge,
                                             **knobs.http_settings())
        except (ValueError, RuntimeError) as err:
            # ValueError: unknown catalog name; RuntimeError: a provider
            # refusing to build (missing API key) — both are user config.
            raise CLIError(f"spillover panel: {err}") from err

    log = None
    if not ns.quiet:
        log = lambda msg: stderr.write(msg + "\n")  # noqa: E731
    router = serve.build_router(
        replicas,
        poll_s=fleet["poll_s"] if ns.poll_s is None else ns.poll_s,
        suspect_after=fleet["suspect_after"],
        dead_after=fleet["dead_after"],
        revive_after=fleet["revive_after"],
        saturation=fleet["saturation"] if ns.saturation is None else ns.saturation,
        canary_fraction=fleet["canary_fraction"],
        spillover_registry=spill_registry,
        spillover_models=spill_models,
        spillover_judge=spill_judge,
        spillover_policy=SpilloverPolicy(
            policy, min_timeout_s=fleet["spillover_min_timeout_s"],
            max_priority=fleet["spillover_max_priority"]),
        min_replicas=(elastic["min_replicas"] if ns.min_replicas is None
                      else ns.min_replicas),
        max_replicas=(elastic["max_replicas"] if ns.max_replicas is None
                      else ns.max_replicas),
        elastic_settings=elastic,
        data_dir=ns.data_dir,
        save=ns.save,
        host=ns.host,
        port=ns.port,
        log=log,
    )
    try:
        host, port = router.start()
    except OSError as err:
        raise CLIError(f"binding {ns.host}:{ns.port}: {err}") from err
    if not ns.quiet:
        stderr.write(
            f"fleet router on http://{host}:{port} — "
            f"{len(replicas)} static replica(s), spillover={policy}"
            + (f" via {','.join(spill_models)}" if spill_models else "")
            + "\n"
        )

    stop = shutdown if shutdown is not None else threading.Event()
    if install_signal_handlers:
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, lambda *_: stop.set())
            except ValueError:
                break  # not the main thread (tests)
    stop.wait()
    router.close()
    return 0
