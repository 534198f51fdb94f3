"""``llm-consensus serve`` — the resident consensus service (port of
``llm_consensus_tpu/cli/serve.py``).

Where the plain CLI pays a full process lifecycle per prompt, ``serve``
builds the registry and engines once and keeps them warm behind the HTTP
gateway (llm_consensus_tpu/serve/): compiled programs, weights, and the
continuous batcher stay resident, and many concurrent consensus runs
multiplex onto them.

Capacity model: each concurrent run sends one stream per panel model to
that preset's continuous batcher (``max_batch`` slots per preset), so
the admission concurrency cap and the batcher depth are the SAME budget
viewed from two layers. ``--max-batch`` (or ``LLMC_MAX_BATCH``) sets the
batcher depth; the default admission cap is derived from it, and an
explicit ``--max-concurrency`` that oversubscribes the batcher is
rejected at startup — a misconfigured server must fail fast, not queue
inside the submit path where nothing can shed load.

SIGTERM/SIGINT drain gracefully: stop admitting (new requests get 503 +
``Retry-After``), finish in-flight runs, flush every ``data/<run-id>/``,
then exit.

The environment is read once, through ``utils/knobs.py``, and its settings
go to the provider, the gateway and the governor as arguments; nothing is
written back into ``os.environ``. ``serve_main(device=None)`` runs on the
current CUDA card and raises without one; tests pass ``device="cpu"``.
``--announce URL`` (or ``LLMC_FLEET_ANNOUNCE``) registers the gateway with a
fleet router (``route``) by periodic heartbeat (``LLMC_FLEET_HEARTBEAT_S``).
``--disagg`` (or ``LLMC_DISAGG``) turns on disaggregated prefill → decode
(engine/handoff.py) and implies the KV pool, the handoff channel (unless
``LLMC_KV_POOL`` says otherwise), both as the provider's arguments; it acts
on the batched path only (``--max-batch`` above 1).
"""

from __future__ import annotations

import argparse
import signal
import threading
from dataclasses import dataclass
from typing import Optional, TextIO

from llm_consensus_tpu_torch import ui
from llm_consensus_tpu_torch.utils import knobs
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_MAX_BATCH = 8
# HTTP-only panels have no device budget to derive a cap from; this is a
# plain thread-count default, unrelated to the batcher depth.
DEFAULT_HTTP_CONCURRENCY = 8
DEFAULT_QUEUE_DEPTH = 16
DEFAULT_CACHE_SIZE = 256
DEFAULT_CACHE_TTL_S = 300.0


@dataclass
class ServeConfig:
    models: list[str]
    judge: str
    host: str = "127.0.0.1"
    port: int = 8080
    timeout: float = 120.0
    max_tokens: Optional[int] = None
    system: str = ""
    data_dir: str = "data"
    no_save: bool = False
    max_batch: int = DEFAULT_MAX_BATCH
    max_concurrency: Optional[int] = None  # None → derived from max_batch
    queue_depth: int = DEFAULT_QUEUE_DEPTH
    cache_size: int = DEFAULT_CACHE_SIZE
    cache_ttl: float = DEFAULT_CACHE_TTL_S
    quiet: bool = False
    events: bool = False
    prefill_budget: Optional[int] = None  # None → LLMC_PREFILL_BUDGET
    judge_overlap: bool = False
    announce: str = ""  # fleet router URL to heartbeat-register with
    draft: str = ""  # speculative decoding ("lookup" batches; see --draft)
    spec_k: Optional[int] = None  # draft-length ceiling per round
    no_live: bool = False  # disable the /metricsz live plane + blackbox
    blackbox_dir: str = ""  # flight-recorder dump dir (LLMC_BLACKBOX_DIR)
    slo_ttft_p99: Optional[float] = None  # SLO burn threshold seconds
    disagg: bool = False  # disaggregated prefill → decode (implies the KV pool)


def parse_serve_args(argv: list[str]) -> ServeConfig:
    from llm_consensus_tpu_torch.cli.main import DEFAULT_JUDGE, DEFAULT_TIMEOUT_S, CLIError

    parser = argparse.ArgumentParser(
        prog="llm-consensus serve",
        description="Serve consensus over HTTP from resident engines.",
    )
    parser.add_argument("--models", "-models", default="", metavar="LIST",
                        help="Comma-separated panel models (required)")
    parser.add_argument("--judge", "-judge", default=DEFAULT_JUDGE,
                        help="Model for consensus synthesis")
    parser.add_argument("--host", "-host", default="127.0.0.1",
                        help="Bind address (default 127.0.0.1)")
    parser.add_argument("--port", "-port", type=int, default=8080,
                        help="Bind port (0 = OS-assigned)")
    parser.add_argument("--timeout", "-timeout", type=int,
                        default=DEFAULT_TIMEOUT_S,
                        help="Default per-request timeout in seconds")
    parser.add_argument("--max-tokens", "-max-tokens", type=int, default=None,
                        help="Default max tokens generated per model")
    parser.add_argument("--system", "-system", default="",
                        help="Default system prompt for panel models")
    parser.add_argument("--data-dir", "-data-dir", default="data",
                        help="Directory for per-request run dirs")
    parser.add_argument("--no-save", "-no-save", action="store_true",
                        help="Don't persist run dirs")
    parser.add_argument("--max-batch", "-max-batch", type=int, default=None,
                        help="Continuous-batcher slots per gpu preset "
                             f"(default LLMC_MAX_BATCH or {DEFAULT_MAX_BATCH})")
    parser.add_argument("--max-concurrency", "-max-concurrency", type=int,
                        default=None,
                        help="Concurrent consensus runs (default derived "
                             "from --max-batch / panel shape)")
    parser.add_argument("--queue-depth", "-queue-depth", type=int,
                        default=DEFAULT_QUEUE_DEPTH,
                        help="Requests allowed to wait for a slot before "
                             "429s (0 = reject when saturated)")
    parser.add_argument("--cache-size", "-cache-size", type=int,
                        default=DEFAULT_CACHE_SIZE,
                        help="Consensus result cache entries (0 disables)")
    parser.add_argument("--cache-ttl", "-cache-ttl", type=float,
                        default=DEFAULT_CACHE_TTL_S,
                        help="Cache entry TTL in seconds")
    parser.add_argument("--prefill-budget", "-prefill-budget", type=int,
                        default=None, metavar="TOKENS",
                        help="Interleaved admission prefill: dispatch at "
                             "most this many prompt tokens of a new "
                             "stream's prefill between decode chunks, so "
                             "resident streams keep decoding during "
                             "admission (0/unset = classic; "
                             "LLMC_PREFILL_BUDGET equivalent)")
    parser.add_argument("--judge-overlap", "-judge-overlap",
                        action="store_true",
                        help="Prefill each run's judge prompt "
                             "incrementally as panel answers arrive "
                             "(gpu judges); LLMC_JUDGE_OVERLAP=1 "
                             "equivalent")
    parser.add_argument("--draft", "-draft", default="", metavar="SPEC",
                        help="Speculative decoding for gpu models: "
                             "'lookup' (prompt-lookup n-grams — zero draft "
                             "cost, composes with the continuous batcher: "
                             "pools run batched spec rounds), a draft "
                             "preset for every target, or target=draft "
                             "pairs (a=b,c=d). Greedy output is "
                             "token-exact; LLMC_DRAFT equivalent")
    parser.add_argument("--spec-k", "-spec-k", type=int, default=None,
                        metavar="K",
                        help="Speculative draft-length ceiling per round "
                             "(default LLMC_SPEC_K or 4); adaptive k walks "
                             "a pow2 ladder below it")
    parser.add_argument("--disagg", "-disagg", action="store_true",
                        help="Disaggregated prefill/decode serving: a "
                             "prefill worker hands each batched request's "
                             "prompt KV to the decode pool (implies the KV "
                             "pool; LLMC_DISAGG equivalent)")
    parser.add_argument("--announce", "-announce", default="", metavar="URL",
                        help="Fleet router base URL to register with by "
                             "periodic heartbeat (LLMC_FLEET_ANNOUNCE "
                             "equivalent)")
    parser.add_argument("--no-live", "-no-live", action="store_true",
                        help="Disable the live observability plane "
                             "(GET /metricsz histograms + the always-on "
                             "flight recorder + chip-time attribution; "
                             "LLMC_LIVE=0 LLMC_BLACKBOX=0 LLMC_ATTRIB=0 "
                             "equivalent)")
    parser.add_argument("--blackbox-dir", "-blackbox-dir", default="",
                        metavar="DIR",
                        help="Flight-recorder dump directory "
                             "(default LLMC_BLACKBOX_DIR or data/_artifacts/blackbox)")
    parser.add_argument("--slo-ttft-p99", "-slo-ttft-p99", type=float,
                        default=None, metavar="SECONDS",
                        help="SLO burn trigger: p99 TTFT over this for "
                             "LLMC_SLO_WINDOWS consecutive windows dumps "
                             "the flight recorder (LLMC_SLO_TTFT_P99_S "
                             "equivalent; unset disables)")
    parser.add_argument("--quiet", "-quiet", "-q", action="store_true",
                        help="Suppress the banner and request log")
    parser.add_argument("--events", "-events", action="store_true",
                        help="Record run telemetry; each run dir gets "
                             "trace.json + metrics.json with the serve-side "
                             "spans (queue_wait/admit) and instants "
                             "(cache_hit/coalesced)")
    ns = parser.parse_args(argv)

    if not ns.models:
        raise CLIError("--models flag is required")
    models = [m.strip() for m in ns.models.split(",") if m.strip()]
    if not models:
        raise CLIError("--models flag is required")
    env = knobs.serve_settings()
    max_batch = ns.max_batch if ns.max_batch is not None else (env["max_batch"] or DEFAULT_MAX_BATCH)
    if max_batch < 1:
        raise CLIError("--max-batch must be >= 1")
    if ns.max_concurrency is not None and ns.max_concurrency < 1:
        raise CLIError("--max-concurrency must be >= 1")
    if ns.queue_depth < 0:
        raise CLIError("--queue-depth must be >= 0")
    if ns.timeout <= 0:
        raise CLIError("--timeout must be > 0")
    if ns.cache_size < 0:
        raise CLIError("--cache-size must be >= 0")
    return ServeConfig(
        models=models,
        judge=ns.judge,
        host=ns.host,
        port=ns.port,
        timeout=float(ns.timeout),
        max_tokens=ns.max_tokens,
        system=ns.system,
        data_dir=ns.data_dir,
        no_save=ns.no_save,
        max_batch=max_batch,
        max_concurrency=ns.max_concurrency,
        queue_depth=ns.queue_depth,
        cache_size=ns.cache_size,
        cache_ttl=ns.cache_ttl,
        quiet=ns.quiet,
        events=ns.events,
        prefill_budget=ns.prefill_budget,
        judge_overlap=ns.judge_overlap,
        announce=ns.announce or env["announce"],
        draft=ns.draft,
        spec_k=ns.spec_k,
        no_live=ns.no_live,
        blackbox_dir=ns.blackbox_dir,
        slo_ttft_p99=ns.slo_ttft_p99,
        disagg=ns.disagg or env["disagg"],
    )


def _gpu_multiplicity(models: list[str], judge: str) -> int:
    """Peak concurrent streams one gpu preset sees from ONE run.

    A preset asked for N times in the panel contributes N concurrent
    streams; a judge sharing a panel preset can overlap another run's
    panel query on that preset, so it counts too."""
    from llm_consensus_tpu_torch.providers.gpu import SCHEME, parse_model_name

    counts: dict[str, int] = {}
    for m in models + [judge]:
        if m.startswith(SCHEME):
            preset = parse_model_name(m)
            counts[preset] = counts.get(preset, 0) + 1
    return max(counts.values(), default=0)


def resolve_concurrency(cfg: ServeConfig) -> int:
    """Derive (or validate) the admission cap against batcher capacity."""
    from llm_consensus_tpu_torch.cli.main import CLIError

    mult = _gpu_multiplicity(cfg.models, cfg.judge)
    if cfg.max_concurrency is None:
        if mult == 0:
            return DEFAULT_HTTP_CONCURRENCY  # HTTP-only: no device budget
        return max(1, cfg.max_batch // mult)
    if mult and cfg.max_concurrency * mult > cfg.max_batch:
        raise CLIError(
            f"--max-concurrency {cfg.max_concurrency} oversubscribes the "
            f"continuous batcher: the panel/judge put up to {mult} "
            f"concurrent stream(s) per gpu preset per run, needing "
            f"{cfg.max_concurrency * mult} slots > --max-batch "
            f"{cfg.max_batch}; raise --max-batch or lower --max-concurrency"
        )
    return cfg.max_concurrency


def _gpu_provider(cfg: ServeConfig, device):
    """The server's one provider for every gpu: model, sized to
    --max-batch, with the environment's modes and the flags' overrides
    (the server owns its engines: no shared-provider indirection)."""
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.recovery import StreamJournal

    batching = knobs.batch_settings()
    batching["batch_streams"] = cfg.max_batch
    if cfg.prefill_budget is not None:
        batching["prefill_budget"] = max(0, cfg.prefill_budget)
    spec = knobs.spec_settings()
    if cfg.draft:
        spec["draft"] = cfg.draft
    if cfg.spec_k is not None:
        spec["spec_k"] = max(1, cfg.spec_k)
    recovery = knobs.recovery_settings()
    journal = recovery.pop("journal")
    jr = StreamJournal(path=None if journal == "1" else journal) if journal else None
    disagg = knobs.disagg_settings()
    disagg["disagg"] = cfg.disagg
    return GPUProvider(device=device, journal=jr, swap_wait_s=knobs.serve_settings()["swap_wait_s"],
                       **batching, **knobs.quant_modes(), **knobs.checkpoint_dir(),
                       **knobs.prefix_settings(), **knobs.kv_pool_settings(default_on=cfg.disagg),
                       **recovery, **spec, **knobs.engine_settings(), **disagg)


def serve_main(
    argv: list[str],
    *,
    stdout: TextIO,
    stderr: TextIO,
    install_signal_handlers: bool = True,
    shutdown: Optional[threading.Event] = None,
    device: DeviceLike = None,
) -> int:
    """The ``serve`` subcommand body; returns the process exit code.

    ``shutdown`` is the stop signal (tests and in-process harnesses set it;
    production wires SIGTERM/SIGINT to it). ``device=None`` is the current
    CUDA card (raises without one)."""
    from llm_consensus_tpu_torch import obs, serve
    from llm_consensus_tpu_torch.cli.main import (
        CLIError, create_provider, init_registry, install_planes)
    from llm_consensus_tpu_torch.pressure import parse_judge_fallback
    from llm_consensus_tpu_torch.providers.gpu import SCHEME, parse_model_name

    cfg = parse_serve_args(argv)
    max_concurrency = resolve_concurrency(cfg)
    dev = resolve_device(device)

    # The planes first: providers, batchers and the gateway bind them at
    # construction.
    install_planes(cfg.events, stderr, blackbox_dir=cfg.blackbox_dir)
    if cfg.no_live:
        obs.live.install(None)
        obs.blackbox.install(None)
        obs.attrib.install(None)
    settings = knobs.serve_settings()
    live = knobs.live_settings()
    pressure = knobs.pressure_settings()
    pressure["judge_fallback"] = parse_judge_fallback(pressure["judge_fallback"])
    slo = cfg.slo_ttft_p99 if cfg.slo_ttft_p99 is not None else live["slo_ttft_p99_s"]

    gpu_provider: list = []

    def factory(model: str):
        if model.startswith(SCHEME):
            try:
                parse_model_name(model)
            except ValueError as err:
                raise CLIError(str(err)) from None
            if not gpu_provider:
                gpu_provider.append(_gpu_provider(cfg, dev))
            return gpu_provider[0]
        return create_provider(model, device=dev)

    registry = init_registry(cfg.models, cfg.judge, factory)
    seen: set = set()
    for model in registry.models():
        provider = registry.get(model)
        if id(provider) in seen:
            continue
        seen.add(id(provider))
        try:
            provider.prepare(cfg.models, cfg.judge)
        except Exception as err:
            raise CLIError(f"planning device placement: {err}") from err

    log = None
    if not cfg.quiet:
        log = lambda msg: stderr.write(msg + "\n")  # noqa: E731
    gateway = serve.build_gateway(
        registry,
        cfg.models,
        cfg.judge,
        system=cfg.system or None,
        max_tokens=cfg.max_tokens,
        timeout=cfg.timeout,
        max_concurrency=max_concurrency,
        max_queue=cfg.queue_depth,
        cache_size=cfg.cache_size,
        cache_ttl_s=cfg.cache_ttl,
        data_dir=cfg.data_dir,
        save=not cfg.no_save,
        host=cfg.host,
        port=cfg.port,
        log=log,
        pressure=pressure,
        judge_overlap=cfg.judge_overlap or knobs.judge_overlap(),
        stall_grace=knobs.stall_grace(),
        warm_s=settings["elastic_warm_s"],
        quarantine_after=settings["quarantine_after"],
        probe_n=settings["probe_n"],
        slo_ttft_p99_s=slo,
        slo_windows=live["slo_windows"],
        migrate_timeout_s=knobs.elastic_settings()["migrate_timeout_s"],
        features={
            "kv_pool": bool(gpu_provider) and gpu_provider[0].kv["kv_pool"],
            "spec": bool(gpu_provider) and bool(gpu_provider[0]._draft_map),
            "disagg": bool(gpu_provider) and gpu_provider[0].disagg["disagg"],
        },
    )
    try:
        try:
            host, port = gateway.start()
        except OSError as err:
            raise CLIError(
                f"binding {cfg.host}:{cfg.port}: {err}"
            ) from err
        if not cfg.quiet:
            ui.print_serve_banner(
                stderr, host, port, cfg.models, cfg.judge,
                max_concurrency=max_concurrency, max_batch=cfg.max_batch,
            )
        if cfg.announce:
            # Fleet membership: heartbeat-register with the router so it
            # places requests here without static --replica config.
            gateway.announce(cfg.announce, interval_s=knobs.fleet_settings()["heartbeat_s"])
            if not cfg.quiet:
                stderr.write(f"announcing to fleet router {cfg.announce}\n")

        stop = shutdown if shutdown is not None else threading.Event()
        if install_signal_handlers:
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    signal.signal(sig, lambda *_: stop.set())
                except ValueError:
                    break  # not the main thread (tests)
            if hasattr(signal, "SIGQUIT"):
                # kill -QUIT <pid> = on-demand flight-recorder dump (same
                # rate-limited path as POST /debugz/blackbox).
                try:
                    signal.signal(
                        signal.SIGQUIT,
                        lambda *_: gateway.debug_blackbox("sigquit"),
                    )
                except ValueError:
                    pass
        stop.wait()
        if not cfg.quiet:
            ui.print_phase(stderr, "Draining: finishing in-flight runs...")
        drained = gateway.close(drain=True, timeout=max(cfg.timeout, 1.0))
        if not cfg.quiet:
            if drained:
                ui.print_success(stderr, "Drained cleanly; all runs flushed")
            else:
                ui.print_error(stderr, "Drain timed out; stragglers cancelled")
        return 0 if drained else 1
    finally:
        # The server owned its engines: free them with it (an in-process
        # caller gets the card's memory back).
        for provider in gpu_provider:
            provider.release()
