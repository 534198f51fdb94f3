"""CLI entry point of the port (``python -m llm_consensus_tpu_torch``).

A port of the consensus-run path of ``llm_consensus_tpu/cli/main.py`` with
these flags: ``--models``, ``--judge``, ``--file``, the positional prompt,
piped stdin, ``--output``, ``--data-dir``, ``--timeout``, ``--max-tokens``,
``--json``, ``--no-save`` and ``-q/--quiet``. Precedence and exit codes
follow the JAX CLI:

  * prompt: positional args > ``--file`` > piped stdin;
  * one provider per unique model, judge included; an unknown model fails
    at registry init with the available set;
  * the auto-saved run directory ``<data-dir>/<run-id>/`` is reserved
    before the fan-out, with the run manifest ``run.json`` (the JAX
    manifest's keys; flags the port lacks take the values the JAX CLI
    writes without them); each panel answer lands in
    ``panel/NNN-<slug>.json`` as its worker records it;
  * best-effort panel fan-out, panel agreement (``consensus/agreement.py``,
    scored on every run), judge synthesis, then ``result.json``,
    ``prompt.txt`` and ``consensus.md``; output routing ``--output`` file |
    auto-save | ``--json`` stdout | pretty TTY | JSON stdout;
  * errors print ``error: ...`` to stderr and exit 1.

Model names are ``gpu:<preset>``. ``main(argv, device=None)`` runs on the
current CUDA card and raises when there is none; tests pass
``device="cpu"``. The JAX CLI's other flags and ``--resume`` (the reader
of ``run.json`` and ``panel/``) are later work.

Run telemetry follows the JAX CLI: the live, attribution, roofline and
flight-recorder planes are on by default and installed here, before any
provider exists (the knobs of ``utils/knobs.py`` ``telemetry_settings``);
an auto-saved run writes ``metrics.json`` whenever one of them grew during
the run. ``--events`` (or ``LLMC_EVENTS``) adds the run recorder: the run
directory gains ``trace.json`` (Perfetto-loadable) and ``metrics.json``
gains ``counters`` and ``events``. ``--output``, ``--json`` and
``--no-save`` leave no run directory, and a recorded run says so in a
warning. ``--trace DIR`` writes a ``torch.profiler`` trace of the whole run
to ``DIR/trace.json``; ``--profile`` arms one bounded window of the deep
profiler (obs/profiler.py) around the run.

Quantization and continuous batching are chosen as in the JAX package,
through the environment only (``LLMC_QUANT``, ``LLMC_KV_QUANT``,
``LLMC_W8A8``, ``LLMC_DECODE_W8A8``, ``LLMC_DECODE_QSTRUCT``,
``LLMC_INT4_IMPL``; ``LLMC_MAX_BATCH`` or ``LLMC_BATCH_STREAMS``,
``LLMC_POOL_PREFIX``, ``LLMC_POOL_PREFIX_MIN``, ``LLMC_PREFILL_BUDGET``;
and ``LLMC_CHECKPOINT_DIR``, the per-preset checkpoint directory):
the default provider factory reads them here (utils/knobs.py), the one
place the port reads knobs, and an unknown mode or a refused setting fails
at registry init, before any engine is built.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, TextIO

from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.consensus import Judge, score_agreement
from llm_consensus_tpu_torch.obs import export as obs_export
from llm_consensus_tpu_torch.output import Result
from llm_consensus_tpu_torch.output.persist import reserve_run_dir, save_aux_files, save_file
from llm_consensus_tpu_torch.providers import Provider, Registry, Response
from llm_consensus_tpu_torch.runner import AllModelsFailed, Callbacks, Runner
from llm_consensus_tpu_torch.utils.context import Context
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_JUDGE = "gpu:llama-3-8b"
DEFAULT_TIMEOUT_S = 120

ProviderFactory = Callable[[str], Provider]


@dataclass
class Config:
    """Parsed CLI configuration."""

    models: list[str]
    judge: str = DEFAULT_JUDGE
    file: str = ""
    output: str = ""
    data_dir: str = "data"
    timeout: float = DEFAULT_TIMEOUT_S
    prompt: str = ""
    quiet: bool = False
    json: bool = False
    no_save: bool = False
    max_tokens: Optional[int] = None
    trace: str = ""        # torch.profiler trace of the run → DIR/trace.json
    events: bool = False   # run recorder → trace.json + metrics.json
    profile: bool = False  # one bounded deep-profiler window around the run


class CLIError(Exception):
    """User-facing CLI error → ``error: ...`` + exit 1."""


def create_provider(model: str, device: DeviceLike = None) -> Provider:
    """Resolve a model name to its provider: ``gpu:<preset>`` → the shared
    GPU provider of ``device`` and of the environment's quantization modes,
    batching settings and checkpoint directory."""
    from llm_consensus_tpu_torch.providers.gpu import SCHEME, GPUProvider, parse_model_name
    from llm_consensus_tpu_torch.utils.knobs import batch_settings, checkpoint_dir, quant_modes

    if not model.startswith(SCHEME):
        raise CLIError(f"unknown model {model!r}; available models: ['{SCHEME}<model>']")
    try:
        parse_model_name(model)
    except ValueError as err:
        raise CLIError(str(err)) from None
    return GPUProvider.shared(device, **batch_settings(), **quant_modes(), **checkpoint_dir())


def init_registry(models: list[str], judge: Optional[str],
                  factory: ProviderFactory) -> Registry:
    """One provider per unique model, judge included."""
    registry = Registry()
    for model in dict.fromkeys(models + ([judge] if judge else [])):
        try:
            provider = factory(model)
        except CLIError:
            raise
        except Exception as err:  # noqa: BLE001 — reported as a CLI error
            raise CLIError(f"initializing provider for {model}: {err}") from err
        registry.register(model, provider)
    return registry


def _is_terminal(stream) -> bool:
    try:
        return stream.isatty()
    except (AttributeError, ValueError):
        return False


def get_prompt(args: list[str], file: str, stdin: Optional[TextIO]) -> str:
    """Prompt precedence: positional > --file > piped stdin."""
    if args:
        return " ".join(args)
    if file:
        try:
            with open(file, "r", encoding="utf-8") as f:
                return f.read().strip()
        except OSError as err:
            raise CLIError(f"reading prompt file: {err}") from err
    if stdin is not None and not _is_terminal(stdin):
        return stdin.read().rstrip("\n")
    raise CLIError("no prompt provided: use positional argument, --file, or pipe to stdin")


def parse_args(argv: list[str], stdin: Optional[TextIO]) -> Config:
    parser = argparse.ArgumentParser(
        prog="llm-consensus-torch",
        description="Query multiple on-device LLMs in parallel and synthesize a "
                    "consensus answer (PyTorch/CUDA port).",
    )
    parser.add_argument("--models", "-models", default="", metavar="LIST",
                        help="Comma-separated list of gpu:<preset> models to query (required)")
    parser.add_argument("--judge", "-judge", default=DEFAULT_JUDGE,
                        help="Model to use for consensus synthesis")
    parser.add_argument("--file", "-file", default="", help="Read prompt from file")
    parser.add_argument("--output", "-output", default="",
                        help="Write JSON output to specific file (overrides auto-save)")
    parser.add_argument("--data-dir", "-data-dir", default="data",
                        help="Directory for auto-saved runs")
    parser.add_argument("--timeout", "-timeout", type=int, default=DEFAULT_TIMEOUT_S,
                        help="Per-model timeout in seconds")
    parser.add_argument("--max-tokens", "-max-tokens", type=int, default=None,
                        help="Max new tokens generated per model")
    parser.add_argument("--quiet", "-quiet", "-q", action="store_true",
                        help="Suppress progress output")
    parser.add_argument("--json", "-json", action="store_true",
                        help="Output JSON to stdout (no interactive display, no auto-save)")
    parser.add_argument("--no-save", "-no-save", action="store_true",
                        help="Don't auto-save results to data directory")
    parser.add_argument("--trace", "-trace", default="", metavar="DIR",
                        help="Write a torch.profiler trace of the run to DIR")
    parser.add_argument("--events", "-events", action="store_true",
                        help="Record the run's host telemetry timeline (spans/counters/"
                             "instants across engine, batcher, runner); persisted as "
                             "trace.json (Perfetto-loadable) + metrics.json in the run "
                             "dir. LLMC_EVENTS=1 is equivalent")
    parser.add_argument("--profile", "-profile", action="store_true",
                        help="Arm one bounded deep-profiling window (obs/profiler) "
                             "around the run, capped at LLMC_PROFILE_MAX_S and closed "
                             "when the run finishes. Unlike --trace it is rate-limited "
                             "and lands in an atomic artifact dir under LLMC_PROFILE_DIR")
    parser.add_argument("prompt", nargs="*", help="The prompt (or use --file / stdin)")
    ns = parser.parse_args(argv)
    if not ns.models:
        raise CLIError("--models flag is required")
    cfg = Config(
        models=[m.strip() for m in ns.models.split(",") if m.strip()],
        judge=ns.judge,
        file=ns.file,
        output=ns.output,
        data_dir=ns.data_dir,
        timeout=float(ns.timeout),
        quiet=ns.quiet,
        json=ns.json,
        no_save=ns.no_save,
        max_tokens=ns.max_tokens,
        trace=ns.trace,
        events=ns.events,
        profile=ns.profile,
    )
    cfg.prompt = get_prompt(ns.prompt, ns.file, stdin)
    return cfg


class _Progress:
    """Plain progress lines on stderr (only when it is a terminal)."""

    def __init__(self, stream: TextIO, enabled: bool) -> None:
        self._stream = stream
        self._enabled = enabled

    def line(self, text: str) -> None:
        if self._enabled:
            self._stream.write(text + "\n")
            self._stream.flush()

    def callbacks(self) -> Callbacks:
        return Callbacks(
            on_model_start=lambda m: self.line(f"  … {m}"),
            on_model_complete=lambda m: self.line(f"  ✓ {m}"),
            on_model_error=lambda m, err: self.line(f"  ✗ {m}: {err}"),
        )


def _slug(model: str) -> str:
    """Filesystem-safe model-name slug for panel journal files."""
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in model)


def write_run_manifest(run_dir: str, cfg: Config, warn=None) -> None:
    """The run's identity in ``run.json``, written before the fan-out: the
    JAX manifest's keys, the flags the port lacks at the values the JAX
    CLI writes without them."""
    manifest = {
        "prompt": cfg.prompt,
        "models": list(cfg.models),
        "judge": cfg.judge,
        "system": "",
        "max_tokens": cfg.max_tokens,
        "timeout": cfg.timeout,
        "rounds": 1,
        "vote": False,
        "options": [],
        "confidence": False,
        "history": [],
    }
    save_file(run_dir, "run.json", json.dumps(manifest, indent=2), warn=warn)


def panel_journal(run_dir: str, warn=None) -> Callable[[Response], None]:
    """The hook that writes each panel answer into
    ``<run_dir>/panel/NNN-<slug>.json`` (atomic ``save_file``), numbering
    past the highest file already there."""
    panel_dir = os.path.join(run_dir, "panel")
    lock = threading.Lock()
    nxt = 0
    if os.path.isdir(panel_dir):
        for name in os.listdir(panel_dir):
            head = name.split("-", 1)[0]
            if head.isdigit():
                nxt = max(nxt, int(head) + 1)
    counter = [nxt]

    def journal(resp: Response) -> None:
        with lock:
            n = counter[0]
            counter[0] += 1
        save_file(panel_dir, f"{n:03d}-{_slug(resp.model)}.json",
                  json.dumps(resp.to_dict(), indent=2), warn=warn)

    return journal


def install_planes(events: bool, stderr: TextIO) -> None:
    """Install the telemetry planes from the environment before any
    provider exists (consumers bind them at construction). Each plane is
    decided once per process; the recorder is per run: ``events`` (the
    flag) or ``LLMC_EVENTS`` installs it, otherwise a previous run's
    recorder is dropped."""
    from llm_consensus_tpu_torch.obs import attrib, blackbox, live, profiler, roofline
    from llm_consensus_tpu_torch.utils.knobs import telemetry_settings

    st = telemetry_settings()
    if events or st["events"]:
        if obs.recorder() is None:
            from llm_consensus_tpu_torch.providers.gpu import GPUProvider

            if GPUProvider._shared:
                stderr.write(
                    "warning: --events enabled after the shared gpu provider was built; "
                    "its warm engines will not record device spans this run (use "
                    "--events from the first run of the process, or LLMC_EVENTS=1)\n")
            obs.install(obs.Recorder(max_events=st["events_max"]))
    else:
        obs.install(None)
    if not live.resolved():
        live.install(live.LiveMetrics(st["live_window_s"], st["live_windows"])
                     if st["live"] else None)
    if not attrib.resolved():
        attrib.install(attrib.ChipTimeLedger(st["attrib_warmup_s"], st["attrib_hbm_high"])
                       if st["attrib"] else None)
    if not roofline.resolved():
        roofline.install(roofline.RooflineLedger(st["roofline_ridge"], st["roofline_tol"])
                         if st["roofline"] else None)
    if not blackbox.resolved():
        blackbox.install(blackbox.FlightRecorder(
            st["blackbox_events"], st["blackbox_dir"] or blackbox.DEFAULT_DIR,
            st["blackbox_min_interval_s"]) if st["blackbox"] else None)
    if not profiler.resolved():
        profiler.install(profiler.DeepProfiler(
            st["profile_dir"] or profiler.DEFAULT_DIR, st["profile_max_s"],
            st["profile_min_interval_s"]) if st["profile"] else None)


def run(cfg: Config, ctx: Context, *, factory: ProviderFactory, stdout: TextIO,
        stderr: TextIO) -> Optional[Result]:
    """One consensus run with the telemetry planes installed; ``--trace``
    wraps it in a ``torch.profiler`` trace, ``--profile`` in one bounded
    deep-profiler window."""
    install_planes(cfg.events, stderr)

    def body() -> Result:
        return _run(cfg, ctx, factory=factory, stdout=stdout, stderr=stderr)

    if cfg.trace:
        from llm_consensus_tpu_torch.obs.profiler import trace_window

        try:
            window = trace_window(cfg.trace)
            window.__enter__()
        except Exception as err:  # noqa: BLE001 — reported as a CLI error
            raise CLIError(f"starting profiler trace: {err}") from err
        try:
            return body()
        finally:
            window.__exit__(None, None, None)
    if not cfg.profile:
        return body()
    # --profile: one bounded window through the deep profiler, closed when
    # the run finishes. Force-installed like --events: the flag overrides a
    # profiler disabled by the environment.
    from llm_consensus_tpu_torch.obs import profiler as profiler_mod

    prof = profiler_mod.profiler()
    if prof is None:
        prof = profiler_mod.DeepProfiler()
        profiler_mod.install(prof)
    path, status = prof.arm(prof.max_s, tag="cli")
    if status != "armed":
        stderr.write(f"warning: --profile window not armed ({status})\n")
        return body()
    try:
        return body()
    finally:
        final = prof.stop_now() or path
        if final:
            stderr.write(f"profile artifact: {final}\n")


def _close_expired_profile() -> None:
    """A phase boundary of the run: close a --profile window past its
    bound."""
    prof = obs.profiler.profiler()
    if prof is not None:
        prof.stop_if_expired()


def _run(cfg: Config, ctx: Context, *, factory: ProviderFactory, stdout: TextIO,
         stderr: TextIO) -> Result:
    """One consensus run: fan-out, judge synthesis, persistence, output."""
    show_ui = _is_terminal(stderr) and not cfg.quiet and not cfg.json
    progress = _Progress(stderr, show_ui)
    start_time = time.monotonic()
    # Per-run telemetry reset at entry; the process-lifetime planes get
    # watermarks, so a run that moved none of them writes no metrics.json.
    recorder = obs.recorder()
    if recorder is not None:
        recorder.clear()
    live_plane, attrib_led, roofline_led = (
        obs.live.metrics(), obs.attrib.ledger(), obs.roofline.ledger())
    live0 = live_plane.counts() if live_plane is not None else 0
    attrib0 = attrib_led.activity() if attrib_led is not None else 0
    roofline0 = roofline_led.activity() if roofline_led is not None else 0
    registry = init_registry(cfg.models, cfg.judge, factory)

    # Announce the run before any query: the GPU provider builds its
    # kernels here, outside every model's deadline.
    seen: set = set()
    for model in dict.fromkeys(cfg.models + [cfg.judge]):
        provider = registry.get(model)
        if id(provider) in seen:
            continue
        seen.add(id(provider))
        try:
            provider.prepare(cfg.models, cfg.judge)
        except Exception as err:  # noqa: BLE001 — reported as a CLI error
            raise CLIError(f"preparing provider: {err}") from err

    # The run directory and its manifest before the fan-out; each panel
    # answer is journaled into it as it lands.
    warn = progress.line if show_ui else None
    run_dir = ""
    if not cfg.output and not cfg.json and not cfg.no_save:
        try:
            _run_id, run_dir = reserve_run_dir(cfg.data_dir)
        except OSError as err:
            raise CLIError(f"creating run directory: {err}") from err
        write_run_manifest(run_dir, cfg, warn=warn)

    progress.line("Querying models...")
    runner = Runner(registry, cfg.timeout, max_tokens=cfg.max_tokens)
    callbacks = progress.callbacks()
    if run_dir:
        callbacks.on_model_response = panel_journal(run_dir, warn=warn)
    runner.with_callbacks(callbacks)
    try:
        result = runner.run(ctx, cfg.models, cfg.prompt)
    except AllModelsFailed as err:
        raise CLIError(f"running queries: {err}") from err
    _close_expired_profile()
    agreement = score_agreement(result.responses)
    progress.line(f"Received responses from {len(result.responses)} models")
    if agreement is not None:
        progress.line(f"Panel agreement: {agreement.level} ({agreement.score:.2f})")

    progress.line("Synthesizing consensus...")
    try:
        judge_provider = registry.get(cfg.judge)
    except Exception as err:  # noqa: BLE001
        raise CLIError(f"judge model {cfg.judge}: {err}") from err
    judge = Judge(judge_provider, cfg.judge, max_tokens=cfg.max_tokens)
    try:
        consensus = judge.synthesize_stream(ctx, cfg.prompt, result.responses, None)
    except Exception as err:  # noqa: BLE001
        raise CLIError(f"consensus synthesis: {err}") from err
    if judge.last_truncated:
        result.warnings.append(f"{cfg.judge}: judge prompt truncated to fit context window")
    _close_expired_profile()

    # Run telemetry rides the auto-saved run directory; a recorded run
    # that has none says so instead of discarding it silently.
    trace_doc = metrics_doc = None
    if recorder is not None and not run_dir:
        result.warnings.append(
            "run telemetry recorded but not persisted: trace.json/metrics.json ride the "
            "auto-saved run directory, which --output, --json, and --no-save disable")
    if recorder is not None and run_dir:
        trace_doc = obs_export.local_trace(recorder)
        metrics_doc = obs_export.metrics_summary(
            recorder, responses=result.responses,
            batcher_stats=obs_export.collect_batcher_stats(registry),
            kv_stats=obs_export.collect_kv_stats(registry),
            spec_stats=obs_export.collect_spec_stats(registry),
            disagg_stats=obs_export.collect_disagg_stats(registry),
            failed_models=result.failed_models, warnings=result.warnings,
            live=obs_export.live_summary(), attrib=obs_export.attrib_summary(),
            roofline=obs_export.roofline_summary(),
        )
    elif run_dir:
        # Without the recorder, the planes' numbers persist whenever this
        # run moved them (the process-lifetime snapshot, as a scrape shows).
        live_doc = (obs_export.live_summary(live_plane)
                    if live_plane is not None and live_plane.counts() > live0 else None)
        attrib_grew = attrib_led is not None and attrib_led.activity() > attrib0
        roofline_grew = roofline_led is not None and roofline_led.activity() > roofline0
        if live_doc or attrib_grew or roofline_grew:
            metrics_doc = obs_export.metrics_summary(
                responses=result.responses, failed_models=result.failed_models,
                warnings=result.warnings, live=live_doc,
                attrib=obs_export.attrib_summary(), roofline=obs_export.roofline_summary(),
            )

    out = Result(
        prompt=cfg.prompt,
        responses=result.responses,
        consensus=consensus,
        judge=cfg.judge,
        warnings=result.warnings,
        failed_models=result.failed_models,
        agreement=agreement.to_dict() if agreement else None,
    )

    output_path = cfg.output
    if not output_path and run_dir:
        try:
            output_path = save_aux_files(run_dir, cfg.prompt, consensus, warn=warn)
        except OSError as err:
            raise CLIError(f"creating run directory: {err}") from err
    if metrics_doc is not None:
        obs_export.save_run_telemetry(run_dir, trace_doc, metrics_doc, warn=warn)
    if output_path:
        errors: list[str] = []
        written = save_file(
            os.path.dirname(output_path) or ".", os.path.basename(output_path),
            out.to_json(), warn=errors.append,
        )
        if written is None:
            raise CLIError("creating output file: " + (errors[0] if errors else output_path))
        progress.line(f"Run saved to {os.path.dirname(output_path) or '.'}")
    elif cfg.json:
        stdout.write(out.to_json())
    elif show_ui:
        for resp in result.responses:
            stderr.write(f"\n--- {resp.model} ({resp.latency_ms:.0f} ms) ---\n{resp.content}\n")
        stderr.write(f"\n=== Consensus ===\n{consensus}\n")
        stderr.write(
            f"\n{len(result.responses)}/{len(cfg.models)} models responded, "
            f"{len(result.failed_models)} failed, {time.monotonic() - start_time:.1f}s\n"
        )
        print_throughput(stderr, result.responses)
        if recorder is not None:
            print_aggregate(stderr, obs_export.aggregate_throughput(recorder))
        for w in result.warnings:
            stderr.write(f"warning: {w}\n")
    else:
        stdout.write(out.to_json())
    return out


def print_throughput(w: TextIO, responses) -> None:
    """One line per response with decode measurements: tokens, steady
    decode tokens/s, MBU and MFU where the card's peaks are known; nothing
    when no response has them."""
    stats = [r for r in responses if r.tokens_per_sec]
    if not stats:
        return
    w.write("\n─── Throughput (on-device) ───\n")
    for r in stats:
        line = f"{r.model}: {r.tokens} tokens, {r.tokens_per_sec:.1f} tok/s"
        if r.mbu is not None:
            line += f", {r.mbu * 100:.0f}% MBU"
        if r.mfu is not None:
            line += f", {r.mfu * 100:.1f}% MFU"
        w.write(line + "\n")


def print_aggregate(w: TextIO, aggregate: Optional[dict]) -> None:
    """The pool-wide line from the recorder's aggregate (tokens over the
    union of the run's decode window, the token-weighted MFU)."""
    if not aggregate or not aggregate.get("tokens") or not aggregate.get("tokens_per_sec"):
        return
    line = f"Pool: {int(aggregate['tokens'])} tokens, {aggregate['tokens_per_sec']:.1f} tok/s"
    if aggregate.get("mfu"):
        line += f", {aggregate['mfu'] * 100:.1f}% MFU"
    w.write(line + "\n")


def main(
    argv: Optional[list[str]] = None,
    *,
    device: DeviceLike = None,
    factory: Optional[ProviderFactory] = None,
    stdin: Optional[TextIO] = None,
    stdout: Optional[TextIO] = None,
    stderr: Optional[TextIO] = None,
    install_signal_handlers: bool = True,
) -> int:
    """Run the CLI; returns the exit code. ``device=None`` resolves to the
    current CUDA card and raises ``RuntimeError`` when there is none."""
    argv = sys.argv[1:] if argv is None else argv
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    ctx = Context.background().with_cancel()
    if install_signal_handlers:
        # SIGINT/SIGTERM → graceful context cancel.
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, lambda *_: ctx.cancel())
            except ValueError:
                break  # not the main thread
    try:
        cfg = parse_args(argv, stdin)
        if factory is None:
            dev = resolve_device(device)

            def factory(model: str) -> Provider:
                return create_provider(model, dev)

        run(cfg, ctx, factory=factory, stdout=stdout, stderr=stderr)
    except CLIError as err:
        stderr.write(f"error: {err}\n")
        return 1
    except SystemExit as err:  # argparse --help / parse errors
        return int(err.code or 0)
    finally:
        ctx.close()
    return 0
