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
``device="cpu"``. The JAX CLI's other flags, ``--resume`` (the reader of
``run.json`` and ``panel/``) and ``metrics.json`` are later work.

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

from llm_consensus_tpu_torch.consensus import Judge, score_agreement
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


def run(cfg: Config, ctx: Context, *, factory: ProviderFactory, stdout: TextIO,
        stderr: TextIO) -> Result:
    """One consensus run: fan-out, judge synthesis, persistence, output."""
    show_ui = _is_terminal(stderr) and not cfg.quiet and not cfg.json
    progress = _Progress(stderr, show_ui)
    start_time = time.monotonic()
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
        for w in result.warnings:
            stderr.write(f"warning: {w}\n")
    else:
        stdout.write(out.to_json())
    return out


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
