"""CLI entry point of the port (``python -m llm_consensus_tpu_torch``).

A port of the consensus-run path of ``llm_consensus_tpu/cli/main.py``: its
flags, their validation and messages, precedence and exit codes.

  * prompt: positional args > ``--file`` > piped stdin;
  * the config file (``.llm-consensus.json`` in the working directory,
    else ``~/.llm-consensus.json``; ``LLMC_CONFIG=<path>`` overrides the
    search, ``LLMC_CONFIG=0`` disables it) gives flag defaults and
    ``@alias`` model lists; explicit flags win. ``--version`` and
    ``--help`` never read it;
  * one provider per unique model, judge included (the panel only under
    ``--vote``): ``gpu:<preset>`` is the device provider, any other name
    one of the remote HTTP providers of the JAX package's catalog
    (``providers/registry.py`` ``REMOTE_MODELS``; keys and base URLs from
    ``OPENAI_API_KEY``/``OPENAI_BASE_URL`` and the Anthropic and Google
    equivalents); an unknown model fails at registry init with the
    available set;
  * the auto-saved run directory ``<data-dir>/<run-id>/`` is reserved
    before the fan-out, with the run manifest ``run.json`` (prompt, panel,
    judge and every setting that changes what the models see); each panel
    answer lands in ``panel/NNN-<slug>.json`` as its worker records it.
    ``--resume RUN_ID`` finishes such a run after a crash: it reruns only
    the models the journal lacks, then the judge, into the same directory;
  * best-effort panel fan-out, panel agreement (``consensus/agreement.py``),
    then the judge's synthesis, or under ``--vote`` the host's tally of the
    panel's votes (``consensus/vote.py``). ``--judge-overlap`` (or
    ``LLMC_JUDGE_OVERLAP``) prefills the judge prompt on a ``gpu:`` judge
    as the panel's answers arrive (``consensus/overlap.py``): round 1's
    synthesis rides it, refinement rounds use the classic judge. ``--rounds N`` adds N - 1
    refinement rounds (panel critique, judge refine; a failed round is a
    warning that keeps the last good consensus) and ``--confidence`` one
    judge-graded confidence query (``consensus/confidence.py``; a failure
    is a warning). ``--system`` reaches the panel only; ``--continue``
    folds a saved run's conversation into the prompts the models see;
  * ``result.json``, ``prompt.txt`` and ``consensus.md``; output routing
    ``--output`` file | auto-save | ``--json`` stdout | pretty TTY
    (``ui/``) | JSON stdout;
  * ``-i/--interactive``: one run per stdin line over warm providers, the
    conversation carried across queries (``/models +m|-m``, ``/judge m``,
    ``/reset``, ``/exit``);
  * errors print ``error: ...`` to stderr and exit 1;
  * ``serve``: the resident HTTP gateway (cli/serve.py, serve/);
    ``route``: the fleet router over N gateways (cli/route.py);
    ``distill``: corpus → distilled, versioned checkpoint (cli/distill.py,
    flywheel/).

Model names are ``gpu:<preset>``. ``main(argv, device=None)`` runs on the
current CUDA card and raises when there is none; tests pass
``device="cpu"``. ``--priority`` sets the panel's priority class (the
judge runs one class above it) and ``--prefill-budget`` the batched
engines' interleaved admission, as in the JAX CLI. ``--draft`` (a draft
preset for every target, ``target=draft`` pairs, or ``lookup``) and
``--spec-k`` turn on speculative decoding on the ``gpu:`` provider
(engine/speculative.py; greedy output is token-exact, the draft only
changes speed); they reach the provider as arguments of every run, so one
in-process run's draft never leaks into the next, and the config file's
``draft`` key sets ``--draft``. ``metrics.json`` then carries each
preset's ``spec`` block.

Run telemetry follows the JAX CLI: the live, attribution, roofline and
flight-recorder planes are on by default and installed once per process
run, before any provider exists (the knobs of ``utils/knobs.py``
``telemetry_settings``); an auto-saved run writes ``metrics.json``
whenever one of them grew during the run. ``--events`` (or
``LLMC_EVENTS``) adds the run recorder: the run directory gains
``trace.json`` (Perfetto-loadable) and ``metrics.json`` gains ``counters``
and ``events``. ``--output``, ``--json`` and ``--no-save`` leave no run
directory, and a recorded run says so in a warning. ``--trace DIR`` writes
a ``torch.profiler`` trace of the whole run to ``DIR/trace.json``;
``--profile`` arms one bounded window of the deep profiler
(obs/profiler.py) around the run.

Quantization and continuous batching are chosen as in the JAX package,
through the environment only (``LLMC_QUANT``, ``LLMC_KV_QUANT``,
``LLMC_W8A8``, ``LLMC_DECODE_W8A8``, ``LLMC_DECODE_QSTRUCT``,
``LLMC_INT4_IMPL``; ``LLMC_MAX_BATCH`` or ``LLMC_BATCH_STREAMS``,
``LLMC_POOL_PREFIX``, ``LLMC_POOL_PREFIX_MIN``, ``LLMC_PREFILL_BUDGET``;
``LLMC_CHECKPOINT_DIR``, the per-preset checkpoint directory;
``LLMC_PREFIX_CACHE`` and ``LLMC_PREFIX_CACHE_MAX_MB``, the engines'
prefix snapshot reuse; ``LLMC_KV_POOL``, ``LLMC_KV_POOL_BLOCK`` and
``LLMC_KV_POOL_MB``, the cross-request paged KV pool that replaces it
(``metrics.json`` then carries each preset's ``kv`` block, and a response
whose publish the pool truncated ``"kv": {"truncated": true}``);
``LLMC_HTTP_RETRIES`` and ``LLMC_HTTP_BACKOFF``, the remote providers'
retries):
the default provider factory reads them here (utils/knobs.py), the one
place the port reads knobs, and an unknown mode or a refused setting fails
at registry init, before any engine is built.

Robustness follows the JAX CLI too: ``LLMC_FAULTS`` (with
``LLMC_FAULTS_SEED``) installs a deterministic fault plan and
``LLMC_INTEGRITY`` the integrity plane (``LLMC_INTEGRITY_SAMPLE`` its share
of verified KV-pool gathers), both once per process and before
any provider exists; ``LLMC_JOURNAL``, ``LLMC_ENGINE_HEARTBEAT_S`` and
``LLMC_ENGINE_RESTARTS`` go to the provider factory (a journaled batched
pool is supervised: a crash becomes a rebuild and a replay). An
auto-saved run that a fault plan drove gains ``faults.txt``, the plan's
decision sequence, and, with the recorder, ``metrics.json``'s ``faults``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Callable, Optional, TextIO

from llm_consensus_tpu_torch import faults, integrity, obs, ui
from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.consensus import (
    Judge,
    grade_confidence,
    make_overlap_judge,
    render_critique_prompt,
    render_refine_prompt,
    render_vote_prompt,
    score_agreement,
    tally_votes,
)
from llm_consensus_tpu_torch.obs import export as obs_export
from llm_consensus_tpu_torch.output import Result
from llm_consensus_tpu_torch.output.persist import reserve_run_dir, save_aux_files, save_file
from llm_consensus_tpu_torch.pressure import parse_priority
from llm_consensus_tpu_torch.providers import Provider, Registry, Response
from llm_consensus_tpu_torch.runner import AllModelsFailed, Callbacks, RunResult, Runner
from llm_consensus_tpu_torch.utils import knobs
from llm_consensus_tpu_torch.utils.context import Context
from llm_consensus_tpu_torch.utils.device import DeviceLike, resolve_device
from llm_consensus_tpu_torch.version import version_string

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
    rounds: int = 1        # consensus rounds: critique + refine after round 1
    vote: bool = False     # the panel picks one of ``options``; no judge
    options: list[str] = field(default_factory=list)
    continue_run: str = ""  # run-id whose conversation this run continues
    system: str = ""       # system prompt for every panel model
    interactive: bool = False  # REPL: one run per stdin line
    confidence: bool = False   # judge-graded confidence in the consensus
    resume: str = ""       # run-id of a crashed run to finish
    judge_overlap: bool = False  # prefill the judge prompt as answers arrive
    prefill_budget: Optional[int] = None  # interleaved admission (batched gpu engines)
    priority: str = ""     # panel priority class (pressure/)
    draft: str = ""        # speculative decoding: the draft spec (``--draft``)
    spec_k: Optional[int] = None  # its draft-length ceiling (``--spec-k``)


class CLIError(Exception):
    """User-facing CLI error → ``error: ...`` + exit 1."""


def run_priorities(cfg: Config) -> tuple[Optional[int], Optional[int]]:
    """``(panel class, judge class)`` of a run: both None without
    ``--priority`` (the provider's NORMAL, the Judge's HIGH); with it the
    judge outranks its own panel by one class, so an explicit low-priority
    batch run never runs its judge at HIGH against other tenants."""
    if not cfg.priority:
        return None, None
    panel = parse_priority(cfg.priority)
    return panel, max(0, panel - 1)


def create_provider(model: str, device: DeviceLike = None, draft: Optional[str] = None,
                    spec_k: Optional[int] = None) -> Provider:
    """Resolve a model name to its provider: ``gpu:<preset>`` → the shared
    GPU provider of ``device`` and of the environment's quantization modes,
    batching settings, checkpoint directory, prefix and speculation
    settings; any other name → the remote HTTP provider of the catalog,
    with the environment's retry settings. ``draft`` / ``spec_k`` (the
    ``--draft`` / ``--spec-k`` flags) reconfigure the shared provider's
    drafting when given (``set_draft``)."""
    from llm_consensus_tpu_torch.providers.gpu import SCHEME, GPUProvider, parse_model_name
    from llm_consensus_tpu_torch.providers.registry import REMOTE_MODELS, create_remote_provider
    from llm_consensus_tpu_torch.utils.knobs import (
        batch_settings, checkpoint_dir, disagg_settings, engine_settings, http_settings,
        kv_pool_settings, placement_settings, prefix_settings, quant_modes, recovery_settings,
        spec_settings)

    if model.startswith(SCHEME):
        try:
            parse_model_name(model)
        except ValueError as err:
            raise CLIError(str(err)) from None
        provider = GPUProvider.shared(device, **batch_settings(), **quant_modes(),
                                      **checkpoint_dir(), **prefix_settings(),
                                      **kv_pool_settings(), **recovery_settings(),
                                      **spec_settings(), **engine_settings(),
                                      **disagg_settings(), **placement_settings())
        if draft is not None:
            provider.set_draft(draft, k=spec_k)
        return provider
    try:
        return create_remote_provider(model, **http_settings())
    except ValueError:
        available = sorted(REMOTE_MODELS) + [f"{SCHEME}<model>"]
        raise CLIError(f"unknown model {model!r}; available models: {available}") from None


def init_registry(models: list[str], judge: Optional[str],
                  factory: ProviderFactory) -> Registry:
    """One provider per unique model, judge included; ``judge=None``
    (voting mode) registers the panel only."""
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
    if stdin is not None and not ui.is_terminal(stdin):
        return stdin.read().rstrip("\n")
    raise CLIError("no prompt provided: use positional argument, --file, or pipe to stdin")


# Config-file keys that set flag defaults (CLI flags always win): the JAX
# CLI's set (``draft`` sets ``--draft``).
_CONFIG_FLAG_KEYS = frozenset({
    "models", "judge", "timeout", "data_dir", "max_tokens", "system",
    "rounds", "confidence", "draft",
})


def load_config_file() -> tuple[dict, str]:
    """Defaults and model aliases from ``.llm-consensus.json`` in the
    working directory, else ``~/.llm-consensus.json``. ``LLMC_CONFIG=<path>``
    overrides the search; ``LLMC_CONFIG=0`` disables. Returns ({}, "") when
    none is found."""
    env = knobs.config_file()
    if env == "0":
        return {}, ""
    if env:
        path = os.path.expanduser(env)
        if not os.path.exists(path):
            raise CLIError(f"LLMC_CONFIG points to a missing file: {path}")
        candidates = [path]
    else:
        candidates = [
            ".llm-consensus.json",
            os.path.expanduser("~/.llm-consensus.json"),
        ]
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError) as err:
            raise CLIError(f"reading config file {path}: {err}") from err
        if not isinstance(data, dict):
            raise CLIError(f"config file {path}: expected a JSON object")
        unknown = set(data) - _CONFIG_FLAG_KEYS - {"aliases"}
        if unknown:
            raise CLIError(
                f"config file {path}: unknown keys {sorted(unknown)} "
                f"(known: {sorted(_CONFIG_FLAG_KEYS | {'aliases'})})"
            )
        _validate_config_types(data, path)
        return data, path
    return {}, ""


def _validate_config_types(data: dict, path: str) -> None:
    """Reject wrong-typed config values with a CLIError: set_defaults()
    bypasses argparse's type conversion, so raw JSON types would flow into
    the run otherwise."""
    def fail(key, expected):
        raise CLIError(
            f"config file {path}: {key!r} must be {expected}, "
            f"got {type(data[key]).__name__}"
        )

    for key in ("models", "judge", "system", "data_dir", "draft"):
        if key in data and not isinstance(data[key], str):
            fail(key, "a string")
    for key in ("timeout", "max_tokens"):
        if key in data and (
            isinstance(data[key], bool) or not isinstance(data[key], (int, float))
        ):
            fail(key, "a number")
    if "rounds" in data and (
        isinstance(data["rounds"], bool) or not isinstance(data["rounds"], int)
    ):
        fail("rounds", "an integer")
    if "confidence" in data and not isinstance(data["confidence"], bool):
        fail("confidence", "a boolean")
    aliases = data.get("aliases")
    if aliases is not None:
        if not isinstance(aliases, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in aliases.items()
        ):
            raise CLIError(
                f"config file {path}: 'aliases' must map alias names to "
                f"comma-separated model strings"
            )


def expand_aliases(models: list[str], aliases: dict) -> list[str]:
    """``@alias`` entries → their comma-separated model lists. Duplicates
    are kept: an explicit repeated model means two queries, and alias
    overlap follows the same rule."""
    out: list[str] = []
    for m in models:
        if m.startswith("@"):
            if m not in aliases:
                raise CLIError(
                    f"unknown model alias {m!r}; defined: {sorted(aliases)}"
                )
            out.extend(x.strip() for x in aliases[m].split(",") if x.strip())
        else:
            out.append(m)
    return out


# Flags that would change a resumed run's identity, which its manifest
# fixes; checked against argv, so config-file defaults never clash.
_IDENTITY_FLAGS = (
    "--models", "-models", "--judge", "-judge", "--system",
    "-system", "--system-file", "-system-file", "--max-tokens",
    "-max-tokens", "--vote", "-vote", "--options", "-options",
    "--rounds", "-rounds", "--confidence", "-confidence",
)


def parse_args(argv: list[str], stdin: Optional[TextIO],
               stdout: TextIO) -> Optional[Config]:
    """Parse flags; returns None when ``--version`` was handled."""
    parser = argparse.ArgumentParser(
        prog="llm-consensus-torch",
        description="Query multiple on-device LLMs in parallel and synthesize a "
                    "consensus answer (PyTorch/CUDA port).",
    )
    parser.add_argument("--models", "-models", default="", metavar="LIST",
                        help="Comma-separated list of gpu:<preset> models (or @aliases "
                             "of the config file) to query (required)")
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
    parser.add_argument("--rounds", "-rounds", type=int, default=1,
                        help="Consensus rounds: after each synthesis the panel "
                             "critiques the draft and the judge refines it")
    parser.add_argument("--vote", "-vote", action="store_true",
                        help="Voting mode: panel picks one of --options; no judge")
    parser.add_argument("--options", "-options", default="", metavar="LIST",
                        help="Comma-separated options for --vote")
    parser.add_argument("--continue", "-continue", dest="continue_run",
                        default="", metavar="RUN_ID",
                        help="Continue the conversation from a saved run in --data-dir")
    parser.add_argument("--resume", "-resume", default="", metavar="RUN_ID",
                        help="Finish a crashed run in --data-dir: reuse the panel "
                             "answers its journal already completed "
                             "(data/<run-id>/panel/), rerun only the missing/failed "
                             "models, then the judge")
    parser.add_argument("--system", "-system", default="",
                        help="System prompt for every panel model")
    parser.add_argument("--system-file", "-system-file", default="", metavar="PATH",
                        help="Read the system prompt from a file")
    parser.add_argument("--interactive", "-interactive", "-i", action="store_true",
                        help="REPL mode: one consensus query per line, conversation "
                             "carried across queries")
    parser.add_argument("--confidence", "-confidence", action="store_true",
                        help="After synthesis, the judge grades its confidence in the "
                             "consensus (0-100) and lists controversy points")
    parser.add_argument("--judge-overlap", "-judge-overlap", action="store_true",
                        help="Prefill the judge prompt incrementally as panel answers "
                             "arrive (gpu judges), cutting judge time-to-first-token by "
                             "nearly the whole prompt prefill. LLMC_JUDGE_OVERLAP=1 is "
                             "equivalent")
    parser.add_argument("--spec-k", "-spec-k", type=int, default=None, metavar="K",
                        help="Speculative draft-length ceiling per round (default "
                             "LLMC_SPEC_K or 4); adaptive k walks a pow2 ladder below it")
    parser.add_argument("--draft", "-draft", default="", metavar="SPEC",
                        help="Speculative decoding for gpu models: 'lookup' (prompt-lookup "
                             "n-grams, zero draft cost, composes with LLMC_MAX_BATCH pools), "
                             "a draft preset for all targets (e.g. llama-3.2-1b) or "
                             "target=draft pairs (a=b,c=d). Greedy output is token-exact; "
                             "the draft only changes speed")
    parser.add_argument("--prefill-budget", "-prefill-budget", type=int, default=None,
                        metavar="TOKENS",
                        help="Interleaved admission prefill for gpu continuous batching: "
                             "dispatch at most this many prompt tokens of a new stream's "
                             "prefill between decode chunks, so resident streams keep "
                             "decoding during admission. 0/unset = classic stall-the-pool "
                             "admission; LLMC_PREFILL_BUDGET is equivalent")
    parser.add_argument("--priority", "-priority", default="", metavar="CLASS",
                        help="Priority class for the panel queries (high/normal/low or "
                             "0-2): orders continuous-batcher admission and selects "
                             "preemption victims on shared engines. The judge always "
                             "outranks the panel by one class. Default: normal")
    parser.add_argument("--quiet", "-quiet", "-q", action="store_true",
                        help="Suppress progress output")
    parser.add_argument("--json", "-json", action="store_true",
                        help="Output JSON to stdout (no interactive display, no auto-save)")
    parser.add_argument("--no-save", "-no-save", action="store_true",
                        help="Don't auto-save results to data directory")
    parser.add_argument("--version", "-version", action="store_true",
                        help="Print version information and exit")
    parser.add_argument("prompt", nargs="*", help="The prompt (or use --file / stdin)")

    # Config-file values become flag defaults, so explicit flags win: CLI >
    # config file > built-in default. --version and --help work even with
    # a broken config file, so those invocations skip it.
    skip_config = any(a in ("--version", "-version", "--help", "-h") for a in argv)
    config, _config_path = ({}, "") if skip_config else load_config_file()
    flag_defaults = {k: v for k, v in config.items() if k in _CONFIG_FLAG_KEYS}
    if flag_defaults:
        parser.set_defaults(**flag_defaults)

    ns = parser.parse_args(argv)

    if ns.version:
        stdout.write(version_string(parser.prog) + "\n")
        return None

    if not ns.models and not ns.resume:
        raise CLIError("--models flag is required")

    options = [o.strip() for o in ns.options.split(",") if o.strip()]
    if ns.vote and len(options) < 2:
        raise CLIError("--vote requires --options with at least two choices")
    if options and not ns.vote:
        raise CLIError("--options only applies with --vote")
    if ns.rounds < 1:
        raise CLIError("--rounds must be >= 1")
    if ns.vote and ns.rounds != 1:
        raise CLIError("--vote and --rounds are mutually exclusive")
    if ns.vote and ns.confidence:
        raise CLIError(
            "--vote and --confidence are mutually exclusive (voting mode "
            "has no judge to grade the consensus)"
        )

    system = ns.system
    if ns.system_file:
        if system:
            raise CLIError("--system and --system-file are mutually exclusive")
        try:
            with open(ns.system_file, "r", encoding="utf-8") as f:
                system = f.read().strip()
        except OSError as err:
            raise CLIError(f"reading system prompt file: {err}") from err

    aliases = config.get("aliases", {}) or {}
    models = expand_aliases([m.strip() for m in ns.models.split(",") if m.strip()], aliases)
    judge_list = expand_aliases([ns.judge], aliases)
    if len(judge_list) != 1:
        raise CLIError(f"--judge must resolve to exactly one model, got {judge_list}")
    cfg = Config(
        models=models,
        judge=judge_list[0],
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
        rounds=ns.rounds,
        vote=ns.vote,
        options=options,
        continue_run=ns.continue_run,
        system=system,
        interactive=ns.interactive,
        confidence=ns.confidence,
        judge_overlap=ns.judge_overlap,
        prefill_budget=ns.prefill_budget,
        priority=ns.priority,
        draft=ns.draft,
        spec_k=ns.spec_k,
    )
    if cfg.priority:
        try:
            parse_priority(cfg.priority)
        except ValueError as err:
            raise CLIError(str(err)) from err
    if ns.resume:
        # A resumed run's identity (prompt, panel, judge, settings) comes
        # from its manifest; flags that would change it, or disable the
        # persistence the resume writes into, contradict it.
        if ns.prompt or ns.file:
            raise CLIError("--resume takes the prompt from the saved run")
        if ns.interactive:
            raise CLIError("--resume and --interactive are incompatible")
        if ns.continue_run:
            raise CLIError("--resume and --continue are incompatible")
        if ns.output or ns.json or ns.no_save:
            raise CLIError(
                "--resume writes into the saved run directory; it is "
                "incompatible with --output/--json/--no-save"
            )
        clashing = sorted({
            f for f in _IDENTITY_FLAGS for a in argv if a == f or a.startswith(f + "=")
        })
        if clashing:
            raise CLIError(
                f"--resume takes {', '.join(clashing)} from the saved "
                "run's manifest; drop the flag(s) or start a fresh run"
            )
        cfg.resume = ns.resume
        return cfg
    if ns.interactive:
        if ns.prompt:
            raise CLIError("--interactive takes queries from stdin, not arguments")
        if ns.file:
            raise CLIError("--interactive takes queries from stdin, not --file")
        if ns.output:
            raise CLIError(
                "--interactive and --output are incompatible (each query "
                "would overwrite the file); use the auto-saved run dirs"
            )
        return cfg
    cfg.prompt = get_prompt(ns.prompt, ns.file, stdin)
    return cfg


def load_history(data_dir: str, run_id: str) -> list[dict]:
    """Conversation history for ``--continue``: the saved run's history
    plus its own exchange, oldest first."""
    path = os.path.join(data_dir, run_id, "result.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as err:
        raise CLIError(f"loading run {run_id!r}: {err}") from err
    if not isinstance(data, dict) or "prompt" not in data or "consensus" not in data:
        raise CLIError(f"run {run_id!r} has no usable result.json")
    history = [
        h for h in data.get("history", [])
        if isinstance(h, dict) and "prompt" in h and "consensus" in h
    ]
    history.append({"prompt": data["prompt"], "consensus": data["consensus"]})
    return history


def render_conversation(history: list[dict], prompt: str) -> str:
    """Fold earlier exchanges into the prompt the models see."""
    parts = ["Earlier exchanges in this conversation:"]
    for h in history:
        parts.append(f"\n[User]\n{h['prompt']}\n\n[Answer]\n{h['consensus']}")
    parts.append(f"\nCurrent follow-up prompt:\n{prompt}")
    return "\n".join(parts)


def _slug(model: str) -> str:
    """Filesystem-safe model-name slug for panel journal files."""
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in model)


def write_run_manifest(run_dir: str, cfg: Config, history: list[dict], warn=None) -> None:
    """The run's identity in ``run.json``, written before the fan-out, so a
    crashed process leaves enough for ``--resume`` to finish the run:
    prompt, panel, judge and every setting that changes what the models
    see."""
    manifest = {
        "prompt": cfg.prompt,
        "models": list(cfg.models),
        "judge": cfg.judge,
        "system": cfg.system,
        "max_tokens": cfg.max_tokens,
        "timeout": cfg.timeout,
        "rounds": cfg.rounds,
        "vote": cfg.vote,
        "options": list(cfg.options),
        "confidence": cfg.confidence,
        "history": history,
    }
    save_file(run_dir, "run.json", json.dumps(manifest, indent=2), warn=warn)


def load_resume_manifest(data_dir: str, run_id: str) -> dict:
    """The saved run's manifest, or a CLIError that says what is wrong."""
    run_dir = os.path.join(data_dir, run_id)
    path = os.path.join(run_dir, "run.json")
    if os.path.exists(os.path.join(run_dir, "result.json")):
        raise CLIError(
            f"run {run_id!r} already completed (result.json exists); "
            "use --continue to build on it"
        )
    try:
        with open(path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise CLIError(
            f"resuming run {run_id!r}: no usable run.json ({err}); only "
            "runs started by this version journal their manifest"
        ) from err
    if not isinstance(manifest, dict) or not manifest.get("models"):
        raise CLIError(f"resuming run {run_id!r}: run.json has no panel")
    return manifest


def load_panel_journal(run_dir: str) -> list[Response]:
    """Completed panel answers journaled under ``<run_dir>/panel/``, in
    journal order. Torn or unparseable files are skipped: their models
    rerun, which is the safe direction."""
    panel_dir = os.path.join(run_dir, "panel")
    if not os.path.isdir(panel_dir):
        return []
    out = []
    for name in sorted(os.listdir(panel_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(panel_dir, name), encoding="utf-8") as f:
                doc = json.load(f)
            out.append(Response(
                model=doc["model"],
                content=doc["content"],
                provider=doc.get("provider", ""),
                latency_ms=doc.get("latency_ms", 0.0),
                truncated=doc.get("truncated", False),
                tokens=doc.get("tokens"),
                tokens_per_sec=doc.get("tokens_per_sec"),
                mfu=doc.get("mfu"),
                mbu=doc.get("mbu"),
            ))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def panel_journal(run_dir: str, warn=None) -> Callable[[Response], None]:
    """The hook that writes each panel answer into
    ``<run_dir>/panel/NNN-<slug>.json`` (atomic ``save_file``), numbering
    past the highest file already there: a torn file keeps its index, and
    a resumed rerun never overwrites the journal it reuses."""
    panel_dir = os.path.join(run_dir, "panel")
    lock = sanitizer.make_lock("cli.panel")
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


def install_planes(events: bool, stderr: TextIO, blackbox_dir: str = "") -> None:
    """Install the telemetry planes from the environment before any
    provider exists (consumers bind them at construction). Each plane is
    decided once per process; the recorder is per run: ``events`` (the
    flag) or ``LLMC_EVENTS`` installs it, otherwise a previous run's
    recorder is dropped. ``blackbox_dir`` (``serve --blackbox-dir``)
    overrides ``LLMC_BLACKBOX_DIR`` for a flight recorder made here."""
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
            st["blackbox_events"], blackbox_dir or st["blackbox_dir"] or blackbox.DEFAULT_DIR,
            st["blackbox_min_interval_s"]) if st["blackbox"] else None)
    if not profiler.resolved():
        profiler.install(profiler.DeepProfiler(
            st["profile_dir"] or profiler.DEFAULT_DIR, st["profile_max_s"],
            st["profile_min_interval_s"]) if st["profile"] else None)
    # The fault plan and the integrity plane, as the JAX package resolves
    # them: from the environment once per process (a plan installed by a
    # harness stays), before any provider binds them.
    fs = knobs.fault_settings()
    if faults.plan() is None and fs["spec"]:
        faults.install(faults.FaultPlan(fs["spec"], seed=fs["seed"]))
    if integrity.plane() is None and knobs.integrity_enabled():
        integrity.install(integrity.IntegrityPlane(sample=knobs.integrity_sample()))


def run(cfg: Config, ctx: Context, *, factory: ProviderFactory, stdout: TextIO,
        stderr: TextIO, stdin: Optional[TextIO] = None) -> Optional[Result]:
    """One consensus run, or an interactive session of them, with the
    telemetry planes installed once; ``--trace`` wraps it in a
    ``torch.profiler`` trace, ``--profile`` in one bounded deep-profiler
    window. Returns the run's :class:`Result` (None for a session).

    Under a multi-controller run (several processes joined through
    ``LLMC_COORDINATOR`` / ``LLMC_NUM_PROCESSES`` / ``LLMC_PROCESS_ID``) each
    process queries the models it owns (runner/multihost.py), the judge's
    owner synthesizes and broadcasts (parallel/multicontroller.py), and only
    process 0 persists and prints; every process returns the same merged
    result."""
    install_planes(cfg.events, stderr)
    if cfg.prefill_budget is not None:
        # The flag and LLMC_PREFILL_BUDGET are equivalent: the factory reads
        # the knob when it builds a provider. Batchers already built in this
        # process keep the budget they were built with.
        knobs.set_prefill_budget(cfg.prefill_budget)
    # A resumed run's identity comes from the saved manifest, applied
    # before any provider exists.
    resume_manifest = None
    if cfg.resume:
        resume_manifest = manifest = load_resume_manifest(cfg.data_dir, cfg.resume)
        cfg = replace(
            cfg,
            prompt=manifest.get("prompt", ""),
            models=list(manifest["models"]),
            judge=manifest.get("judge") or cfg.judge,
            system=manifest.get("system") or "",
            max_tokens=manifest.get("max_tokens"),
            timeout=float(manifest.get("timeout") or cfg.timeout),
            rounds=int(manifest.get("rounds") or 1),
            vote=bool(manifest.get("vote", False)),
            options=list(manifest.get("options") or []),
            confidence=bool(manifest.get("confidence", False)),
        )

    # Multi-controller runs (parallel/distributed.py): join the process
    # group before any provider exists; a no-op without configuration.
    if any(m.startswith("gpu:") for m in cfg.models + ([cfg.judge] if cfg.judge else [])):
        from llm_consensus_tpu_torch.parallel import distributed
        from llm_consensus_tpu_torch.parallel import multicontroller as mc

        try:
            distributed.initialize(**knobs.distributed_settings())
        except Exception as err:  # noqa: BLE001 — reported as a CLI error
            raise CLIError(f"joining distributed cluster: {err}") from err
        if mc.is_multicontroller() and cfg.interactive:
            # A REPL cannot keep the controllers in lockstep: the others
            # have no stdin, and a diverged one deadlocks the next exchange.
            raise CLIError("--interactive is not supported under multi-controller "
                           "execution; pass the prompt as an argument or --file")

    def body():
        if cfg.interactive:
            interactive_loop(cfg, ctx, factory=factory,
                             stdin=stdin if stdin is not None else sys.stdin,
                             stdout=stdout, stderr=stderr)
            return None
        return _run(cfg, ctx, factory=factory, stdout=stdout, stderr=stderr,
                    resume_manifest=resume_manifest)

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
         stderr: TextIO, history: Optional[list[dict]] = None,
         resume_manifest: Optional[dict] = None) -> Result:
    """One consensus run: fan-out, judge synthesis (or the vote tally),
    refinement rounds, confidence grading, persistence, output."""
    show_ui = ui.is_terminal(stderr) and not cfg.quiet and not cfg.json
    start_time = time.monotonic()
    # Per-run telemetry reset at entry (an interactive session calls _run
    # once per query and keeps going after a failed one); the
    # process-lifetime planes get watermarks, so a run that moved none of
    # them writes no metrics.json.
    recorder = obs.recorder()
    if recorder is not None:
        recorder.clear()
    live_plane, attrib_led, roofline_led = (
        obs.live.metrics(), obs.attrib.ledger(), obs.roofline.ledger())
    live0 = live_plane.counts() if live_plane is not None else 0
    attrib0 = attrib_led.activity() if attrib_led is not None else 0
    roofline0 = roofline_led.activity() if roofline_led is not None else 0

    # --resume: the crashed run's directory, its conversation history, and
    # the panel answers its journal already holds; their models do not
    # rerun.
    resume_dir = ""
    completed: list[Response] = []
    if cfg.resume:
        resume_dir = os.path.join(cfg.data_dir, cfg.resume)
        manifest = (resume_manifest if resume_manifest is not None
                    else load_resume_manifest(cfg.data_dir, cfg.resume))
        history = [h for h in manifest.get("history", [])
                   if isinstance(h, dict) and "prompt" in h and "consensus" in h]
        completed = load_panel_journal(resume_dir)

    # Conversation context, from the interactive session or --continue's
    # saved run (loaded first, so a bad run-id fails before any provider
    # exists). Panel and judge see the folded prompt; Result.prompt and
    # prompt.txt keep the raw follow-up.
    if history is None:
        history = load_history(cfg.data_dir, cfg.continue_run) if cfg.continue_run else []
    context_prompt = render_conversation(history, cfg.prompt) if history else cfg.prompt

    # Voting mode never queries a judge: no judge provider, no judge engine.
    judge = None if cfg.vote else cfg.judge
    registry = init_registry(cfg.models, judge, factory)

    # Announce the run before any query: the GPU provider builds its
    # kernels here, outside every model's deadline.
    seen: set = set()
    for model in dict.fromkeys(cfg.models + ([judge] if judge else [])):
        provider = registry.get(model)
        if id(provider) in seen:
            continue
        seen.add(id(provider))
        try:
            provider.prepare(cfg.models, judge)
        except Exception as err:  # noqa: BLE001 — reported as a CLI error
            raise CLIError(f"preparing provider: {err}") from err

    # Multi-controller execution: each process queries only the models it
    # owns, results merge through one allgather, the judge's owner
    # broadcasts the synthesis, and process 0 alone persists and prints.
    mc = None
    if any(m.startswith("gpu:") for m in cfg.models + ([judge] if judge else [])):
        from llm_consensus_tpu_torch.parallel import multicontroller

        if multicontroller.is_multicontroller():
            mc = multicontroller
    if mc is not None:
        # Every controller must run the identical prompt: a stdin-piped one
        # exists only on the launching terminal, so process 0's wins.
        context_prompt = mc.broadcast_json(context_prompt, owner=0)
        if cfg.resume:
            # The panel journal is process 0's: a resumed run's skip set
            # would diverge across controllers and deadlock the merge.
            raise CLIError("--resume is not supported under multi-controller execution; "
                           "rerun the prompt instead")

    # The run directory and its manifest before the fan-out (a resumed run
    # writes into its own); each panel answer is journaled as it lands.
    warn = (lambda msg: ui.print_error(stderr, msg)) if show_ui else None
    run_dir = resume_dir
    if (not run_dir and not cfg.output and not cfg.json and not cfg.no_save
            and not (mc is not None and mc.process_index() != 0)):
        try:
            _run_id, run_dir = reserve_run_dir(cfg.data_dir)
        except OSError as err:
            raise CLIError(f"creating run directory: {err}") from err
        write_run_manifest(run_dir, cfg, history, warn=warn)

    if show_ui:
        ui.print_header(stderr, cfg.prompt)
        ui.print_phase(stderr, "Querying models...")
        stderr.write("\n")

    # A resumed run queries only the models whose answers are not in the
    # journal (duplicates consume one journaled answer each).
    models_to_run = list(cfg.models)
    for resp in completed:
        if resp.model in models_to_run:
            models_to_run.remove(resp.model)
    if cfg.resume and show_ui:
        ui.print_phase(stderr, f"Resuming {cfg.resume}: reusing {len(completed)} journaled "
                               f"answers, rerunning {len(models_to_run)} models")

    progress = ui.Progress(stderr, models_to_run, quiet=not show_ui)
    progress.start()
    panel_priority, judge_priority = run_priorities(cfg)
    if mc is not None:
        from llm_consensus_tpu_torch.runner.multihost import MultiControllerRunner

        runner = MultiControllerRunner(
            registry, cfg.timeout, max_tokens=cfg.max_tokens, system=cfg.system or None,
            priority=panel_priority, stall_grace=knobs.stall_grace(),
            owner_fn=lambda m: mc.model_owner(registry, m),
            allgather_cap=knobs.allgather_timeout())
    else:
        runner = Runner(registry, cfg.timeout, max_tokens=cfg.max_tokens,
                        system=cfg.system or None, priority=panel_priority,
                        stall_grace=knobs.stall_grace())
    # Judge prefill overlap (consensus/overlap.py): each panel answer
    # prefills into the judge's growing cache as it lands. Never under
    # --vote (no judge); None when off or the judge has no engine.
    overlap_judge = None
    if not cfg.vote and mc is None:  # the overlap session is process-local
        try:
            overlap_judge = make_overlap_judge(
                registry.get(cfg.judge), cfg.judge, context_prompt, max_tokens=cfg.max_tokens,
                enabled=True if cfg.judge_overlap else None, priority=judge_priority)
        except Exception:  # noqa: BLE001 — an unknown judge errors at synthesis
            overlap_judge = None
    # Each answer is journaled first, then fed to the overlap judge; a hook
    # that fails must not keep the next from running.
    response_hooks = [h for h in (
        panel_journal(run_dir, warn=warn) if run_dir else None,
        overlap_judge.on_response if overlap_judge is not None else None,
    ) if h is not None]
    on_model_response = None
    if response_hooks:
        def on_model_response(resp: Response) -> None:
            for hook in response_hooks:
                try:
                    hook(resp)
                except Exception:  # noqa: BLE001 — a hook must not fail a model
                    pass
    runner.with_callbacks(Callbacks(
        on_model_start=progress.model_started,
        on_model_stream=progress.model_streaming,
        on_model_complete=progress.model_completed,
        on_model_error=progress.model_failed,
        on_model_response=on_model_response,
    ))
    panel_prompt = render_vote_prompt(context_prompt, cfg.options) if cfg.vote else context_prompt
    try:
        # Every panel answer may come from the journal: nothing to rerun.
        result = runner.run(ctx, models_to_run, panel_prompt) if models_to_run else RunResult()
    except AllModelsFailed as err:
        if not completed:
            raise CLIError(f"running queries: {err}") from err
        # The rerun wiped out, but journaled answers carry the run: the
        # best-effort rule of a partial panel failure.
        result = RunResult(warnings=[f"resumed rerun failed: {err}"],
                           failed_models=list(dict.fromkeys(models_to_run)))
    except Exception as err:  # noqa: BLE001 — reported as a CLI error
        raise CLIError(f"running queries: {err}") from err
    finally:
        progress.stop()
    result.responses[:0] = completed
    _close_expired_profile()

    agreement = score_agreement(result.responses)
    if show_ui:
        ui.print_success(stderr, f"Received responses from {len(result.responses)} models")
        if agreement is not None:
            ui.print_phase(stderr, f"Panel agreement: {agreement.level} ({agreement.score:.2f})")
        stderr.write("\n")

    confidence = None
    if cfg.vote:
        # Voting mode: the host tallies the panel's votes; no judge.
        vote = tally_votes(result.responses, cfg.options)
        consensus = vote.summary()
        judge_name = "vote"
        for m in vote.unparsed:
            result.warnings.append(f"{m}: no recognizable vote in response")
        if show_ui:
            ui.print_success(stderr, "Votes tallied!")
    else:
        consensus, confidence = _synthesize_rounds(
            cfg, ctx, registry, runner, result, context_prompt, show_ui, stderr, overlap_judge,
            mc=mc)
        judge_name = cfg.judge
    _close_expired_profile()

    # Run telemetry rides the auto-saved run directory; a recorded run
    # that has none says so instead of discarding it silently.
    # Under a multi-controller run the decision is the flags' (identical on
    # every process), since the timeline merge is a collective every
    # process must enter; only process 0 has the run directory.
    persists = (bool(run_dir) if mc is None
                else not cfg.output and not cfg.json and not cfg.no_save)
    trace_doc = metrics_doc = None
    if recorder is not None and not persists:
        result.warnings.append(
            "run telemetry recorded but not persisted: trace.json/metrics.json ride the "
            "auto-saved run directory, which --output, --json, and --no-save disable")
    plan = faults.plan()
    if recorder is not None and persists:
        # The degradation the run saw, read before the telemetry exchange.
        degraded = mc.degraded_peers() if mc is not None else None
        trace_missing: list = []
        if mc is not None and cfg.events:
            # Merged only under the --events flag, which reaches every
            # controller alike (an environment-enabled recorder stays local).
            from llm_consensus_tpu_torch.obs.multihost import merge_timelines

            trace_doc, trace_missing = merge_timelines(
                recorder, mc.allgather_timeout(ctx, knobs.allgather_timeout()))
        else:
            trace_doc = obs_export.local_trace(recorder)
        metrics_doc = obs_export.metrics_summary(
            recorder, responses=result.responses,
            batcher_stats=obs_export.collect_batcher_stats(registry),
            kv_stats=obs_export.collect_kv_stats(registry),
            spec_stats=obs_export.collect_spec_stats(registry),
            disagg_stats=obs_export.collect_disagg_stats(registry),
            fault_trace=list(plan.trace) if plan is not None else None,
            failed_models=result.failed_models, warnings=result.warnings,
            live=obs_export.live_summary(), attrib=obs_export.attrib_summary(),
            roofline=obs_export.roofline_summary(), degraded_peers=degraded,
        )
        if trace_missing:
            metrics_doc["timeline_missing_controllers"] = sorted(int(p) for p in trace_missing)
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
        judge=judge_name,
        warnings=result.warnings,
        failed_models=result.failed_models,
        history=history,
        agreement=agreement.to_dict() if agreement else None,
        confidence=confidence,
    )

    if mc is not None and mc.process_index() != 0:
        # The other controllers hold the identical merged result but own
        # no output: process 0 persists and prints it once.
        return out

    # Output routing: --output file, else the run directory's result.json,
    # else --json stdout, else pretty TTY, else JSON stdout. result.json is
    # written last and atomically: its existence marks the run complete.
    output_path = cfg.output
    if not output_path and run_dir:
        try:
            output_path = save_aux_files(run_dir, cfg.prompt, consensus, warn=warn)
        except OSError as err:
            raise CLIError(f"creating run directory: {err}") from err
    if run_dir and plan is not None:
        # The exact injected fault sequence, whenever a plan drove the run.
        save_file(run_dir, "faults.txt", plan.trace_bytes(), warn=warn)
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
        if show_ui:
            stderr.write("\n")
            ui.print_success(stderr, f"Run saved to {os.path.dirname(output_path) or '.'}")
    elif cfg.json:
        stdout.write(out.to_json())
    elif show_ui:
        stderr.write("\n")
        for resp in result.responses:
            ui.print_model_response(stderr, resp.model, resp.provider, resp.content,
                                    resp.latency_ms)
        ui.print_consensus(stderr, consensus)
        ui.print_summary(stderr, len(cfg.models), len(result.responses),
                         len(result.failed_models), time.monotonic() - start_time)
        ui.print_throughput(stderr, result.responses)
        if recorder is not None:
            ui.print_aggregate(stderr, obs_export.aggregate_throughput(recorder))
        if result.warnings:
            stderr.write("\n")
            for w in result.warnings:
                ui.print_error(stderr, w)
    else:
        stdout.write(out.to_json())
    return out


def _synthesize_rounds(cfg: Config, ctx: Context, registry: Registry, runner: Runner,
                       result: RunResult, context_prompt: str, show_ui: bool,
                       stderr: TextIO, overlap_judge=None, mc=None
                       ) -> tuple[str, Optional[dict]]:
    """The judge's synthesis of round 1 (on ``overlap_judge`` when given,
    whose session the panel fed), then each refinement round (panel
    critique, judge refine: the classic judge, their prompt differs from
    the one the session was built with), then the confidence grading. A
    failed later round or grading is a warning in ``result`` and the run
    keeps the last good consensus. Returns (consensus, confidence or
    None)."""
    if show_ui:
        ui.print_phase(stderr, "Synthesizing consensus...")
        stderr.write("\n")
    try:
        judge_provider = registry.get(cfg.judge)
    except Exception as err:  # noqa: BLE001
        raise CLIError(f"judge model {cfg.judge}: {err}") from err
    if mc is not None:
        # The judge's owner synthesizes on its slice; the text (or the
        # error, in lockstep) broadcasts to the other controllers.
        judge_provider = mc.BroadcastProvider(judge_provider, mc.model_owner(registry, cfg.judge))
    judge = Judge(judge_provider, cfg.judge, max_tokens=cfg.max_tokens,
                  priority=run_priorities(cfg)[1])

    def synthesize(user_prompt: str, responses, syn=None) -> str:
        syn = syn if syn is not None else judge
        judge_progress = ui.Progress(stderr, [cfg.judge], quiet=not show_ui)
        judge_progress.start()
        judge_progress.model_started(cfg.judge)
        try:
            text = syn.synthesize_stream(
                ctx, user_prompt, responses,
                lambda chunk: judge_progress.model_streaming(cfg.judge, chunk))
        except Exception as err:  # noqa: BLE001
            judge_progress.stop()
            raise CLIError(f"consensus synthesis: {err}") from err
        judge_progress.model_completed(cfg.judge)
        judge_progress.stop()
        if syn.last_truncated:
            result.warnings.append(f"{cfg.judge}: judge prompt truncated to fit context window")
        return text

    consensus = synthesize(context_prompt, result.responses, syn=overlap_judge)
    _close_expired_profile()

    # Refinement rounds: the panel critiques the draft, the judge refines.
    # Critiques are intermediate: the result keeps round 1's answers.
    for round_no in range(2, cfg.rounds + 1):
        if show_ui:
            stderr.write("\n")
            ui.print_phase(stderr, f"Round {round_no}: panel critique...")
            stderr.write("\n")
        round_progress = ui.Progress(stderr, cfg.models, quiet=not show_ui)
        round_progress.start()
        runner.with_callbacks(Callbacks(
            on_model_start=round_progress.model_started,
            on_model_stream=round_progress.model_streaming,
            on_model_complete=round_progress.model_completed,
            on_model_error=round_progress.model_failed,
        ))
        try:
            critique = runner.run(ctx, cfg.models,
                                  render_critique_prompt(context_prompt, consensus))
        except Exception as err:  # noqa: BLE001 — a failed round is a warning
            round_progress.stop()
            result.warnings.append(f"round {round_no} critique failed, keeping round "
                                   f"{round_no - 1} consensus: {err}")
            break
        round_progress.stop()
        result.warnings.extend(f"round {round_no}: {w}" for w in critique.warnings)
        if show_ui:
            stderr.write("\n")
            ui.print_phase(stderr, f"Round {round_no}: refining consensus...")
            stderr.write("\n")
        try:
            consensus = synthesize(render_refine_prompt(context_prompt, consensus),
                                   critique.responses)
        except CLIError as err:
            result.warnings.append(f"round {round_no} synthesis failed, keeping round "
                                   f"{round_no - 1} consensus: {err}")
            break
        _close_expired_profile()

    if show_ui:
        ui.print_success(stderr, "Consensus reached!")
    if not cfg.confidence:
        return consensus, None
    # Judge-graded confidence: one more judge query; a failed or
    # unparseable grading is a warning, never a failed run.
    if show_ui:
        stderr.write("\n")
        ui.print_phase(stderr, "Grading confidence...")
    try:
        graded = grade_confidence(ctx, judge_provider, cfg.judge, context_prompt,
                                  result.responses, consensus, max_tokens=cfg.max_tokens)
    except Exception as err:  # noqa: BLE001
        result.warnings.append(f"confidence grading failed: {err}")
        return consensus, None
    if graded.score is None:
        result.warnings.append("confidence grading returned an unparseable reply")
        return consensus, None
    if show_ui:
        ui.print_success(stderr, f"Judge confidence: {graded.score}/100")
        for point in graded.controversy:
            stderr.write(f"  • {point}\n")
    return consensus, graded.to_dict()


def interactive_loop(cfg: Config, ctx: Context, *, factory: ProviderFactory, stdin: TextIO,
                     stdout: TextIO, stderr: TextIO) -> None:
    """REPL over warm providers: each line is a consensus run, and the
    conversation accumulates across them (the folding of --continue).
    Commands:

      /models            show the panel
      /models +m / -m    add / remove a model (never the last one)
      /judge m           change the judge
      /reset             clear the conversation history
      /exit, /quit       leave
    """
    tty = ui.is_terminal(stderr)
    history: list[dict] = []
    if cfg.continue_run:
        history = load_history(cfg.data_dir, cfg.continue_run)
    if tty:
        stderr.write("Interactive mode: type a prompt, /models [+m|-m], /judge m, /reset, /exit\n")

    # While idle at the prompt a plain ctx.cancel() cannot unblock readline
    # (Python retries it after EINTR), so for the session's lifetime SIGINT
    # also raises KeyboardInterrupt, which ends the session. Installed only
    # on the main thread.
    prev_handler = None
    try:
        def _sigint(*_):
            ctx.cancel()
            raise KeyboardInterrupt

        prev_handler = signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        prev_handler = None  # not the main thread

    try:
        while True:
            if ctx.done():
                return
            if tty:
                stderr.write("> ")
                stderr.flush()
            line = stdin.readline()
            if not line or ctx.done():
                return  # EOF, or cancelled while blocked
            line = line.strip()
            if not line:
                continue
            cmd = line.split()[0]
            if cmd in ("/exit", "/quit"):
                return
            if cmd == "/reset":
                history = []
                if tty:
                    stderr.write("conversation cleared\n")
                continue
            if cmd == "/judge":
                parts = line.split()
                if len(parts) == 2:
                    cfg.judge = parts[1]
                stderr.write(f"judge: {cfg.judge}\n")
                continue
            if cmd == "/models":
                for tok in line.split()[1:]:
                    if tok.startswith("+"):
                        if tok[1:] and tok[1:] not in cfg.models:
                            cfg.models.append(tok[1:])
                    elif tok.startswith("-"):
                        if tok[1:] in cfg.models:
                            if len(cfg.models) == 1:
                                stderr.write("cannot remove the last panel model\n")
                            else:
                                cfg.models.remove(tok[1:])
                stderr.write(f"models: {','.join(cfg.models)}\n")
                continue
            if cmd.startswith("/"):
                stderr.write(f"unknown command {cmd!r}\n")
                continue

            query_cfg = replace(cfg, prompt=line, continue_run="")
            try:
                out = _run(query_cfg, ctx, factory=factory, stdout=stdout, stderr=stderr,
                           history=list(history))
            except CLIError as err:
                # One failed query does not end the session.
                stderr.write(f"error: {err}\n")
                continue
            history.append({"prompt": line, "consensus": out.consensus})
    except KeyboardInterrupt:
        return
    finally:
        if prev_handler is not None:
            try:
                signal.signal(signal.SIGINT, prev_handler)
            except ValueError:
                pass


def main(
    argv: Optional[list[str]] = None,
    *,
    device: DeviceLike = None,
    factory: Optional[ProviderFactory] = None,
    stdin: Optional[TextIO] = None,
    stdout: Optional[TextIO] = None,
    stderr: Optional[TextIO] = None,
    install_signal_handlers: bool = True,
    shutdown: Optional[threading.Event] = None,
) -> int:
    """Run the CLI; returns the exit code. ``device=None`` resolves to the
    current CUDA card and raises ``RuntimeError`` when there is none.
    ``main(["serve", ...])`` runs the resident gateway (cli/serve.py) and
    ``main(["route", ...])`` the fleet router (cli/route.py) until
    SIGTERM/SIGINT or, in process, until ``shutdown`` is set;
    ``main(["distill", ...])`` one distillation run (cli/distill.py)."""
    argv = sys.argv[1:] if argv is None else argv
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    if argv and argv[0] in ("serve", "route", "distill"):
        # Resident services have their own flag sets and signal handling
        # (SIGTERM = graceful drain, not context cancel).
        try:
            if argv[0] == "distill":
                # The flywheel's offline half: journal → corpus → distilled
                # checkpoint, one JSON summary.
                from llm_consensus_tpu_torch.cli.distill import distill_main

                return distill_main(argv[1:], stdout=stdout, stderr=stderr,
                                    install_signal_handlers=install_signal_handlers,
                                    device=device)
            if argv[0] == "route":
                from llm_consensus_tpu_torch.cli.route import route_main

                return route_main(argv[1:], stdout=stdout, stderr=stderr,
                                  install_signal_handlers=install_signal_handlers,
                                  shutdown=shutdown)
            from llm_consensus_tpu_torch.cli.serve import serve_main

            return serve_main(argv[1:], stdout=stdout, stderr=stderr,
                              install_signal_handlers=install_signal_handlers,
                              shutdown=shutdown, device=device)
        except CLIError as err:
            stderr.write(f"error: {err}\n")
            return 1
        except SystemExit as err:  # argparse --help / parse errors
            return int(err.code or 0)

    ctx = Context.background().with_cancel()
    if install_signal_handlers:
        # SIGINT/SIGTERM → graceful context cancel.
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, lambda *_: ctx.cancel())
            except ValueError:
                break  # not the main thread
    try:
        cfg = parse_args(argv, stdin, stdout)
        if cfg is None:
            return 0
        if factory is None:
            # --draft reaches the shared gpu provider as an argument of
            # every run, even when empty (set_draft('') clears a previous
            # run's map); injected factories keep their own shape.
            factory = partial(create_provider, device=resolve_device(device), draft=cfg.draft,
                              spec_k=cfg.spec_k)

        run(cfg, ctx, factory=factory, stdout=stdout, stderr=stderr, stdin=stdin)
    except CLIError as err:
        stderr.write(f"error: {err}\n")
        return 1
    except SystemExit as err:  # argparse --help / parse errors
        return int(err.code or 0)
    finally:
        ctx.close()
    return 0
