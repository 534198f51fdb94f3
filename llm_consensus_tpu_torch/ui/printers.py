"""Static pretty-printers of the CLI (a copy of
``llm_consensus_tpu/ui/printers.py``, without the serving banner)."""

from __future__ import annotations

import os
import stat
from typing import IO

from llm_consensus_tpu_torch.ui import ansi
from llm_consensus_tpu_torch.ui.progress import truncate


def print_header(w: IO[str], prompt: str) -> None:
    """Header box with the truncated prompt."""
    w.write(f"\n{ansi.BOLD_CYAN}╭─ LLM Consensus ─╮{ansi.RESET}\n")
    w.write(f"{ansi.CYAN}│{ansi.RESET} Prompt: {ansi.DIM}{truncate(prompt, 60)}{ansi.RESET}\n")
    w.write(f"{ansi.CYAN}╰─────────────────╯{ansi.RESET}\n\n")


def print_phase(w: IO[str], phase: str) -> None:
    w.write(f"{ansi.BOLD_YELLOW}▸ {phase}{ansi.RESET}\n")


def print_success(w: IO[str], msg: str) -> None:
    w.write(f"{ansi.GREEN}✓ {msg}{ansi.RESET}\n")


def print_error(w: IO[str], msg: str) -> None:
    w.write(f"{ansi.RED}✗ {msg}{ansi.RESET}\n")


def print_model_response(
    w: IO[str], model: str, provider: str, content: str, latency_ms: float
) -> None:
    """Per-model response box."""
    w.write(f"\n{ansi.BLUE}┌─ {model} ({provider}) [{latency_ms / 1000:.1f}s] ─┐{ansi.RESET}\n")
    for line in content.split("\n"):
        w.write(f"{ansi.BLUE}│{ansi.RESET} {line}\n")
    w.write(f"{ansi.BLUE}└─────────────────────────┘{ansi.RESET}\n")


def print_consensus(w: IO[str], consensus: str) -> None:
    """Consensus box."""
    w.write(f"\n{ansi.BOLD_GREEN}╔═══ CONSENSUS ═══╗{ansi.RESET}\n")
    for line in consensus.split("\n"):
        w.write(f"{ansi.GREEN}║{ansi.RESET} {line}\n")
    w.write(f"{ansi.GREEN}╚═════════════════╝{ansi.RESET}\n")


def print_summary(
    w: IO[str], total_models: int, successful: int, failed: int, total_seconds: float
) -> None:
    """Run summary."""
    w.write(f"\n{ansi.DIM}─── Summary ───{ansi.RESET}\n")
    w.write(
        f"Models queried: {total_models} "
        f"({ansi.GREEN}{successful} succeeded{ansi.RESET}, "
        f"{ansi.RED}{failed} failed{ansi.RESET})\n"
    )
    w.write(f"Total time: {total_seconds:.1f}s\n")


def print_throughput(w: IO[str], responses) -> None:
    """One line per response with decode measurements: tokens, steady
    decode tokens/s, MBU and MFU where the card's peaks are known; nothing
    when no response has them."""
    stats = [r for r in responses if getattr(r, "tokens_per_sec", None)]
    if not stats:
        return
    w.write(f"\n{ansi.DIM}─── Throughput (on-device) ───{ansi.RESET}\n")
    for r in stats:
        line = f"{r.model}: {r.tokens} tokens, {r.tokens_per_sec:.1f} tok/s"
        if getattr(r, "mbu", None) is not None:
            line += f", {r.mbu * 100:.0f}% MBU"
        if r.mfu is not None:
            line += f", {r.mfu * 100:.1f}% MFU"
        w.write(line + "\n")


def print_aggregate(w: IO[str], aggregate) -> None:
    """The pool-wide line from the recorder's aggregate
    (``obs/export.aggregate_throughput``): tokens over the union of the
    run's decode window, the token-weighted MFU; nothing for a run without
    one."""
    if not aggregate:
        return
    tokens = aggregate.get("tokens", 0.0)
    rate = aggregate.get("tokens_per_sec", 0.0)
    if not tokens or not rate:
        return
    line = f"Pool: {int(tokens)} tokens, {rate:.1f} tok/s"
    mfu = aggregate.get("mfu")
    if mfu:
        line += f", {mfu * 100:.1f}% MFU"
    w.write(f"{ansi.DIM}{line}{ansi.RESET}\n")


def print_serve_banner(w: IO[str], host: str, port: int, models: list[str], judge: str, *,
                       max_concurrency: int, max_batch: int) -> None:
    """Startup banner of the ``serve`` subcommand."""
    w.write(f"\n{ansi.BOLD_CYAN}╭─ LLM Consensus — serving ─╮{ansi.RESET}\n")
    w.write(f"{ansi.CYAN}│{ansi.RESET} http://{host}:{port}/v1/consensus\n")
    w.write(f"{ansi.CYAN}│{ansi.RESET} panel: {ansi.DIM}{', '.join(models)}{ansi.RESET}\n")
    w.write(f"{ansi.CYAN}│{ansi.RESET} judge: {ansi.DIM}{judge}{ansi.RESET}\n")
    w.write(f"{ansi.CYAN}│{ansi.RESET} capacity: {max_concurrency} concurrent "
            f"runs, {max_batch} batcher slots/preset\n")
    w.write(f"{ansi.CYAN}╰───────────────────────────╯{ansi.RESET}\n")


def is_terminal(f) -> bool:
    """Character-device check."""
    try:
        mode = os.fstat(f.fileno()).st_mode
    except (OSError, ValueError, AttributeError):
        return False
    return stat.S_ISCHR(mode)
