"""Live terminal progress of concurrent model queries (a copy of
``llm_consensus_tpu/ui/progress.py``).

A per-model state machine Pending → Running → Streaming → Complete/Failed;
a background thread repaints every 100 ms by cursor-up + clear-line; the
token estimate is characters / 4; the braille spinner is keyed to the wall
clock.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import IO, Optional

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.ui import ansi

REPAINT_INTERVAL = 0.1  # seconds
SPINNER_FRAMES = ["⠋", "⠙", "⠹", "⠸", "⠼", "⠴", "⠦", "⠧", "⠇", "⠏"]


class ModelStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    STREAMING = "streaming"
    COMPLETE = "complete"
    FAILED = "failed"


@dataclass
class ModelState:
    """State of a single model query."""

    model: str
    status: ModelStatus = ModelStatus.PENDING
    start_time: float = 0.0
    end_time: float = 0.0
    error: Optional[BaseException] = None
    char_count: int = 0
    token_est: int = 0


def spinner(now: Optional[float] = None) -> str:
    """Spinner frame keyed to wall-clock milliseconds."""
    if now is None:
        now = time.time()
    return SPINNER_FRAMES[int(now * 1000 / 100) % len(SPINNER_FRAMES)]


def truncate(s: str, max_len: int) -> str:
    """Single-line truncation with an ellipsis."""
    s = " ".join(s.split("\n")).strip()
    if len(s) > max_len:
        return s[: max_len - 1] + "…"
    return s


class Progress:
    """Real-time progress of N model queries."""

    def __init__(self, w: IO[str], models: list[str], quiet: bool = False):
        self._w = w
        self._order = list(models)
        self._models = {m: ModelState(model=m) for m in models}
        self._start_time = time.monotonic()
        self._quiet = quiet
        self._lock = sanitizer.make_lock("ui.progress")
        self._stop_event = sanitizer.make_event("ui.progress.stop")
        self._thread: Optional[threading.Thread] = None
        self._rendered = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._quiet:
            return
        self._render()
        self._thread = threading.Thread(target=self._loop, name="progress", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_event.wait(REPAINT_INTERVAL):
            self._render()

    def stop(self) -> None:
        if self._quiet:
            return
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join()
        with self._lock:
            if self._rendered:
                self._clear_lines(len(self._order) + 2)

    # -- state transitions --------------------------------------------------

    def model_started(self, model: str) -> None:
        with self._lock:
            state = self._models.get(model)
            if state:
                state.status = ModelStatus.RUNNING
                state.start_time = time.monotonic()

    def model_streaming(self, model: str, chunk: str) -> None:
        with self._lock:
            state = self._models.get(model)
            if state:
                state.status = ModelStatus.STREAMING
                state.char_count += len(chunk)
                state.token_est = state.char_count // 4  # ~4 chars per token

    def model_completed(self, model: str) -> None:
        with self._lock:
            state = self._models.get(model)
            if state:
                state.status = ModelStatus.COMPLETE
                state.end_time = time.monotonic()

    def model_failed(self, model: str, error: BaseException) -> None:
        with self._lock:
            state = self._models.get(model)
            if state:
                state.status = ModelStatus.FAILED
                state.end_time = time.monotonic()
                state.error = error

    # -- rendering ----------------------------------------------------------

    def _render(self) -> None:
        with self._lock:
            if self._rendered:
                self._clear_lines(len(self._order) + 2)
            self._rendered = True

            elapsed = time.monotonic() - self._start_time
            self._w.write(
                f"{ansi.BOLD_CYAN}⚡ Querying {len(self._order)} models{ansi.RESET} "
                f"{ansi.DIM}({elapsed:.1f}s){ansi.RESET}\n"
            )
            for model in self._order:
                self._render_model_line(self._models[model])
            self._w.write("\n")
            self._w.flush()

    def _render_model_line(self, state: ModelState) -> None:
        now = time.monotonic()
        if state.status is ModelStatus.PENDING:
            icon, color, status = "○", ansi.DIM, "pending"
        elif state.status is ModelStatus.RUNNING:
            icon, color = spinner(), ansi.YELLOW
            status = f"connecting... {now - state.start_time:.1f}s"
        elif state.status is ModelStatus.STREAMING:
            icon, color = spinner(), ansi.CYAN
            status = f"streaming ~{state.token_est} tokens {now - state.start_time:.1f}s"
        elif state.status is ModelStatus.COMPLETE:
            icon, color = "✓", ansi.GREEN
            status = f"done ~{state.token_est} tokens in {state.end_time - state.start_time:.1f}s"
        else:
            icon, color = "✗", ansi.RED
            status = f"failed: {state.error}"

        name = truncate(state.model, 25)
        self._w.write(f"  {color}{icon}{ansi.RESET} {name:<25} {color}{status}{ansi.RESET}\n")

    def _clear_lines(self, n: int) -> None:
        self._w.write(ansi.CURSOR_UP_CLEAR * n)
