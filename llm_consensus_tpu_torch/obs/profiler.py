"""On-demand deep profiling: a bounded ``torch.profiler`` window (the port
of ``llm_consensus_tpu/obs/profiler.py``).

When a family's achieved rate says something is wrong, the next question
(which kernel, which copy, what overlap) needs the real profiler. This
module arms one ``torch.profiler`` window on demand (``--profile`` on a
CLI run) with the flight recorder's safety rails:

  * **bounded**: the window lasts ``duration_s`` at most (clamped to
    ``LLMC_PROFILE_MAX_S``): the run closes it at its end, or at the first
    phase boundary past the bound (:meth:`DeepProfiler.stop_if_expired`);
  * **single-flight and rate-limited**: one window at a time, at most one
    start per ``LLMC_PROFILE_MIN_INTERVAL_S``;
  * **atomic artifact directory**: the trace lands in ``<final>.partial``,
    renamed to ``<final>`` after the profiler stopped, so a directory that
    is visible is complete.

On a card the window records CPU and CUDA activities; on the CPU, CPU
activities only. The artifact is a Chrome trace, ``trace.json``.

``torch.profiler`` must stop on the thread that started it (stopping it
from a timer thread, as the JAX window does, crashes the process), so the
window has no timer: the thread that armed it closes it. Its CPU rows are
that thread's operators; the card's kernels come from every thread. A
window armed from a thread that ends at once (the gateway's HTTP handler
behind ``POST /debugz/profile``) runs on a thread of its own
(:meth:`DeepProfiler.arm_owned`), which arms, waits out the bound and
closes it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

DEFAULT_DIR = os.path.join("data", "_artifacts", "profiles")
DEFAULT_MAX_S = 10.0
DEFAULT_MIN_INTERVAL_S = 60.0
TRACE_FILE = "trace.json"


class DeepProfiler:
    """Arms bounded ``torch.profiler`` windows."""

    def __init__(self, out_dir: str = DEFAULT_DIR, max_s: float = DEFAULT_MAX_S,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S):
        self.out_dir = out_dir
        self.max_s = max_s
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._prof = None
        self._paths: Optional[tuple] = None  # (partial, final)
        self._last_start = 0.0
        self._deadline = 0.0
        self.windows = 0
        self.suppressed = 0
        self.last_path: Optional[str] = None
        self.last_duration_s: Optional[float] = None

    def arm(self, duration_s: Optional[float] = None,
            tag: str = "ondemand") -> "tuple[Optional[str], str]":
        """Start one window; returns ``(final_path, status)``, status
        ``"armed"``, ``"busy"`` or ``"rate_limited"``. A profiler that
        fails to start raises."""
        from torch.profiler import profile

        dur = max(0.05, min(float(duration_s) if duration_s else self.max_s, self.max_s))
        with self._lock:
            if self._prof is not None:
                self.suppressed += 1
                return None, "busy"
            now = time.monotonic()
            if self.windows > 0 and now - self._last_start < self.min_interval_s:
                self.suppressed += 1
                return None, "rate_limited"
            safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in str(tag))[:32]
            final = os.path.join(self.out_dir, f"profile-{safe or 'ondemand'}-{time.time_ns()}")
            partial = final + ".partial"
            os.makedirs(partial, exist_ok=True)
            prof = profile(activities=_activities())
            prof.__enter__()
            self._prof, self._paths = prof, (partial, final)
            # The bound runs from the moment the profiler records (its
            # start-up can take seconds on a loaded host).
            self._last_start, self._deadline = now, time.monotonic() + dur
        return final, "armed"

    def arm_owned(self, duration_s: Optional[float] = None, tag: str = "ondemand",
                  stop: Optional[threading.Event] = None) -> "tuple[Optional[str], str]":
        """:meth:`arm` on a new owning thread, which closes the window at its
        bound (or when ``stop`` is set); returns ``arm``'s result once the
        window is armed or refused, and re-raises its failure."""
        out: dict = {}
        ready = threading.Event()
        stop = stop if stop is not None else threading.Event()

        def own() -> None:
            try:
                out["armed"] = self.arm(duration_s, tag=tag)
            except BaseException as err:  # noqa: BLE001 — re-raised by the caller
                out["error"] = err
                return
            finally:
                ready.set()
            if out["armed"][1] != "armed":
                return
            with self._lock:
                deadline = self._deadline
            stop.wait(max(0.0, deadline - time.monotonic()))
            self.stop_now()

        threading.Thread(target=own, name="llmc-profile-window", daemon=True).start()
        ready.wait()
        if "error" in out:
            raise out["error"]
        return out["armed"]

    def expired(self) -> bool:
        """Whether the open window outlived its bound."""
        with self._lock:
            return self._prof is not None and time.monotonic() >= self._deadline

    def stop_if_expired(self) -> Optional[str]:
        """Close the window if it outlived its bound (a phase boundary of
        the arming thread); returns the artifact path, or None."""
        return self.stop_now() if self.expired() else None

    def stop_now(self) -> Optional[str]:
        """Close the open window (on the thread that armed it): export the
        trace, rename the directory into place; returns its path, or None
        when no window was open."""
        import torch

        with self._lock:
            prof, paths = self._prof, self._paths
            self._prof = self._paths = None
        if prof is None:
            return None
        partial, final = paths
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the window's last kernels land in the trace
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(partial, TRACE_FILE))
        os.replace(partial, final)
        with self._lock:
            self.windows += 1
            self.last_path = final
            self.last_duration_s = time.monotonic() - self._last_start
        return final

    def stats(self) -> dict:
        with self._lock:
            return {"active": self._prof is not None, "windows": self.windows,
                    "suppressed": self.suppressed, "max_s": self.max_s,
                    "min_interval_s": self.min_interval_s, "last_path": self.last_path,
                    "last_duration_s": self.last_duration_s}


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    if torch.cuda.is_available():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


class trace_window:
    """``torch.profiler`` over a block, unbounded (the CLI's ``--trace
    DIR``): the Chrome trace lands in ``DIR/trace.json``, written under a
    ``.partial`` name and renamed into place, so the file that is visible
    is complete. Entering starts the profiler (and raises if it cannot)."""

    def __init__(self, out_dir: str) -> None:
        from torch.profiler import profile

        self.out_dir = out_dir
        self.path = os.path.join(out_dir, TRACE_FILE)
        self._prof = profile(activities=_activities())

    def __enter__(self) -> "trace_window":
        os.makedirs(self.out_dir, exist_ok=True)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the run's last kernels land in the trace
        self._prof.__exit__(exc_type, exc, tb)
        partial = self.path + ".partial"
        self._prof.export_chrome_trace(partial)
        os.replace(partial, self.path)


_lock = threading.Lock()
_profiler: Optional[DeepProfiler] = None
_resolved = False


def profiler() -> Optional[DeepProfiler]:
    """The installed deep profiler, or None."""
    return _profiler


def resolved() -> bool:
    return _resolved


def install(p: Optional[DeepProfiler]) -> None:
    global _profiler, _resolved
    with _lock:
        _profiler = p
        _resolved = True


def reset() -> None:
    global _profiler, _resolved
    with _lock:
        _profiler = None
        _resolved = False


__all__ = ["DEFAULT_DIR", "DEFAULT_MAX_S", "DEFAULT_MIN_INTERVAL_S", "DeepProfiler",
           "TRACE_FILE", "install", "profiler", "reset", "resolved", "trace_window"]
