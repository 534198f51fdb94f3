"""Cancellation contexts, the Python analog of Go's context.Context (a copy
of ``llm_consensus_tpu/utils/context.py`` on plain ``threading``).

  * ``Context.background()``: root, never cancelled.
  * ``ctx.with_timeout(s)`` / ``ctx.with_cancel()``: derived children.
  * Cancelling a parent cancels all descendants.
  * Cooperative: long-running work calls ``ctx.raise_if_done()`` between
    steps (the engine checks at every decode-chunk boundary); blocking I/O
    registers ``ctx.on_done(fn)`` to be interrupted (the HTTP providers
    close their socket) and waits with ``ctx.sleep``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Cancelled(Exception):
    """The context was cancelled (parity: Go context.Canceled)."""

    def __str__(self) -> str:
        return "context canceled"


class DeadlineExceeded(Exception):
    """The context's deadline passed (parity: Go context.DeadlineExceeded)."""

    def __str__(self) -> str:
        return "context deadline exceeded"


class Context:
    """Hierarchical cancellation token with an optional deadline."""

    def __init__(self, deadline: Optional[float] = None,
                 parent: Optional["Context"] = None):
        self._deadline = deadline  # time.monotonic() timestamp
        self._parent = parent
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._children: list[Context] = []
        self._callbacks: list = []
        self._err: Optional[Exception] = None
        if parent is not None:
            parent._check_deadline()
            with parent._lock:
                # Drop finished siblings so a long-lived root does not
                # accumulate dead children across runs.
                parent._children = [c for c in parent._children if not c._event.is_set()]
                parent._children.append(self)
                parent_err = parent._err
            if parent_err is not None:
                self._propagate(parent_err)

    @classmethod
    def background(cls) -> "Context":
        return cls()

    def with_cancel(self) -> "Context":
        return Context(deadline=self._deadline, parent=self)

    def with_timeout(self, seconds: float) -> "Context":
        deadline = time.monotonic() + seconds
        if self._deadline is not None:
            deadline = min(deadline, self._deadline)
        return Context(deadline=deadline, parent=self)

    def cancel(self) -> None:
        self._propagate(Cancelled())

    def _propagate(self, err: Optional[Exception]) -> None:
        with self._lock:
            if self._err is None:
                self._err = err if err is not None else Cancelled()
            self._event.set()
            children, callbacks = self._children, self._callbacks
            self._children, self._callbacks = [], []
        for child in children:
            child._propagate(self._err)
        for fn in callbacks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a hook must not stop propagation
                pass

    def on_done(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Run ``fn`` when this context is cancelled or found expired (at
        once when it already is). Returns the function that unsubscribes
        it."""
        self._check_deadline()
        with self._lock:
            if self._err is None:
                self._callbacks.append(fn)

                def unsubscribe() -> None:
                    with self._lock:
                        if fn in self._callbacks:
                            self._callbacks.remove(fn)

                return unsubscribe
        try:
            fn()
        except Exception:  # noqa: BLE001
            pass
        return lambda: None

    def close(self) -> None:
        """Cancel this context and detach it from its parent (Go's
        ``defer cancel()``)."""
        self._propagate(Cancelled())
        parent = self._parent
        if parent is not None:
            with parent._lock:
                if self in parent._children:
                    parent._children.remove(self)
            self._parent = None

    def _check_deadline(self) -> None:
        if (self._err is None and self._deadline is not None
                and time.monotonic() >= self._deadline):
            self._propagate(DeadlineExceeded())

    def done(self) -> bool:
        self._check_deadline()
        return self._event.is_set()

    def err(self) -> Optional[Exception]:
        self._check_deadline()
        return self._err

    def raise_if_done(self) -> None:
        err = self.err()
        if err is not None:
            raise err

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline, or None if there is no deadline."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def expired_for(self) -> float:
        """Seconds since the deadline passed (0.0 when none, or not yet):
        the runner's watchdog reads it to tell a worker stuck past its
        deadline from one still inside its budget."""
        if self._deadline is None:
            return 0.0
        return max(0.0, time.monotonic() - self._deadline)

    def sleep(self, seconds: float) -> bool:
        """Sleep, waking early on cancellation or at the deadline. Returns
        True when it slept the full ``seconds``."""
        budget = seconds
        rem = self.remaining()
        if rem is not None:
            budget = min(budget, rem)
        interrupted = self._event.wait(budget)
        self._check_deadline()
        return not interrupted and budget == seconds and not self.done()
