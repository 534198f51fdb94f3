"""Parallel best-effort fan-out of one prompt to N models (port of
``llm_consensus_tpu/runner/runner.py``).

  * One worker thread per model, all started together.
  * Per-model deadline via a child context.
  * Every panel query carries the runner's priority class (``priority``,
    None for the provider's default), which a batched engine admits and
    preempts by.
  * Best-effort: a model failure becomes a warning and a ``failed_models``
    entry and never cancels siblings; workers never raise.
  * Responses are appended in completion order under a lock.
  * Only a total wipeout is an error.
  * A per-model watchdog: a worker past its deadline that has not streamed
    for ``stall_grace`` seconds is booked failed and abandoned, so ``run``
    never blocks on a wedged worker. Abandoned workers run as daemon
    threads against a sealed result: late completions are dropped.
  * Fault injection (faults/), bound at construction: the ``runner`` site
    (``worker_stall@model=<m>@s=<secs>``) makes a worker sleep without
    cooperating, the wedge the watchdog exists to catch.
  * Telemetry (obs/), bound at construction: a ``worker`` span per model
    (tid "runner") on the recorder and the flight recorder, and a
    ``watchdog_abandon`` instant when the watchdog gives a worker up.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.providers import Registry, Request, Response
from llm_consensus_tpu_torch.utils.context import Context

DEFAULT_STALL_GRACE_S = 5.0


@dataclass
class Callbacks:
    """Progress hooks, all optional."""

    on_model_start: Optional[Callable[[str], None]] = None
    # Each streamed chunk of a model's answer (the TTY progress display).
    on_model_stream: Optional[Callable[[str, str], None]] = None
    on_model_complete: Optional[Callable[[str], None]] = None
    on_model_error: Optional[Callable[[str, Exception], None]] = None
    # The full response the moment its worker records it (the CLI's panel
    # journal); its failures are swallowed: a hook never fails a model.
    on_model_response: Optional[Callable[[Response], None]] = None


@dataclass
class RunResult:
    """Outcome of a fan-out run."""

    responses: list[Response] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)
    failed_models: list[str] = field(default_factory=list)


class AllModelsFailed(RuntimeError):
    """Every panel model failed."""


class WorkerStalled(RuntimeError):
    """A worker exceeded its deadline without streaming and was abandoned."""


class Runner:
    """Queries N models concurrently, collecting partial results."""

    def __init__(self, registry: Registry, timeout: float,
                 max_tokens: Optional[int] = None,
                 system: Optional[str] = None,
                 stall_grace: float = DEFAULT_STALL_GRACE_S,
                 priority: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 resume: Optional[dict] = None):
        self._registry = registry
        self._timeout = timeout
        self._max_tokens = max_tokens
        self._system = system  # system prompt for every panel query
        # Priority class of every panel query (pressure/priority.py); None
        # is the provider's default (NORMAL).
        self._priority = priority
        # The serving request's trace id: on every worker span and in each
        # provider Request, so it reaches the engine hop.
        self._trace = trace_id
        # A migrated run's resume payloads by model name (serve/elastic.py):
        # each worker hands its model's payload to the provider.
        self._resume = resume or {}
        self._stall_grace = stall_grace
        self._callbacks = Callbacks()
        self._faults = faults.plan()
        self._obs = obs.recorder()
        self._bb = obs.blackbox.ring()

    def with_callbacks(self, callbacks: Callbacks) -> "Runner":
        self._callbacks = callbacks
        return self

    def run(self, ctx: Context, models: list[str], prompt: str) -> RunResult:
        result = self._collect(ctx, models, prompt)
        # Zero responses, including an empty model list, is a run failure.
        if not result.responses:
            raise AllModelsFailed("all models failed: " + "; ".join(result.warnings))
        return result

    def _collect(self, ctx: Context, models: list[str], prompt: str) -> RunResult:
        result = RunResult()
        lock = threading.Lock()
        sealed = [False]
        # Per-worker state is keyed by worker INDEX: a panel may name the
        # same model twice.
        done: set = set()       # workers that recorded an outcome
        abandoned: set = set()  # workers the watchdog booked as stalled
        ctxs: dict[int, Context] = {}
        activity: dict[int, float] = {}
        cb = self._callbacks

        def record_failure(wid: int, model: str, err: Exception) -> None:
            with lock:
                if sealed[0] or wid in abandoned:
                    return
                done.add(wid)
                result.warnings.append(f"{model}: {err}")
                result.failed_models.append(model)

        def worker(model: str, wid: int) -> None:
            # Workers never raise: failures, including ones thrown by the
            # caller's callbacks, become warnings.
            t0_obs = (time.monotonic_ns()
                      if self._obs is not None or self._bb is not None else 0)
            try:
                query_one(model, wid)
            except Exception as err:  # noqa: BLE001 — the best-effort boundary
                with lock:
                    accounted = wid in done or wid in abandoned
                if not accounted:
                    record_failure(wid, model, err)
                    if cb.on_model_error:
                        try:
                            cb.on_model_error(model, err)
                        except Exception:  # noqa: BLE001
                            pass
            finally:
                targs = {"trace": self._trace} if self._trace else {}
                for rec in (self._obs, self._bb):
                    if rec is not None:
                        rec.complete("worker", t0_obs, tid="runner", model=model, wid=wid,
                                     **targs)

        def query_one(model: str, wid: int) -> None:
            model_ctx = ctx.with_timeout(self._timeout)
            with lock:
                ctxs[wid] = model_ctx
            try:
                if cb.on_model_start:
                    cb.on_model_start(model)
                if self._faults is not None:
                    # worker_stall[@model=name][@s=secs]: a NON-cooperative
                    # sleep (it ignores model_ctx), the wedge the watchdog
                    # exists to catch.
                    fs = self._faults.fire("runner", model=model)
                    if fs is not None:
                        time.sleep(float(fs.param(
                            "s", self._timeout + 2 * self._stall_grace + 1.0)))
                try:
                    provider = self._registry.get(model)
                except Exception as err:  # noqa: BLE001
                    record_failure(wid, model, err)
                    if cb.on_model_error:
                        cb.on_model_error(model, err)
                    return

                def on_chunk(chunk: str) -> None:
                    # Streaming proves liveness to the watchdog.
                    with lock:
                        activity[wid] = time.monotonic()
                    if cb.on_model_stream:
                        cb.on_model_stream(model, chunk)

                try:
                    resp = provider.query_stream(
                        model_ctx,
                        Request(model=model, prompt=prompt, max_tokens=self._max_tokens,
                                system=self._system, priority=self._priority,
                                trace_id=self._trace, resume=self._resume.get(model)),
                        on_chunk,
                    )
                except Exception as err:  # noqa: BLE001
                    record_failure(wid, model, err)
                    if cb.on_model_error:
                        cb.on_model_error(model, err)
                    return

                with lock:
                    if sealed[0] or wid in abandoned:
                        return  # the watchdog already booked this worker failed
                    done.add(wid)
                    result.responses.append(resp)
                    if resp.truncated:
                        result.warnings.append(
                            f"{model}: prompt truncated to fit context window"
                        )
                if cb.on_model_response:
                    # Outside the lock; a hook must not fail a model that
                    # answered.
                    try:
                        cb.on_model_response(resp)
                    except Exception:  # noqa: BLE001
                        pass
                if cb.on_model_complete:
                    cb.on_model_complete(model)
            finally:
                model_ctx.close()

        threads = [
            (threading.Thread(target=worker, args=(m, i), name=f"runner-{i}-{m}",
                              daemon=True), m, i)
            for i, m in enumerate(models)
        ]
        for t, _, _ in threads:
            t.start()
        self._join_with_watchdog(threads, ctxs, activity, lock, result, done, abandoned)
        with lock:
            sealed[0] = True
        return result

    def _join_with_watchdog(self, threads, ctxs, activity, lock, result,
                            done: set, abandoned: set) -> None:
        """Join workers, abandoning any that wedge past their deadline: a
        worker whose context expired more than the stall grace ago, with
        no streaming inside that window, is booked failed and dropped."""
        grace = self._stall_grace
        cb = self._callbacks
        pending = list(threads)
        while pending:
            still: list = []
            for t, model, wid in pending:
                t.join(timeout=0.05)
                if not t.is_alive():
                    continue
                with lock:
                    mctx = ctxs.get(wid)
                    last = activity.get(wid)
                overdue = mctx.expired_for() if mctx is not None else 0.0
                recent = last is not None and time.monotonic() - last < grace
                if overdue > grace and not recent:
                    err = WorkerStalled(
                        f"worker exceeded its deadline by {overdue:.1f}s "
                        "without streaming; abandoned"
                    )
                    # Outcome check, failure booking and abandonment under
                    # one lock hold: a worker resolving concurrently gets
                    # exactly one outcome.
                    with lock:
                        accounted = wid in done or wid in abandoned
                        if not accounted:
                            abandoned.add(wid)
                            result.warnings.append(f"{model}: {err}")
                            result.failed_models.append(model)
                    if not accounted and self._obs is not None:
                        self._obs.instant("watchdog_abandon", tid="runner", model=model,
                                          wid=wid, overdue_s=round(overdue, 3))
                    if not accounted and cb.on_model_error:
                        try:
                            cb.on_model_error(model, err)
                        except Exception:  # noqa: BLE001
                            pass
                    continue
                still.append((t, model, wid))
            pending = still
