"""Engine supervision: detect a dead pool, rebuild it, replay its streams
(port of ``llm_consensus_tpu/recovery/supervisor.py`` against the port's
``GPUProvider``).

:class:`EngineSupervisor` fronts every batched generation of one
``GPUProvider`` built with a journal. Two failure modes reach it:

  * **crash**: a pool-fatal exception escapes the batcher's scheduler loop
    (an injected ``crash`` at the ``engine`` fault site, an allocation
    failure). The batcher fails every in-flight future with the exception
    and marks itself ``failed_exc``; each waiting :meth:`run_stream` call
    observes that evidence and enters recovery.
  * **wedge**: the pool stops making progress without raising (an injected
    ``wedge``, a stuck host thread). The watchdog thread (``heartbeat_s`` >
    0) sees a *busy* pool whose decode heartbeat is older than the
    threshold, abandons it (fail futures, clear slots, never join the
    wedged threads), and the waiters recover as for a crash. The wedged
    scheduler thread keeps the old engine referenced until it wakes; it
    then finds its slots cleared, so it emits nothing, and the journal
    entries it held are sealed, so it appends nothing.

Recovery is: tear down (``GPUProvider._recover_batcher``, serialized per
preset, so a pool's worth of concurrent failures costs ONE rebuild),
rebuild engine and batcher through the provider's normal construction path,
then **replay** each journaled stream: re-prefill prompt + emitted prefix
into the fresh pool and continue decoding from the recorded frontier. A
greedy stream resumes with the tokens a single-stream engine produces; the
per-stream text shim suppresses exactly the characters the consumer
already received, so a streaming consumer sees at most a pause.

Not every failure is a dead pool. A kernel that failed to build or launch
(``KernelBuildError``, ``KernelLaunchError``) and a CUDA error reported by
the runtime (an illegal address poisons the context of the process: no
rebuild in it can recover) fail the stream with the error at once; any
other pool death is replayed at most ``max_restarts`` times, then the
stream fails with the error.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import CancelledError
from typing import Optional

from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError
from llm_consensus_tpu_torch.recovery.journal import StreamJournal
from llm_consensus_tpu_torch.utils.context import Cancelled, Context, DeadlineExceeded

# The JAX knobs' defaults: LLMC_ENGINE_HEARTBEAT_S (0: no watchdog) and
# LLMC_ENGINE_RESTARTS.
DEFAULT_HEARTBEAT_S = 0.0
DEFAULT_MAX_RESTARTS = 3


class EngineWedged(RuntimeError):
    """A busy pool's decode heartbeat went stale; the pool was abandoned."""


def device_error(exc: Optional[BaseException]) -> bool:
    """Whether ``exc`` is a kernel build or launch failure, or an error the
    CUDA runtime reported (out-of-memory aside): faults a rebuild in this
    process cannot cure."""
    if exc is None:
        return False
    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


class _StreamShim:
    """Per-stream text continuity across engine incarnations.

    The consumer's ``on_text`` must observe ONE contiguous character stream
    even when the producing pool dies mid-generation. The shim counts
    delivered characters; on replay it (a) silences the dead incarnation's
    late emits (generation check) and (b) suppresses the first
    ``delivered`` characters the replay pre-feed re-produces: the pre-feed
    replays the same decoder pushes, so the cumulative text prefix is
    identical and the seam is character-exact.
    """

    def __init__(self, on_text):
        self._on_text = on_text
        self._lock = threading.Lock()
        self._gen = 0
        self._skip = 0
        self.delivered = 0

    def callback(self):
        gen = self._gen

        def cb(text: str, _gen: int = gen) -> None:
            with self._lock:
                if _gen != self._gen:
                    return  # a dead incarnation waking up late
                if self._skip:
                    if len(text) <= self._skip:
                        self._skip -= len(text)
                        return
                    text = text[self._skip:]
                    self._skip = 0
                self.delivered += len(text)
            self._on_text(text)

        return cb

    def next_incarnation(self) -> None:
        """Silence the old incarnation and arm replay dedup: the next
        incarnation's first ``delivered`` characters are suppressed."""
        with self._lock:
            self._gen += 1
            self._skip = self.delivered


class EngineSupervisor:
    """Watchdog + restart-and-replay over one provider's batcher pools.

    ``heartbeat_s`` and ``max_restarts`` take the JAX knobs' defaults
    (``LLMC_ENGINE_HEARTBEAT_S`` 0.0, ``LLMC_ENGINE_RESTARTS`` 3); the CLI
    reads them through ``utils/knobs.py``."""

    def __init__(self, provider, journal: StreamJournal,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 max_restarts: int = DEFAULT_MAX_RESTARTS):
        # Weak: the watchdog thread must not pin a released provider (and
        # its engines) alive for the life of the process; when the provider
        # is collected, the thread sees None and exits.
        self._provider_ref = weakref.ref(provider)
        self._journal = journal
        self.heartbeat_s = heartbeat_s
        self.max_restarts = max_restarts
        self._lock = threading.Lock()
        self.restarts = 0
        self.replayed_streams = 0
        self._recovering = 0  # pools currently mid-rebuild
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self._obs = obs.recorder()
        # Flight recorder: wedge and restart instants land in the ring (the
        # dump itself fires at the batcher's death evidence).
        self._bb = obs.blackbox.ring()
        if self.heartbeat_s > 0:
            self._watchdog = threading.Thread(
                target=self._watch, name="llmc-engine-watchdog", daemon=True)
            self._watchdog.start()

    # -- the supervised generation path ------------------------------------------

    @property
    def _provider(self):
        provider = self._provider_ref()
        if provider is None:
            raise RuntimeError("provider was released; cannot recover")
        return provider

    def run_stream(self, preset: str, batcher, prompt: str, sampling,
                   ctx: Optional[Context], on_text, priority: int = 1,
                   trace_id: Optional[str] = None):
        """One batched generation that survives engine death.

        Submits the stream journaled to ``batcher``; on a pool-fatal
        failure, recovers the pool (once per pool, shared by every waiter)
        and resubmits with the journaled prompt + emitted prefix until the
        stream completes or ``max_restarts`` incarnations have died."""
        prompt_ids, truncated = batcher.engine._budget_prompt(
            batcher.engine.tokenizer.encode(prompt), sampling.max_new_tokens)
        if not prompt_ids:
            raise ValueError("empty prompt")
        jentry = self._journal.record(list(prompt_ids), sampling, trace=trace_id)
        shim = _StreamShim(on_text) if on_text is not None else None
        replay_ids: list[int] = []
        attempt = 0
        while True:
            cb = shim.callback() if shim is not None else None
            try:
                fut = batcher.submit_ids(
                    prompt_ids, sampling, ctx=ctx, on_text=cb, truncated=truncated,
                    replay_ids=replay_ids, jentry=jentry, priority=priority)
            except (RuntimeError, ValueError) as err:
                if self._recoverable(batcher, err):
                    if attempt >= self.max_restarts:
                        self._latest(jentry).close("failed")
                        raise
                    attempt += 1
                    batcher, jentry, replay_ids = self._recover_stream(
                        preset, batcher, jentry, shim)
                    continue
                # A cleanly closed batcher or a sampling shape this pool
                # does not serve: the direct single-stream path (the
                # provider's own fallback for these).
                return self._fallback_generate(batcher, prompt, sampling, ctx, on_text,
                                               shim, jentry)
            try:
                result = fut.result()
            except (Cancelled, DeadlineExceeded):
                self._latest(jentry).close("deadline")
                raise
            except CancelledError as exc:
                # A dead pool CANCELS its still-queued submissions (they
                # never reached a slot), so a cancelled future on a failed
                # pool is engine death, not shutdown: classify by the
                # pool's evidence, like a raised error.
                if self._recoverable(batcher, exc):
                    if attempt >= self.max_restarts:
                        self._latest(jentry).close("failed")
                        raise
                    attempt += 1
                    batcher, jentry, replay_ids = self._recover_stream(
                        preset, batcher, jentry, shim)
                    continue
                # A benign race: a concurrent close().
                return self._fallback_generate(batcher, prompt, sampling, ctx, on_text,
                                               shim, jentry)
            except BaseException as exc:  # noqa: BLE001 — classified below
                if not self._recoverable(batcher, exc) or attempt >= self.max_restarts:
                    self._latest(jentry).close("failed")
                    raise
                attempt += 1
                batcher, jentry, replay_ids = self._recover_stream(
                    preset, batcher, jentry, shim)
                continue
            if attempt and self._obs is not None:
                self._obs.count("recovery.replayed_streams_completed")
            return result

    def _fallback_generate(self, batcher, prompt, sampling, ctx, on_text, shim, jentry):
        """Direct single-stream fallback off a cleanly closed pool, without
        breaking stream continuity: ``generate`` restarts from token 0, so
        the shim is re-armed to suppress exactly the characters the
        consumer already received."""
        self._latest(jentry).close("fallback")
        cb = on_text
        if shim is not None:
            shim.next_incarnation()
            cb = shim.callback()
        return batcher.engine.generate(prompt, sampling, ctx, on_text=cb)

    def _recoverable(self, batcher, exc: BaseException) -> bool:
        """Pool death (the whole pool failed or was abandoned) is
        recoverable; a per-stream failure on a healthy pool is not, nor a
        device error a rebuild in this process cannot cure."""
        failed = getattr(batcher, "failed_exc", None)
        if device_error(exc) or device_error(failed):
            return False
        return isinstance(exc, EngineWedged) or failed is not None

    def _latest(self, jentry):
        """The stream's current journal entry: a preemption in the batcher
        seals the entry the stream was submitted with and opens a
        replay-seeded successor (its ``replay_of``), which holds every
        token since. (The JAX supervisor keeps the submitted entry, so a
        stream crashed after a preemption replays from the preemption's
        snapshot and its successor stays open.)"""
        while True:
            nxt = next((e for e in self._journal.active() if e.replay_of == jentry.sid), None)
            if nxt is None:
                return jentry
            jentry = nxt

    def _recover_stream(self, preset: str, batcher, jentry, shim):
        """Shared per-stream half of recovery: silence the dead
        incarnation, snapshot the journal (the stream's latest entry),
        obtain the replacement pool (built once, shared), and open the
        continuation entry."""
        if shim is not None:
            shim.next_incarnation()
        jentry = self._latest(jentry)
        replay_ids = jentry.seal()
        t0 = self._obs.now() if self._obs is not None else 0
        with self._lock:
            self._recovering += 1
        try:
            new_batcher = self._provider._recover_batcher(preset, batcher)
        except BaseException:
            # The rebuild itself failed: the stream is terminally dead;
            # retire its entry, or the journal's depth grows by one forever.
            jentry.close("failed")
            raise
        finally:
            with self._lock:
                self._recovering -= 1
        jentry.close("recovered")
        new_entry = self._journal.record(jentry.prompt_ids, jentry.sampling, tokens=replay_ids,
                                         replay_of=jentry, trace=jentry.trace)
        with self._lock:
            self.replayed_streams += 1
        if self._obs is not None:
            self._obs.complete("replay", t0, tid="recovery", preset=preset,
                               prefix_tokens=len(replay_ids))
            self._obs.count("recovery.replayed_streams")
        return new_batcher, new_entry, replay_ids

    # -- bookkeeping the provider calls ------------------------------------------

    def note_restart(self, preset: str) -> None:
        """One pool actually rebuilt (called by the provider's serialized
        recovery path, so concurrent waiters count ONE restart)."""
        with self._lock:
            self.restarts += 1
        if self._obs is not None:
            self._obs.count("recovery.restarts")
            self._obs.instant("engine_restart", tid="recovery", preset=preset)
        if self._bb is not None:
            self._bb.instant("engine_restart", tid="recovery", preset=preset)

    # -- watchdog -----------------------------------------------------------------

    def _watch(self) -> None:
        poll = max(0.05, min(self.heartbeat_s / 4.0, 1.0))
        # id(batcher) -> when this busy stretch was first observed. The
        # wedge clock runs from the LATER of the last heartbeat and the
        # busy-stretch start: a pool that just went busy after a long idle
        # (heartbeat arbitrarily stale) gets a full heartbeat period before
        # it can be called wedged, while a continuously busy pool's stretch
        # start stays fixed, so sustained submissions cannot mask a stall.
        busy_since: dict[int, float] = {}
        while not self._stop.wait(poll):
            provider = self._provider_ref()
            if provider is None:
                return  # provider collected; nothing left to watch
            try:
                entries = provider._batcher_entries()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                continue
            del provider
            live = set()
            now = time.monotonic()
            for preset, batcher in entries:
                key = id(batcher)
                live.add(key)
                try:
                    if batcher.failed_exc is not None or not batcher.busy():
                        busy_since.pop(key, None)
                        continue
                    t_busy = busy_since.setdefault(key, now)
                    age = min(batcher.heartbeat_age(), now - t_busy)
                    if age > self.heartbeat_s:
                        for rec in (self._obs, self._bb):
                            if rec is not None:
                                rec.instant("engine_wedged", tid="recovery", preset=preset,
                                            age_s=round(age, 3))
                        busy_since.pop(key, None)
                        batcher.abandon(EngineWedged(
                            f"engine pool for {preset!r} wedged: busy with no decode "
                            f"heartbeat for {age:.1f}s (> {self.heartbeat_s}s)"))
                except Exception:  # noqa: BLE001
                    continue
            entries = batcher = None  # hold no pool between polls
            for key in list(busy_since):
                if key not in live:
                    busy_since.pop(key, None)

    def close(self) -> None:
        self._stop.set()

    # -- introspection --------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return "recovering" if self._recovering else "ok"

    def stats(self) -> dict:
        with self._lock:
            state = "recovering" if self._recovering else "ok"
            restarts = self.restarts
            replayed = self.replayed_streams
        return {
            "state": state,
            "restarts": restarts,
            "replayed_streams": replayed,
            "heartbeat_s": self.heartbeat_s,
            "journal": self._journal.stats(),
        }
