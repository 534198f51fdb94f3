"""The pressure governor: signals in, a degradation ladder out (a copy of
``llm_consensus_tpu/pressure/governor.py``; its settings are arguments
with the JAX defaults, read from the environment by ``cli/serve.py``).

One :class:`PressureGovernor` per gateway watches three signal families —

  * **admission** — queue-depth fraction and slot occupancy (latency
    already committed to clients);
  * **batcher headroom** — live + queued streams against pool capacity,
    the worst pool across presets;
  * **KV-pool pressure** — arena occupancy plus exhaustion/eviction
    *deltas* since the last sample (an exhausted publish means reuse is
    already being truncated — the silent-degradation signal operators
    could not see before this PR);

— folds them into one pressure scalar in [0, 1], and walks the ladder

    ok → evict → preempt → brownout → shed

with hysteresis in BOTH directions: escalation needs ``up_patience``
consecutive samples at or above the high-water mark, de-escalation needs
``down_patience`` consecutive samples at or below the low-water mark, so
one bursty sample never flaps the fleet into brownout and one quiet
sample never drops its guard mid-overload. Each rung subsumes the ones
below it:

  evict     — drop cold (unreferenced, LRU) KV-pool blocks down to the
              eviction target, trading future prefix reuse for admission
              headroom before anything user-visible degrades.
  preempt   — nudge every continuous batcher to preempt its lowest-
              priority / least-progress stream when a strictly
              higher-priority stream is blocked on a slot (the batcher
              itself verifies the predicate — an unjustified nudge is a
              no-op). Preempted streams resume byte-identically via the
              journal replay contract.
  brownout  — serve degraded-but-fast: clamp ``max_new_tokens``, route
              drafted decode plain (speculation buffers cost HBM and
              speed is no longer the binding constraint), and downgrade
              the judge tier (``LLMC_PRESSURE_JUDGE_FALLBACK``, e.g.
              ``gpu:llama-3-8b=gpu:consensus-1b``); responses carry
              ``degraded: brownout`` so clients can tell.
  shed      — reject the shed classes outright (priority ≥
              ``LLMC_PRESSURE_SHED_CLASS``, default LOW) with a
              class-scaled jittered ``Retry-After`` — high-priority
              clients are told to come back sooner than the flood that
              caused the overload.

Fault site ``pressure`` (qualify with ``@phase=``): ``priority_storm``
fires in :meth:`PressureGovernor.sample` (``phase=governor``) and floods
synthetic low-priority admissions through the real admission controller;
``hbm_squeeze`` fires in ``kv/pool.KVPool.publish`` (``phase=publish``)
and shrinks the effective arena. Both are pure pressure — correctness is
never at stake, which is exactly why the ladder exists.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

LADDER = ("ok", "evict", "preempt", "brownout", "shed")
_RUNG = {name: i for i, name in enumerate(LADDER)}


def parse_judge_fallback(spec: str) -> dict:
    """``LLMC_PRESSURE_JUDGE_FALLBACK`` → {judge model: brownout tier}.

    Same grammar as the draft map: ``small-model`` downgrades every
    judge (``"*"`` key); ``big=small,a=b`` names per-judge pairs.
    """
    spec = (spec or "").strip()
    if not spec:
        return {}
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            judge, _, tier = part.partition("=")
            out[judge.strip()] = tier.strip()
        else:
            out["*"] = part
    return out


class PressureGovernor:
    """Samples pressure signals and walks the degradation ladder.

    ``admission_snapshot`` / ``provider_iter`` are injectable callables
    (tests drive the ladder with synthetic signals through
    :meth:`observe`; the gateway wires the real sources). Thread-safe:
    the sampling thread, the gateway's request threads (``should_shed``
    / ``brownout``), and ``/statsz`` all read under one lock.
    """

    def __init__(
        self,
        admission_snapshot: Optional[Callable[[], dict]] = None,
        provider_iter: Optional[Callable[[], list]] = None,
        *,
        high_water: float = 0.75,
        low_water: float = 0.35,
        up_patience: int = 2,
        down_patience: int = 4,
        poll_s: float = 0.5,
        judge_fallback: Optional[dict] = None,
        brownout_max_new: int = 256,
        shed_class: int = 2,
        evict_target: float = 0.7,
    ):
        self._admission_snapshot = admission_snapshot
        self._provider_iter = provider_iter
        self.high_water = high_water
        self.low_water = low_water
        self.up_patience = max(1, up_patience)
        self.down_patience = max(1, down_patience)
        self.poll_s = poll_s
        self.judge_fallback = dict(judge_fallback or {})
        self.brownout_max_new = brownout_max_new
        self.shed_class = shed_class
        self.evict_target = evict_target
        self._lock = threading.Lock()
        self._rung = 0
        self._above = 0
        self._below = 0
        self._last_pressure = 0.0
        # KV delta baselines (exhaustion/eviction are lifetime counters).
        self._kv_seen = {"exhausted": 0, "evicted_blocks": 0}
        self.counters = {
            "escalations": 0, "de_escalations": 0, "preempt_nudges": 0,
            "evicted_blocks": 0, "brownouts": 0, "shed": 0,
            "storm_admits": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from llm_consensus_tpu_torch import faults, obs

        self._faults = faults.plan()
        self._obs = obs.recorder()
        # Flight recorder: escalating PAST preempt (into brownout/shed)
        # is user-visible degradation — snapshot the ring so the
        # pressure build-up that caused it is on disk.
        self._bb = obs.blackbox.ring()

    # -- state reads (request threads) ----------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return LADDER[self._rung]

    @property
    def brownout(self) -> bool:
        with self._lock:
            return self._rung >= _RUNG["brownout"]

    def should_shed(self, priority: int) -> bool:
        """True when the ladder's shed rung rejects this class outright."""
        with self._lock:
            if self._rung < _RUNG["shed"]:
                return False
            shed = priority >= self.shed_class
        if shed:
            with self._lock:
                self.counters["shed"] += 1
            if self._obs is not None:
                self._obs.count("pressure.shed")
        return shed

    def brownout_judge(self, judge: str, available=None) -> str:
        """The judge tier brownout serves: the configured fallback when
        it exists (and, with ``available``, is actually served here),
        else the original."""
        tier = self.judge_fallback.get(judge, self.judge_fallback.get("*"))
        if not tier or tier == judge:
            return judge
        if available is not None and tier not in available:
            return judge
        return tier

    def clamp_max_tokens(self, max_tokens: Optional[int]) -> int:
        """Brownout output budget: the configured clamp, never raising a
        caller's own tighter cap."""
        if max_tokens is None:
            return self.brownout_max_new
        return min(max_tokens, self.brownout_max_new)

    # -- the ladder -----------------------------------------------------------

    def observe(self, pressure: float) -> str:
        """Feed one pressure sample; returns the (possibly new) state.

        The whole hysteresis state machine, isolated from signal
        collection so tests drive it directly."""
        pressure = min(1.0, max(0.0, float(pressure)))
        transitions = []
        with self._lock:
            prev = self._rung
            self._last_pressure = pressure
            if pressure >= self.high_water:
                self._above += 1
                self._below = 0
            elif pressure <= self.low_water:
                self._below += 1
                self._above = 0
            else:
                # Mid-band samples reset BOTH streaks: patience means
                # consecutive evidence, not evidence-with-gaps.
                self._above = 0
                self._below = 0
            if self._above >= self.up_patience and self._rung < len(LADDER) - 1:
                self._rung += 1
                self._above = 0
                self.counters["escalations"] += 1
                transitions.append(("pressure_escalate", LADDER[self._rung]))
                if self._rung == _RUNG["brownout"]:
                    self.counters["brownouts"] += 1
            if self._below >= self.down_patience and self._rung > 0:
                self._rung -= 1
                self._below = 0
                self.counters["de_escalations"] += 1
                transitions.append(("pressure_deescalate", LADDER[self._rung]))
            rung = self._rung
        for name, state in transitions:
            if self._obs is not None:
                self._obs.instant(
                    name, tid="pressure", state=state,
                    pressure=round(pressure, 3),
                )
                self._obs.count(f"pressure.{name}")
            if self._bb is not None:
                self._bb.instant(
                    name, tid="pressure", state=state,
                    pressure=round(pressure, 3),
                )
                if (
                    name == "pressure_escalate"
                    and _RUNG[state] > _RUNG["preempt"]
                ):
                    self._bb.dump(
                        f"pressure_{state}",
                        extra={"pressure": round(pressure, 3)},
                    )
        b = _RUNG["brownout"]
        if (prev >= b) != (rung >= b):
            self._set_provider_brownout(rung >= b)
        return LADDER[rung]

    def _set_provider_brownout(self, on: bool) -> None:
        """Propagate brownout to the engine tier: drafted decode routes
        plain (single-stream spec bypass off, pooled spec mode forced to
        its plain window) for the brownout's duration."""
        for provider in self._providers():
            fn = getattr(provider, "set_brownout", None)
            if fn is None:
                continue
            try:
                fn(on)
            except Exception:  # noqa: BLE001 — degradation is best-effort
                continue

    # -- signal collection ----------------------------------------------------

    def _providers(self) -> list:
        if self._provider_iter is None:
            return []
        try:
            return list(self._provider_iter())
        except Exception:  # noqa: BLE001
            return []

    def pressure_signals(self) -> dict:
        """The current raw signals (also the /statsz ``pressure.signals``
        block, so operators can see WHICH family is pushing the ladder)."""
        signals = {"queue": 0.0, "slots": 0.0, "batcher": 0.0, "kv": 0.0}
        if self._admission_snapshot is not None:
            try:
                adm = self._admission_snapshot()
            except Exception:  # noqa: BLE001
                adm = None
            if adm:
                if adm.get("max_queue", 0) > 0:
                    signals["queue"] = min(
                        1.0, adm["waiting"] / adm["max_queue"]
                    )
                elif adm.get("waiting"):
                    signals["queue"] = 1.0
                # Slot occupancy scaled BELOW the high-water mark: a
                # fully-utilized server with an empty queue is healthy
                # throughput, not overload — full slots alone must never
                # walk the ladder; they only corroborate queue/KV/
                # batcher pressure (pressure = max of the signals).
                signals["slots"] = 0.7 * min(
                    1.0, adm.get("active", 0)
                    / max(1, adm.get("max_concurrency", 1))
                )
        kv_exhausted = 0
        kv_evicted = 0
        kv_occ = 0.0
        for provider in self._providers():
            stats_fn = getattr(provider, "pressure_stats", None)
            if stats_fn is not None:
                try:
                    for snap in stats_fn().values():
                        cap = max(1, snap.get("cap", 1))
                        signals["batcher"] = max(
                            signals["batcher"],
                            min(1.0, (snap.get("live", 0)
                                      + snap.get("queued", 0)) / cap),
                        )
                except Exception:  # noqa: BLE001
                    pass
            kv_fn = getattr(provider, "kv_stats", None)
            if kv_fn is not None:
                try:
                    for snap in kv_fn().values():
                        kv_exhausted += snap.get("exhausted", 0)
                        kv_evicted += snap.get("evicted_blocks", 0)
                        kv_occ = max(kv_occ, snap.get("occupancy", 0.0))
                except Exception:  # noqa: BLE001
                    pass
        with self._lock:
            d_ex = kv_exhausted - self._kv_seen["exhausted"]
            d_ev = kv_evicted - self._kv_seen["evicted_blocks"]
            self._kv_seen["exhausted"] = kv_exhausted
            self._kv_seen["evicted_blocks"] = kv_evicted
        # Occupancy alone is healthy (a full arena full of warm prefixes
        # is the pool WORKING); pressure is occupancy PLUS churn — an
        # exhausted publish is truncated reuse right now, an eviction
        # wave is reuse being traded away to stay afloat. Eviction churn
        # sits BELOW the high-water mark: routine LRU turnover of a full
        # pool (and the evict rung's own evict_cold — its freed blocks
        # are subtracted from the delta in _evict_cold, but publishes it
        # unblocks evict again next tick) must not ratchet the ladder on
        # its own; only exhaustion escalates outright.
        kv_sig = kv_occ * 0.5
        if d_ev > 0:
            kv_sig = max(kv_sig, 0.7)
        if d_ex > 0:
            kv_sig = 1.0
        signals["kv"] = kv_sig
        return signals

    def sample(self) -> str:
        """One governor tick: collect signals, walk the ladder, apply
        the current rung's continuous actions."""
        if self._faults is not None:
            fs = self._faults.fire("pressure", phase="governor")
            if fs is not None and fs.kind == "priority_storm":
                self._launch_storm(
                    int(fs.param("n", 8)), float(fs.param("s", 0.25))
                )
        signals = self.pressure_signals()
        state = self.observe(max(signals.values(), default=0.0))
        rung = _RUNG[state]
        if rung >= _RUNG["evict"]:
            self._evict_cold()
        if rung >= _RUNG["preempt"]:
            self._nudge_preempt()
        return state

    def _evict_cold(self) -> None:
        freed = 0
        for provider in self._providers():
            fn = getattr(provider, "kv_evict_cold", None)
            if fn is None:
                continue
            try:
                freed += fn(self.evict_target)
            except Exception:  # noqa: BLE001
                continue
        if freed:
            with self._lock:
                self.counters["evicted_blocks"] += freed
                # The governor's OWN evictions are action, not signal:
                # pre-advance the delta baseline so the next sample does
                # not read them back as eviction pressure (a one-way
                # ratchet — evict rung → eviction delta → escalate —
                # that could never de-escalate under steady traffic).
                self._kv_seen["evicted_blocks"] += freed
            if self._obs is not None:
                self._obs.count("pressure.evicted_blocks", freed)

    def _nudge_preempt(self) -> None:
        nudged = False
        for provider in self._providers():
            fn = getattr(provider, "request_preempt", None)
            if fn is None:
                continue
            try:
                fn(1)
                nudged = True
            except Exception:  # noqa: BLE001
                continue
        if nudged:
            with self._lock:
                self.counters["preempt_nudges"] += 1

    def _launch_storm(self, n: int, hold_s: float) -> None:
        """``priority_storm``: flood ``n`` synthetic LOW admits through
        the real admission controller, each holding its slot ``hold_s``
        seconds — deterministic overload the ladder must absorb."""
        if self._admission_snapshot is None or self._storm_admit is None:
            return

        def one() -> None:
            try:
                ticket = self._storm_admit()
            except Exception:  # noqa: BLE001 — shed storms are the point
                return
            try:
                time.sleep(hold_s)
            finally:
                ticket.release()
            with self._lock:
                self.counters["storm_admits"] += 1

        for _ in range(max(1, n)):
            threading.Thread(
                target=one, name="llmc-priority-storm", daemon=True
            ).start()

    # Set by the gateway wiring: a zero-arg callable that performs one
    # LOW-priority admission and returns its Ticket (None → storms are
    # inert, e.g. in unit tests that only drive observe()).
    _storm_admit: Optional[Callable] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="llmc-pressure", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the governor must not die
                continue

    def close(self) -> None:
        self._stop.set()

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": LADDER[self._rung],
                "pressure": round(self._last_pressure, 4),
                **self.counters,
            }
        try:
            out["signals"] = {
                k: round(v, 4) for k, v in self.pressure_signals().items()
            }
        except Exception:  # noqa: BLE001 — stats must not throw
            pass
        return out
