"""Canary watcher: auto-rollback for freshly swapped weights (a copy of
``llm_consensus_tpu/flywheel/canary.py``; its settings are arguments whose
defaults are the JAX knobs' defaults, and its lock is a plain ``threading``
lock). No module of the port builds a watcher yet: its environment knobs
come with the first caller.

The last guard of the data flywheel. After a distilled checkpoint is
hot-swapped in (Engine.swap_weights via POST /v1/swap), the router's
canary lane steers an ``LLMC_CANARY_FRACTION`` slice of the keyspace at
the new version while everyone else stays on baseline (serve/router.py).
The :class:`CanaryWatcher` compares the two cohorts' latency tails and
pulls the cord when the new weights regress serving — rolling back is
one call (Engine.rollback_weights restores the double-buffered previous
params under a NEW monotone version), so the cost of a bad checkpoint is
a few windows of slightly slow canary traffic, never an incident.

The watcher is deliberately transport-agnostic: feed it version-labeled
request latencies with :meth:`record` from wherever canary traffic is
visible — the router's proxy loop (replica weight version), a gateway
serving a swapped engine (its own ``weight_version()``), or a dryrun
lane's probe clients. :meth:`tick` closes one comparison window, in the
:class:`~llm_consensus_tpu_torch.obs.live.SLOWatcher` idiom: a regression must
hold for ``windows`` CONSECUTIVE windows before ``on_regress``
fires (one slow window is noise, N in a row is the new weights), each
window needs ``min_samples`` in BOTH cohorts to count
(starved cohorts reset the streak — no verdicts from anecdotes), and
firing re-arms the streak so the next regression needs N fresh windows.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

# Per-(version, window) sample cap: the watcher compares tails, it does
# not archive traffic — beyond this, extra samples change p99 by noise.
_WINDOW_CAP = 4096


def _quantile(sorted_values: list, q: float) -> float:
    """Nearest-rank quantile of an already-sorted, non-empty list."""
    idx = min(len(sorted_values) - 1, int(q * len(sorted_values)))
    return sorted_values[idx]


class CanaryWatcher:
    """p99-ratio streak over version-labeled latencies ⇒ rollback hook.

    ``on_regress`` receives one dict (canary/baseline versions, p99s,
    ratio, streak length) and is expected to roll the canary back —
    e.g. ``lambda info: provider.rollback_weights(model)`` or a POST to
    the gateway's ``/v1/swap`` with ``action: rollback``. Exceptions
    from the hook are swallowed: a broken rollback path must not take
    the serving thread that ticked the watcher down with it.
    """

    def __init__(
        self,
        tol: float = 1.5,
        windows: int = 3,
        min_samples: int = 4,
        on_regress: Optional[Callable[[dict], None]] = None,
    ):
        self.tol = float(tol)
        self.windows = max(1, int(windows))
        self.min_samples = max(1, int(min_samples))
        self.on_regress = on_regress
        self._lock = threading.Lock()
        self._window: dict = {}  # version -> [latency_s, ...] (open window)
        self._streak = 0
        self.windows_closed = 0
        self.regressions = 0
        self.last_ratio: Optional[float] = None

    # -- feeding --------------------------------------------------------------

    def record(self, version: int, latency_s: float) -> None:
        """One request latency served at ``version`` (0 = baseline)."""
        with self._lock:
            bucket = self._window.setdefault(int(version), [])
            if len(bucket) < _WINDOW_CAP:
                bucket.append(float(latency_s))

    # -- evaluation -----------------------------------------------------------

    def tick(self) -> bool:
        """Close the open window and judge it; True when a rollback
        fired. Call on a fixed cadence (the live plane's rotation hook,
        a lane's probe loop) — window length IS the caller's cadence."""
        with self._lock:
            window, self._window = self._window, {}
            self.windows_closed += 1
            versions = sorted(window)
            if len(versions) < 2:
                # Version-uniform traffic: nothing to compare. NOT a
                # streak reset — a lull in canary placement must not
                # erase evidence already accumulated against it.
                return False
            baseline, canary = versions[0], versions[-1]
            base_samples = sorted(window[baseline])
            canary_samples = sorted(window[canary])
            if (
                len(base_samples) < self.min_samples
                or len(canary_samples) < self.min_samples
            ):
                self._streak = 0  # starved window: anecdotes don't count
                return False
            base_p99 = _quantile(base_samples, 0.99)
            canary_p99 = _quantile(canary_samples, 0.99)
            ratio = canary_p99 / max(base_p99, 1e-9)
            self.last_ratio = round(ratio, 4)
            if ratio <= self.tol:
                self._streak = 0
                return False
            self._streak += 1
            if self._streak < self.windows:
                return False
            self._streak = 0  # re-arm: the NEXT verdict needs N windows
            self.regressions += 1
            info = {
                "canary_version": canary,
                "baseline_version": baseline,
                "canary_p99_s": canary_p99,
                "baseline_p99_s": base_p99,
                "ratio": self.last_ratio,
                "windows": self.windows,
            }
            hook = self.on_regress
        # Outside the lock: the hook rolls weights back (engine swap
        # lock) — holding the watcher lock across it would stack a
        # foreign lock under flywheel.canary for no reason.
        if hook is not None:
            try:
                hook(info)
            except Exception:  # noqa: BLE001 — rollback hook must not kill us
                pass
        return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "windows_closed": self.windows_closed,
                "regressions": self.regressions,
                "streak": self._streak,
                "last_ratio": self.last_ratio,
                "tol": self.tol,
                "windows": self.windows,
                "min_samples": self.min_samples,
            }
