"""Stats-provider registry: one assembly path for /statsz and /metricsz
(a copy of ``llm_consensus_tpu/serve/stats.py``).

Before this module, every introspection block the gateway serves — kv,
spec, pressure, recovery, fleet, admission, cache — was hand-wired
inside ``gateway.stats()``: adding a subsystem meant editing the
gateway, and the new ``/metricsz`` gauge section would have meant
editing it AGAIN with the same list. :class:`StatsRegistry` inverts
that: subsystems register a named zero-arg snapshot callable once (at
gateway construction), and both surfaces iterate the registry —
``/statsz`` nests each block under its name, ``/metricsz`` flattens each
block's numeric leaves into ``llmc_stat{block=...,key=...}`` gauges
(obs/prom.py). One registration, two surfaces, no drift.

Contract: a provider returning a falsy value (None / ``{}``) omits its
block (opt-in subsystems stay invisible until live), and a provider
that THROWS loses its block for that snapshot, never the response —
introspection endpoints must not 500 because one subsystem is mid-
rebuild.
"""

from __future__ import annotations

from typing import Callable, Optional

from llm_consensus_tpu_torch.analysis import sanitizer


class StatsRegistry:
    """Ordered name → snapshot-callable registry."""

    def __init__(self):
        self._lock = sanitizer.make_lock("serve.stats")
        self._providers: dict = {}  # insertion-ordered

    def register(self, name: str, fn: Callable[[], Optional[dict]]) -> None:
        """Register (or replace) the provider for ``name``. ``fn`` is
        called per snapshot and must be cheap and thread-safe."""
        with self._lock:
            self._providers[name] = fn

    def names(self) -> list:
        with self._lock:
            return list(self._providers)

    def collect(self) -> dict:
        """{name: block} for every provider that returned a truthy
        snapshot; failing providers are skipped (see module docstring)."""
        with self._lock:
            providers = list(self._providers.items())
        out: dict = {}
        for name, fn in providers:
            try:
                block = fn()
            except Exception:  # noqa: BLE001 — stats must not 500
                continue
            if block:
                out[name] = block
        return out


__all__ = ["StatsRegistry"]
