"""The run-telemetry plane of the port (a copy of ``llm_consensus_tpu/obs/``,
cut to the one-shot CLI's paths).

Each plane is one process-wide object, installed by the CLI before any
provider exists (``cli/main.py`` from ``utils/knobs.py``, the one place the
port reads the environment) and bound by its consumers at construction:
engines, batchers, the runner and the provider keep the object, or None,
they saw when they were built, so a disabled plane costs one bound
``is not None`` check per chunk on the hot loops.

  * ``obs.recorder()``: the per-run span/counter recorder (``--events``);
  * ``obs.live``: windowed histograms (device time per family, per-token
    latency by priority class and outcome);
  * ``obs.attrib``: chip-time attribution (device time per program family,
    the goodput token ledger, host gaps, the kernel-build sentinel, HBM);
  * ``obs.roofline``: per-family counted work joined with the attribution
    walls (achieved FLOP/s and bytes/s, verdicts against the ridge);
  * ``obs.blackbox``: the always-on flight-recorder ring;
  * ``obs.profiler``: the bounded ``torch.profiler`` window (``--profile``).

With nothing installed every accessor returns None.
"""

from __future__ import annotations

import threading
from typing import Optional

from llm_consensus_tpu_torch.obs import (  # noqa: F401 — public API
    attrib, blackbox, live, profiler, roofline)
from llm_consensus_tpu_torch.obs.recorder import (  # noqa: F401 — public API
    DEFAULT_MAX_EVENTS, Event, Recorder)

__all__ = [
    "DEFAULT_MAX_EVENTS", "Event", "Recorder", "attrib", "blackbox", "live",
    "profiler", "roofline", "recorder", "install", "reset", "reset_planes",
]

_lock = threading.Lock()
_recorder: Optional[Recorder] = None


def recorder() -> Optional[Recorder]:
    """The installed recorder, or None when run telemetry is off."""
    return _recorder


def install(r: Optional[Recorder]) -> None:
    """Install ``r`` as the process recorder (the CLI's ``--events``)."""
    global _recorder
    with _lock:
        _recorder = r


def reset() -> None:
    install(None)


def reset_planes() -> None:
    """Forget every plane and the recorder: the next CLI run decides them
    from the environment again (tests; a harness between phases)."""
    reset()
    for plane in (attrib, blackbox, live, profiler, roofline):
        plane.reset()
