"""Fault injection: the process-wide plan (port of
``llm_consensus_tpu/faults/``).

``plan()`` returns the installed plan, or None. Unlike the JAX package it
reads no environment: the CLI installs the plan from ``utils/knobs.py``
(``LLMC_FAULTS``, ``LLMC_FAULTS_SEED``) before any provider exists, the
boundary the ``obs/`` planes use. Consumers bind the plan at construction
(``self._faults = faults.plan()``), so a run without faults pays one
``is not None`` check on the hot dispatch paths.

``install()`` and ``reset()`` are the JAX package's; tests and harnesses
flip plans with them between runs.
"""

from __future__ import annotations

import threading
from typing import Optional

from llm_consensus_tpu_torch.faults.plan import (  # noqa: F401 — public API
    SITE_KINDS, FaultPlan, FaultSpec, InjectedFault, parse_spec)

__all__ = [
    "SITE_KINDS", "FaultPlan", "FaultSpec", "InjectedFault",
    "parse_spec", "plan", "install", "reset",
]

_lock = threading.Lock()
_plan: Optional[FaultPlan] = None


def plan() -> Optional[FaultPlan]:
    """The installed fault plan, or None when injection is off."""
    return _plan


def install(p: Optional[FaultPlan]) -> None:
    """Install ``p`` as the process plan."""
    global _plan
    with _lock:
        _plan = p


def reset() -> None:
    """Forget the installed plan."""
    install(None)
