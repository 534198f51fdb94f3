"""Pressure-aware scheduling (port of ``llm_consensus_tpu/pressure/``):
the priority classes.

Preemption itself lives in the continuous batcher
(``ContinuousBatcher.preempt`` and its blocked-higher-class admission
check): a preempted stream's slot and KV window are released and the
stream requeues for a byte-identical resume through ``submit_ids``'s
``replay_ids`` contract.

The ``PressureGovernor`` ladder (``pressure/governor.py`` in the JAX
package) is not ported: it goes with the serving tier, ROADMAP.md queue 1,
item 5.1's governor entry.
"""

from llm_consensus_tpu_torch.pressure.priority import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NAMES,
    PRIORITY_NORMAL,
    parse_priority,
    priority_name,
    resolve_priority,
)

__all__ = [
    "PRIORITY_HIGH",
    "PRIORITY_LOW",
    "PRIORITY_NAMES",
    "PRIORITY_NORMAL",
    "parse_priority",
    "priority_name",
    "resolve_priority",
]
