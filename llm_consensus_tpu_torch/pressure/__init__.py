"""Pressure-aware scheduling (port of ``llm_consensus_tpu/pressure/``):
the priority classes and the governor's degradation ladder.

  * :mod:`pressure.priority`: the classes (HIGH=0 outranks NORMAL=1
    outranks LOW=2) and their derivation from an explicit ``priority``
    field or the request deadline.
  * :mod:`pressure.governor`: the :class:`PressureGovernor`, which samples
    the admission queue, the batchers' headroom and the KV pools' churn
    and walks ``ok → evict → preempt → brownout → shed`` with hysteresis
    both ways; the ``serve`` gateway builds one (``serve.build_gateway``).

Preemption itself lives in the continuous batcher
(``ContinuousBatcher.preempt`` and its blocked-higher-class admission
check): a preempted stream's slot and KV window are released and the
stream requeues for a byte-identical resume through ``submit_ids``'s
``replay_ids`` contract.
"""

from llm_consensus_tpu_torch.pressure.governor import (
    LADDER,
    PressureGovernor,
    parse_judge_fallback,
)
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
    "LADDER",
    "PRIORITY_HIGH",
    "PRIORITY_LOW",
    "PRIORITY_NAMES",
    "PRIORITY_NORMAL",
    "PressureGovernor",
    "parse_judge_fallback",
    "parse_priority",
    "priority_name",
    "resolve_priority",
]
