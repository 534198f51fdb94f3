"""Priority classes and their derivation (port of
``llm_consensus_tpu/pressure/priority.py``).

Three classes, ordered so LOWER numbers outrank higher ones (sorting by the
class value gives dequeue order directly):

  * ``PRIORITY_HIGH`` (0): interactive or deadline-critical work. A
    consensus run's judge outranks its panel by one class: the judge is the
    run's serialization point.
  * ``PRIORITY_NORMAL`` (1): the default for panel work and for requests
    that state no preference.
  * ``PRIORITY_LOW`` (2): batch and best-effort traffic, first to be
    preempted.

An explicit class wins; otherwise the request's deadline classifies it: a
budget at or under the high threshold reads as HIGH, one at or over the
low threshold as LOW, anything between as NORMAL. The thresholds come from
``utils/knobs.py`` ``priority_deadlines`` (the JAX package's 15 s and
600 s defaults).
"""

from __future__ import annotations

from typing import Optional

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

PRIORITY_NAMES = {"high": PRIORITY_HIGH, "normal": PRIORITY_NORMAL, "low": PRIORITY_LOW}
_NAME_OF = {v: k for k, v in PRIORITY_NAMES.items()}


def priority_name(priority: int) -> str:
    """The name of one class (clamped into the known range)."""
    return _NAME_OF[min(max(int(priority), PRIORITY_HIGH), PRIORITY_LOW)]


def parse_priority(value) -> int:
    """An explicit class: "high"/"normal"/"low", 0/1/2, or the digit
    strings a CLI flag arrives as. Raises ``ValueError`` on anything else:
    a typo'd class fails the request instead of running NORMAL."""
    if isinstance(value, str):
        name = value.strip().lower()
        if name in PRIORITY_NAMES:
            return PRIORITY_NAMES[name]
        try:
            value = int(name)
        except ValueError:
            raise ValueError(
                f"unknown priority {value!r} "
                f"(expected one of {sorted(PRIORITY_NAMES)} or 0-2)"
            ) from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"priority must be a name or an integer class, got {value!r}")
    if not PRIORITY_HIGH <= value <= PRIORITY_LOW:
        raise ValueError(f"priority {value} out of range [{PRIORITY_HIGH}, {PRIORITY_LOW}]")
    return value


def resolve_priority(explicit=None, timeout_s: Optional[float] = None) -> int:
    """The request's class: the explicit one first, else derived from the
    deadline, else NORMAL."""
    if explicit is not None:
        return parse_priority(explicit)
    if timeout_s is not None:
        from llm_consensus_tpu_torch.utils.knobs import priority_deadlines

        high_s, low_s = priority_deadlines()
        if timeout_s <= high_s:
            return PRIORITY_HIGH
        if timeout_s >= low_s:
            return PRIORITY_LOW
    return PRIORITY_NORMAL
