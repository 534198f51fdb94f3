"""Membership lifecycle of a gateway (the constants and transition rules of
``llm_consensus_tpu/serve/elastic.py``; its scale controller, migration
records and the fleet's use of them come with the route slice).

A gateway is ``joining`` (not placeable until warm), ``serving``,
``draining`` (admission stopped), ``retiring`` or ``quarantined`` (stepped
aside after repeated integrity failures; clean probe windows bring it back
to ``serving``). Only ``serving`` replicas take new work.
"""

from __future__ import annotations

JOINING = "joining"
SERVING = "serving"
DRAINING = "draining"
RETIRING = "retiring"
QUARANTINED = "quarantined"

LIFECYCLES = (JOINING, SERVING, DRAINING, RETIRING, QUARANTINED)

# Legal transitions: forward only, except that a drain may be cancelled
# and a quarantine lifted.
_NEXT = {
    JOINING: (SERVING,),
    SERVING: (DRAINING, QUARANTINED),
    DRAINING: (RETIRING, SERVING),
    RETIRING: (),
    QUARANTINED: (SERVING, DRAINING),
}


def placeable(lifecycle: str) -> bool:
    """Only ``serving`` replicas take new work."""
    return lifecycle == SERVING


def can_transition(cur: str, nxt: str) -> bool:
    return nxt in _NEXT.get(cur, ())


__all__ = ["DRAINING", "JOINING", "LIFECYCLES", "QUARANTINED", "RETIRING", "SERVING",
           "can_transition", "placeable"]
