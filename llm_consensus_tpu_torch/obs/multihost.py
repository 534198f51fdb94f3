"""Merge every controller's timeline into one Chrome trace (port of
``llm_consensus_tpu/obs/multihost.py``).

Each process records on its own ``time.monotonic_ns`` clock. The events
travel through the same bounded allgather as the result merge
(parallel/multicontroller.py), so a dead or degraded peer costs its
timeline, never the merge. Each payload carries its sender's clock read
just before the collective, which every process enters together, so
``offset_i = t_mine - t_i`` maps peer ``i``'s timestamps onto this clock to
within the barrier's entry skew: enough to line up phase-level spans.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.obs.recorder import Event, Recorder

# Per-controller cap on events shipped through the exchange (the newest
# stay); local traces are never truncated.
MERGE_MAX_EVENTS = 100_000


def _serialize(events: list) -> list:
    return [{"name": e.name, "ph": e.ph, "ts_ns": e.ts_ns, "tid": e.tid,
             "dur_ns": e.dur_ns, "args": e.args} for e in events]


def _deserialize(raw: list) -> list:
    return [Event(name=d["name"], ph=d["ph"], ts_ns=int(d["ts_ns"]), tid=d["tid"],
                  dur_ns=int(d.get("dur_ns", 0)), args=d.get("args") or {}) for d in raw]


def merge_timelines(recorder: Recorder, timeout: Optional[float] = None
                    ) -> "tuple[dict, list[int]]":
    """Every reachable controller's timeline as one trace document, and the
    controllers whose timeline never arrived. In one process the exchange
    is the identity and the events are :func:`obs.export.local_trace`'s."""
    from llm_consensus_tpu_torch.obs import export
    from llm_consensus_tpu_torch.parallel import multicontroller as mc

    me = mc.process_index()
    events = recorder.events()
    truncated = max(len(events) - MERGE_MAX_EVENTS, 0)
    payload = {"pid": me, "clock_ns": Recorder.now(), "truncated": truncated,
               "events": _serialize(events[truncated:])}
    parts, missing = mc.allgather_json_bounded(payload, timeout)
    local_clock = payload["clock_ns"]
    merged = []
    for part in parts:
        if part is None:
            continue
        merged.append((int(part["pid"]), local_clock - int(part["clock_ns"]),
                       _deserialize(part["events"])))
    base = min((e.ts_ns + off for _, off, evs in merged for e in evs), default=0)
    trace_events: list = []
    for pid, offset, evs in merged:
        trace_events.extend(export.chrome_events(evs, pid=pid, clock_offset_ns=offset,
                                                 base_ns=base))
    return export.trace_document(trace_events), missing


__all__ = ["MERGE_MAX_EVENTS", "merge_timelines"]
