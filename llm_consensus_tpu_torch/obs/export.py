"""Export a run's telemetry: Chrome trace-event JSON + metrics.json (a copy
of ``llm_consensus_tpu/obs/export.py`` for one process).

Two artifacts per run, written into ``data/<run-id>/`` beside
``result.json``:

  * ``trace.json`` (under ``--events``): Chrome trace-event format
    (``{"traceEvents": [...]}``), loadable in Perfetto or
    ``chrome://tracing``. ``tid`` is the subsystem row ("engine",
    "batcher", "runner"); timestamps are microseconds on the recorder's
    monotonic clock, rebased so the earliest event sits at 0. The roofline
    ledger's cumulative FLOPs and bytes per family ride along as "C"
    (counter) events.
  * ``metrics.json``: the run's aggregates: recorder counters and event
    counts, batcher phase accounting, per-model token and rate stats, and
    the live, attribution and roofline snapshots.

"X" events carry ``dur``, "i" instants scope ``s`` ("t": thread), "M"
metadata names the process and the threads.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from llm_consensus_tpu_torch.obs.recorder import Event, Recorder

TRACE_FILE = "trace.json"
METRICS_FILE = "metrics.json"


def _tid_table(events: Iterable[Event]) -> dict[str, int]:
    """Stable subsystem label → integer tid (sorted names, not first-seen
    order, which varies with thread interleavings)."""
    return {name: i + 1 for i, name in enumerate(sorted({e.tid for e in events}))}


def chrome_events(events: list[Event], pid: int = 0, process_name: Optional[str] = None,
                  clock_offset_ns: int = 0, base_ns: Optional[int] = None) -> list[dict]:
    """One process's events as trace-event dicts (metadata included);
    ``base_ns`` is the timeline's zero (default: the earliest event)."""
    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name or f"controller {pid}"},
    }]
    tids = _tid_table(events)
    for label, tid in tids.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": label}})
    if base_ns is None:
        base_ns = min((e.ts_ns for e in events), default=0) + clock_offset_ns
    for e in events:
        d: dict = {"name": e.name, "ph": e.ph, "ts": (e.ts_ns + clock_offset_ns - base_ns) / 1e3,
                   "pid": pid, "tid": tids[e.tid]}
        if e.ph == "X":
            d["dur"] = e.dur_ns / 1e3
        elif e.ph == "i":
            d["s"] = "t"
        if e.args:
            d["args"] = dict(e.args)
        out.append(d)
    return out


def trace_document(trace_events: list[dict]) -> dict:
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def roofline_counter_events(pid: int = 0, ts_us: float = 0.0) -> list[dict]:
    """The roofline ledger's cumulative FLOPs/bytes per family as "C"
    events (a counter track beside the spans); empty when the plane is
    off."""
    from llm_consensus_tpu_torch.obs import roofline

    led = roofline.ledger()
    if led is None:
        return []
    return [{"name": name, "ph": "C", "ts": ts_us, "pid": pid, "tid": 0,
             "args": {"value": value}} for name, value in led.counter_track()]


def local_trace(recorder: Recorder, pid: int = 0) -> dict:
    """This process's timeline as a trace document, with the roofline
    counter tracks when that plane is on."""
    events = chrome_events(recorder.events(), pid=pid)
    end_us = max((e.get("ts", 0.0) + e.get("dur", 0.0) for e in events if e.get("ph") != "M"),
                 default=0.0)
    events.extend(roofline_counter_events(pid=pid, ts_us=end_us))
    return trace_document(events)


def aggregate_throughput(recorder: Recorder,
                         events: Optional[list[Event]] = None) -> Optional[dict]:
    """Pool-wide decode throughput, or None when nothing was measured:
    tokens over the UNION of the run's decode activity window (first decode
    dispatch to last fetch end), not the sum of per-stream walls, which
    would count concurrently decoding streams twice. Without decode/fetch
    spans, the summed walls. MFU is the token-weighted mean over the tokens
    that reported one."""
    counters = recorder.counters()
    tokens = counters.get("decode_tokens", 0.0)
    if not tokens:
        return None
    if events is None:
        events = recorder.events()
    spans = [e for e in events if e.ph == "X" and e.name in ("decode", "fetch")]
    if spans:
        window_s = (max(e.ts_ns + e.dur_ns for e in spans) - min(e.ts_ns for e in spans)) / 1e9
    else:
        window_s = counters.get("decode_s", 0.0)
    if window_s <= 0:
        return None
    out = {"tokens": tokens, "tokens_per_sec": tokens / window_s, "window_s": window_s}
    weighted = counters.get("mfu_weighted_tokens", 0.0)
    mfu_tokens = counters.get("mfu_tokens", 0.0)
    if weighted and mfu_tokens:
        out["mfu"] = weighted / mfu_tokens
    return out


def _collect_provider_stats(registry, attr: str) -> dict:
    """Per-preset stats merged from every distinct provider of the
    registry, read through the provider method ``attr`` (providers without
    it contribute nothing)."""
    out: dict = {}
    seen: set = set()
    for model in registry.models():
        provider = registry.get(model)
        if id(provider) in seen:
            continue
        seen.add(id(provider))
        stats_fn = getattr(provider, attr, None)
        if stats_fn is not None:
            out.update(stats_fn())
    return out


def collect_batcher_stats(registry) -> dict:
    """Batcher phase-accounting snapshots, keyed by preset."""
    return _collect_provider_stats(registry, "batcher_stats")


def collect_kv_stats(registry) -> dict:
    """Paged-KV-pool snapshots (``KVPool.stats``), keyed by preset: empty
    when no engine runs with the pool."""
    return _collect_provider_stats(registry, "kv_stats")


def collect_spec_stats(registry) -> dict:
    """Speculative-decoding snapshots (``GPUProvider.spec_stats``: rounds,
    acceptance, governor state), keyed by preset: empty when nothing is
    drafted."""
    return _collect_provider_stats(registry, "spec_stats")


def collect_disagg_stats(registry) -> dict:
    """Disaggregated-serving snapshots (``GPUProvider.disagg_stats``, per
    preset); empty when no provider hands off."""
    return _collect_provider_stats(registry, "disagg_stats")


def live_summary(live=None) -> Optional[dict]:
    """Final quantiles of every live histogram as a JSON block: per
    (family, labels) count / sum / p50 / p90 / p99; cumulative over the
    process. None when the plane is off or empty."""
    if live is None:
        from llm_consensus_tpu_torch.obs import live as live_mod

        live = live_mod.metrics()
    if live is None:
        return None
    out: dict = {}
    for name, entries in sorted(live.families().items()):
        rows = []
        for labels, hist in sorted(entries, key=lambda lh: sorted(lh[0].items())):
            if not hist.count:
                continue
            rows.append({
                "labels": dict(labels), "count": hist.count, "sum_s": round(hist.sum, 6),
                "p50_s": round(hist.quantile(0.5), 6), "p90_s": round(hist.quantile(0.9), 6),
                "p99_s": round(hist.quantile(0.99), 6),
            })
        if rows:
            out[name] = rows
    return out or None


def attrib_summary() -> Optional[dict]:
    """The attribution ledger's snapshot, or None when it is off."""
    from llm_consensus_tpu_torch.obs import attrib

    led = attrib.ledger()
    return led.snapshot() if led is not None else None


def roofline_summary() -> Optional[dict]:
    """The roofline ledger's snapshot, or None when it is off or nothing
    dispatched."""
    from llm_consensus_tpu_torch.obs import roofline

    led = roofline.ledger()
    if led is None or led.activity() == 0:
        return None
    return led.snapshot()


def metrics_summary(recorder: Optional[Recorder] = None, responses=None,
                    batcher_stats: Optional[dict] = None, kv_stats: Optional[dict] = None,
                    spec_stats: Optional[dict] = None, disagg_stats: Optional[dict] = None,
                    fault_trace: Optional[list[str]] = None,
                    failed_models: Optional[list[str]] = None,
                    warnings: Optional[list[str]] = None, live: Optional[dict] = None,
                    attrib: Optional[dict] = None, roofline: Optional[dict] = None,
                    degraded_peers=None) -> dict:
    """The run's aggregates as one JSON-serializable dict (the JAX
    document's keys, in its order); ``fault_trace`` is the fault plan's
    decision lines (``faults``)."""
    out: dict = {}
    if recorder is not None:
        events = recorder.events()
        out["counters"] = recorder.counters()
        out["events"] = {"recorded": len(events), "dropped": recorder.dropped}
        agg = aggregate_throughput(recorder, events=events)
        if agg is not None:
            out["aggregate"] = agg
    if batcher_stats:
        out["batchers"] = batcher_stats
    if kv_stats:
        out["kv"] = kv_stats
    if spec_stats:
        out["spec"] = spec_stats
    if disagg_stats:
        out["disagg"] = disagg_stats
    if responses:
        out["models"] = [
            {k: v for k, v in (
                ("model", r.model), ("tokens", r.tokens), ("tokens_per_sec", r.tokens_per_sec),
                ("mfu", r.mfu), ("mbu", r.mbu), ("latency_ms", r.latency_ms),
            ) if v is not None}
            for r in responses
        ]
    if live:
        out["live"] = live
    if attrib:
        out["attrib"] = attrib
    if roofline:
        out["roofline"] = roofline
    if fault_trace:
        out["faults"] = list(fault_trace)
    if degraded_peers:
        # Controllers that missed a collective deadline this run.
        out["degraded_peers"] = sorted(int(p) for p in degraded_peers)
    if failed_models:
        out["failed_models"] = list(failed_models)
    if warnings:
        out["warnings"] = list(warnings)
    return out


def save_run_telemetry(run_dir: str, trace: Optional[dict], metrics: dict,
                       warn=None) -> list[str]:
    """Write ``trace.json`` (when given) and ``metrics.json`` into
    ``run_dir``; a failed write is reported through ``warn``, never
    raised, like the run's other aux files."""
    from llm_consensus_tpu_torch.output.persist import save_file

    written = []
    for name, doc in ((TRACE_FILE, trace), (METRICS_FILE, metrics)):
        if doc is None:
            continue
        path = save_file(run_dir, name, json.dumps(doc, indent=2) + "\n", warn=warn)
        if path:
            written.append(path)
    return written


def load_trace(path: str) -> dict:
    """A persisted ``trace.json`` parsed; ``ValueError`` when the file is
    not a trace document (no ``traceEvents`` list)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError(f"{os.path.basename(path)} is not a trace document")
    return doc


def trace_span_names(doc: dict) -> set[str]:
    return {e["name"] for e in doc["traceEvents"] if isinstance(e, dict) and e.get("ph") == "X"}
