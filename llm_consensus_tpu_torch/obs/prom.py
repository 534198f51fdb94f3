"""Prometheus text-format export for the live metrics plane (a copy of
``llm_consensus_tpu/obs/prom.py``: the same family names, label sets and
bucket edges).

``/metricsz`` serves text-format 0.0.4 — histograms as cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``, gauges for the
``/statsz`` snapshot blocks — because every serving fleet already has a
scraper that speaks it, and because the format is trivially *mergeable*:
the fleet router aggregates its replicas by fetching each replica's
``/metricsz``, parsing it back into bucket arrays (:func:`parse_text`),
summing bucket-wise (:func:`merge`), and re-rendering
(:func:`render_parsed`). Fixed shared bucket edges (obs/live.py) make
that sum exact — no re-bucketing, no quantile sketch drift. The
round-trip is canonical (sorted families, sorted labels, edge-ordered
buckets), so ``parse(render(x)) == x`` and the router-equals-merge
property is assertable in tests.

Naming scheme:

  * histograms — ``llmc_<metric>_seconds`` with ``class`` (priority) and
    ``outcome`` labels: ``llmc_ttft_seconds``,
    ``llmc_token_latency_seconds``, ``llmc_queue_wait_seconds``,
    ``llmc_e2e_seconds``, ``llmc_judge_synthesis_seconds``;
  * gauges — the ``/statsz`` blocks flattened one numeric leaf per
    sample as ``llmc_stat{block="kv",key="<preset>.hit_tokens"}`` (block
    names and dotted key paths stay data, so arbitrary preset names
    never produce an illegal metric name), plus first-class
    ``llmc_load_score``, ``llmc_uptime_seconds``,
    ``llmc_obs_dropped_events``, and ``llmc_blackbox_dumps``.
"""

from __future__ import annotations

from typing import Iterable, Optional

from llm_consensus_tpu_torch.obs.live import BUCKET_EDGES, Histogram, LiveMetrics

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PREFIX = "llmc"

# The metric-family manifest: every family any surface may export, with
# its Prometheus type (the JAX package's list, unchanged).
FAMILIES = {
    "llmc_ttft_seconds": "histogram",
    "llmc_token_latency_seconds": "histogram",
    "llmc_queue_wait_seconds": "histogram",
    "llmc_e2e_seconds": "histogram",
    "llmc_judge_synthesis_seconds": "histogram",
    "llmc_route_e2e_seconds": "histogram",
    "llmc_device_time_seconds": "histogram",
    "llmc_host_gap_seconds": "histogram",
    "llmc_device_time_seconds_total": "counter",
    "llmc_tokens_total": "counter",
    "llmc_host_gap_seconds_total": "counter",
    "llmc_compiles_total": "counter",
    "llmc_retraces_total": "counter",
    "llmc_roofline_flops_total": "counter",
    "llmc_roofline_bytes_total": "counter",
    "llmc_roofline_dispatches_total": "counter",
    "llmc_roofline_tokens_total": "counter",
    "llmc_roofline_ridge_flops_per_byte": "gauge",
    "llmc_integrity_checks_total": "counter",
    "llmc_integrity_failures_total": "counter",
    "llmc_swap_vacate_seconds": "histogram",
    "llmc_weight_version": "gauge",
    "llmc_replica_up": "gauge",
    "llmc_replica_scrape_staleness_seconds": "gauge",
    "llmc_build_info": "gauge",
    "llmc_hbm_modeled_bytes": "gauge",
    "llmc_hbm_device_bytes": "gauge",
    "llmc_uptime_seconds": "gauge",
    "llmc_load_score": "gauge",
    "llmc_live_flights": "gauge",
    "llmc_runs_executed": "gauge",
    "llmc_obs_dropped_events": "gauge",
    "llmc_blackbox_dumps": "gauge",
    "llmc_stat": "gauge",
}

def _fmt(v: float) -> str:
    """Canonical sample/edge formatting: integers render bare (bucket
    counts), floats with repr (exact round-trip)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


LE_STRS: tuple = tuple(_fmt(e) for e in BUCKET_EDGES) + ("+Inf",)


def _escape(v: str) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels_str(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def histogram_lines(metric: str, labels: dict, hist: Histogram) -> list:
    """One labeled histogram as its text-format sample lines."""
    name = f"{PREFIX}_{metric}_seconds"
    out = []
    cum = hist.cumulative()
    for le, c in zip(LE_STRS, cum):
        out.append(
            f"{name}_bucket{_labels_str(labels, {'le': le})} {c}"
        )
    out.append(f"{name}_sum{_labels_str(labels)} {_fmt(hist.sum)}")
    out.append(f"{name}_count{_labels_str(labels)} {hist.count}")
    return out


def flatten_numeric(doc, prefix: str = "") -> Iterable:
    """Yield ``(dotted.path, value)`` for every numeric leaf of a nested
    stats dict (bools excluded — they are states, not quantities; a
    scraper alarms on counters)."""
    if isinstance(doc, dict):
        for k in sorted(doc, key=str):
            path = f"{prefix}.{k}" if prefix else str(k)
            yield from flatten_numeric(doc[k], path)
    elif isinstance(doc, (int, float)) and not isinstance(doc, bool):
        yield (prefix, doc)


def render(
    live: Optional[LiveMetrics] = None,
    stats_blocks: Optional[dict] = None,
    gauges: Optional[dict] = None,
    families: Optional[dict] = None,
) -> str:
    """The full ``/metricsz`` body: live histogram families + ``/statsz``
    blocks flattened into ``llmc_stat`` gauges + first-class gauges +
    LABELED counter/gauge families (``families`` maps a bare family name
    to ``{"type": "counter"|"gauge", "samples": [(labels dict, value),
    ...]}`` — the chip-time attribution counters and ``build_info`` ride
    this)."""
    lines: list = []
    hist_families = live.families() if live is not None else {}
    for metric in sorted(hist_families):
        lines.append(f"# TYPE {PREFIX}_{metric}_seconds histogram")
        for labels, hist in sorted(
            hist_families[metric], key=lambda lh: sorted(lh[0].items())
        ):
            lines.extend(histogram_lines(metric, labels, hist))
    if families:
        for fname in sorted(families):
            fam = families[fname]
            samples = fam.get("samples", [])
            if not samples:
                continue
            ftype = fam.get("type", "gauge")
            lines.append(f"# TYPE {PREFIX}_{fname} {ftype}")
            for labels, value in sorted(
                samples, key=lambda s: sorted(s[0].items())
            ):
                if not isinstance(value, (int, float)) or isinstance(
                    value, bool
                ):
                    continue
                lines.append(
                    f"{PREFIX}_{fname}{_labels_str(labels)} {_fmt(value)}"
                )
    if gauges:
        for gname in sorted(gauges):
            value = gauges[gname]
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            lines.append(f"# TYPE {PREFIX}_{gname} gauge")
            lines.append(f"{PREFIX}_{gname} {_fmt(value)}")
    if stats_blocks:
        lines.append(f"# TYPE {PREFIX}_stat gauge")
        for block in sorted(stats_blocks, key=str):
            for path, value in flatten_numeric(stats_blocks[block]):
                labels = {"block": str(block), "key": path}
                lines.append(f"{PREFIX}_stat{_labels_str(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# -- parse / merge (the router's fleet aggregation path) ---------------------


def _parse_labels(raw: str) -> dict:
    """``k="v",k2="v2"`` → dict, inverting :func:`_escape` exactly: the
    three legal text-format escapes (``\\\\``, ``\\"``, ``\\n``) decode;
    any other backslash pair is kept VERBATIM (a foreign exporter's
    nonstandard escape round-trips rather than silently dropping its
    backslash). Raises ``ValueError`` on an unquoted value — parse_text
    skips the line (an ``assert`` would vanish under ``python -O``)."""
    out: dict = {}
    i, n = 0, len(raw)
    while i < n:
        eq = raw.index("=", i)
        key = raw[i:eq].strip().lstrip(",").strip()
        if eq + 1 >= n or raw[eq + 1] != '"':
            raise ValueError(f"unquoted label value in {raw!r}")
        j = eq + 2
        buf = []
        while j < n:
            ch = raw[j]
            if ch == "\\" and j + 1 < n:
                nxt = raw[j + 1]
                if nxt == "n":
                    buf.append("\n")
                elif nxt in ('"', "\\"):
                    buf.append(nxt)
                else:
                    buf.append(ch)
                    buf.append(nxt)
                j += 2
                continue
            if ch == '"':
                break
            buf.append(ch)
            j += 1
        else:
            raise ValueError(f"unterminated label value in {raw!r}")
        out[key] = "".join(buf)
        i = j + 1
    return out


def _split_sample(line: str) -> "tuple[str, dict, float]":
    """One sample line → ``(name, labels, value)``, quote-aware: the
    label block ends at the first ``}`` OUTSIDE a quoted value (a value
    containing ``}`` or ``" "`` must not truncate the block the way a
    bare ``rstrip``/``rsplit`` would), and an optional trailing
    timestamp — legal text format — is ignored instead of being read as
    the sample value."""
    brace = line.find("{")
    if brace >= 0:
        j, n = brace + 1, len(line)
        in_quotes = False
        while j < n:
            ch = line[j]
            if in_quotes:
                if ch == "\\":
                    j += 2
                    continue
                if ch == '"':
                    in_quotes = False
            elif ch == '"':
                in_quotes = True
            elif ch == "}":
                break
            j += 1
        if j >= n:
            raise ValueError(f"unterminated label block in {line!r}")
        name = line[:brace]
        labels = _parse_labels(line[brace + 1:j])
        tail = line[j + 1:]
    else:
        name, _, tail = line.partition(" ")
        labels = {}
    fields = tail.split()
    if not fields:
        raise ValueError(f"sample without value in {line!r}")
    return name, labels, float(fields[0])


def parse_text(text: str) -> dict:
    """Parse a ``/metricsz`` body into a mergeable structure:

    ``{"histograms": {(metric, labels-tuple): {"buckets": {le: n},
    "sum": s, "count": n}}, "gauges": {(name, labels-tuple): v},
    "types": {bare-family-name: declared type}}``.

    ``types`` records each family's ``# TYPE`` declaration so the
    router's re-render (:func:`render_parsed`) keeps counters counters —
    a strict scraper must not see a replica's ``llmc_tokens_total``
    counter come back from the fleet endpoint re-typed as a gauge.

    Only ``llmc_``-prefixed families are read; unknown lines are
    skipped, so a replica running a newer build never breaks the
    router's aggregation.
    """
    hists: dict = {}
    gauges: dict = {}
    types: dict = {}
    suffix = "_seconds"
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            if line.startswith("# TYPE "):
                parts = line[len("# TYPE "):].split()
                if len(parts) == 2 and parts[0].startswith(PREFIX + "_"):
                    types[parts[0][len(PREFIX) + 1:]] = parts[1]
            continue
        try:
            name, labels, value = _split_sample(line)
            if not name.startswith(PREFIX + "_"):
                continue
            base = name[len(PREFIX) + 1:]
            if base.endswith("_bucket") and base[:-7].endswith(suffix):
                metric = base[:-7][: -len(suffix)]
                le = labels.pop("le", "+Inf")
                key = (metric, tuple(sorted(labels.items())))
                h = hists.setdefault(
                    key, {"buckets": {}, "sum": 0.0, "count": 0}
                )
                h["buckets"][le] = h["buckets"].get(le, 0) + value
            elif base.endswith("_sum") and base[:-4].endswith(suffix):
                metric = base[:-4][: -len(suffix)]
                key = (metric, tuple(sorted(labels.items())))
                h = hists.setdefault(
                    key, {"buckets": {}, "sum": 0.0, "count": 0}
                )
                h["sum"] += value
            elif base.endswith("_count") and base[:-6].endswith(suffix):
                metric = base[:-6][: -len(suffix)]
                key = (metric, tuple(sorted(labels.items())))
                h = hists.setdefault(
                    key, {"buckets": {}, "sum": 0.0, "count": 0}
                )
                h["count"] += value
            else:
                gauges[(base, tuple(sorted(labels.items())))] = (
                    gauges.get((base, tuple(sorted(labels.items()))), 0.0)
                    + value
                )
        except (ValueError, AssertionError, IndexError):
            continue  # unknown/malformed line: skip, never fail the scrape
    return {"histograms": hists, "gauges": gauges, "types": types}


def merge(parsed_docs: list) -> dict:
    """Bucket-wise merge of parsed ``/metricsz`` documents: histogram
    bucket counts / sums / counts add per (metric, labels, le); gauges
    add per (name, labels) — the fleet view is the sum of its replicas
    (rates and occupancies are per-replica truths; operators read them
    per replica, the fleet totals are for counters)."""
    out = {"histograms": {}, "gauges": {}, "types": {}}
    for doc in parsed_docs:
        out["types"].update(doc.get("types", {}))
        for key, h in doc.get("histograms", {}).items():
            dst = out["histograms"].setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0}
            )
            for le, n in h["buckets"].items():
                dst["buckets"][le] = dst["buckets"].get(le, 0) + n
            dst["sum"] += h["sum"]
            dst["count"] += h["count"]
        for key, v in doc.get("gauges", {}).items():
            out["gauges"][key] = out["gauges"].get(key, 0.0) + v
    return out


def _le_sort_key(le: str):
    return float("inf") if le == "+Inf" else float(le)


def render_parsed(doc: dict) -> str:
    """Render a parsed/merged document back to canonical text — the
    router's ``/metricsz`` body. Families render contiguously with ONE
    ``# TYPE`` line each (strict text-format parsers reject a family
    split around metadata)."""
    lines: list = []
    hists = doc.get("histograms", {})
    by_metric: dict = {}
    for (metric, labels), h in hists.items():
        by_metric.setdefault(metric, []).append((dict(labels), h))
    for metric in sorted(by_metric):
        name = f"{PREFIX}_{metric}_seconds"
        lines.append(f"# TYPE {name} histogram")
        for labels, h in sorted(
            by_metric[metric], key=lambda lh: sorted(lh[0].items())
        ):
            for le in sorted(h["buckets"], key=_le_sort_key):
                lines.append(
                    f"{name}_bucket{_labels_str(labels, {'le': le})} "
                    f"{_fmt(h['buckets'][le])}"
                )
            lines.append(f"{name}_sum{_labels_str(labels)} {_fmt(h['sum'])}")
            lines.append(
                f"{name}_count{_labels_str(labels)} {_fmt(h['count'])}"
            )
    gauges = doc.get("gauges", {})
    types = doc.get("types", {})
    prev_family = None
    for (gname, labels) in sorted(gauges, key=lambda k: (k[0], k[1])):
        if gname != prev_family:
            prev_family = gname
            # Keep the replica's declared type (counters stay counters
            # through the fleet merge); unknown families default gauge.
            lines.append(
                f"# TYPE {PREFIX}_{gname} {types.get(gname, 'gauge')}"
            )
        lines.append(
            f"{PREFIX}_{gname}{_labels_str(dict(labels))} "
            f"{_fmt(gauges[(gname, labels)])}"
        )
    return "\n".join(lines) + "\n"


__all__ = [
    "CONTENT_TYPE", "LE_STRS", "PREFIX", "flatten_numeric",
    "histogram_lines", "merge", "parse_text", "render", "render_parsed",
]
