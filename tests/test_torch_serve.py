"""The port's serving gateway (llm_consensus_tpu_torch/serve/) against the
JAX package's, over real HTTP with the same deterministic fake provider.

Every case of tests/test_serve.py runs through BOTH gateways: one fake
class is written against each package's ``Provider`` base, the traffic is
the same, and the test compares what a client and the run directories see
(status codes, response JSON less run ids, trace ids and timings,
``Retry-After`` bounds, SSE event sequences, run-directory listings) after
holding each gateway to the JAX test's own assertions. The gateway cases
of tests/test_pressure.py (brownout, shed, bad priority) and
tests/test_live_obs.py (the ``/metricsz`` families and label sets, the
trace header, the Prometheus round trip, the SLO watcher, the governor's
flight-recorder dump, the stats registry) follow the same pattern.

Every HTTP call has a client timeout, every join a timeout, and every
gateway closes in a ``finally``.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

import llm_consensus_tpu.faults as jax_faults
import llm_consensus_tpu.integrity as jax_integrity
import llm_consensus_tpu.obs as jax_obs
import llm_consensus_tpu.serve as jax_serve
from llm_consensus_tpu.obs import attrib as jax_attrib
from llm_consensus_tpu.obs import blackbox as jax_blackbox
from llm_consensus_tpu.obs import live as jax_live
from llm_consensus_tpu.obs import profiler as jax_profiler
from llm_consensus_tpu.obs import prom as jax_prom
from llm_consensus_tpu.obs import roofline as jax_roofline
from llm_consensus_tpu.pressure import PressureGovernor as JaxGovernor
from llm_consensus_tpu.providers.base import Provider as JaxProvider
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu.providers.registry import Registry as JaxRegistry
from llm_consensus_tpu.serve.admission import AdmissionController as JaxAdmission
from llm_consensus_tpu.serve.stats import StatsRegistry as JaxStatsRegistry
from llm_consensus_tpu_torch import faults, integrity, obs, serve
from llm_consensus_tpu_torch.obs import attrib, blackbox, live, profiler, prom, roofline
from llm_consensus_tpu_torch.pressure import PressureGovernor
from llm_consensus_tpu_torch.providers import Provider, Registry, Response
from llm_consensus_tpu_torch.serve.admission import AdmissionController
from llm_consensus_tpu_torch.serve.stats import StatsRegistry

PANEL = ["alpha", "beta"]
JUDGE = "gamma"
WAIT = 30.0

JAX = SimpleNamespace(
    name="jax", serve=jax_serve, obs=jax_obs, faults=jax_faults, integrity=jax_integrity,
    live=jax_live, blackbox=jax_blackbox, attrib=jax_attrib, roofline=jax_roofline,
    profiler=jax_profiler, prom=jax_prom, Provider=JaxProvider, Response=JaxResponse,
    Registry=JaxRegistry, Admission=JaxAdmission, Governor=JaxGovernor,
    StatsRegistry=JaxStatsRegistry)
TORCH = SimpleNamespace(
    name="torch", serve=serve, obs=obs, faults=faults, integrity=integrity, live=live,
    blackbox=blackbox, attrib=attrib, roofline=roofline, profiler=profiler, prom=prom,
    Provider=Provider, Response=Response, Registry=Registry, Admission=AdmissionController,
    Governor=PressureGovernor, StatsRegistry=StatsRegistry)
PKGS = (JAX, TORCH)


def _quiet_planes():
    """Both packages with no recorder, fault plan, integrity plane or
    telemetry plane: the JAX planes otherwise resolve from the environment
    (live, attribution, flight recorder on by default) and the port's only
    from what is installed, so each test installs what it compares."""
    for P in PKGS:
        P.obs.reset()
        P.faults.reset()
        P.integrity.reset()
        for plane in (P.live, P.blackbox, P.attrib, P.roofline, P.profiler):
            plane.install(None)


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    for knob in ("LLMC_FAULTS", "LLMC_INTEGRITY", "LLMC_EVENTS"):
        monkeypatch.delenv(knob, raising=False)
    _quiet_planes()
    yield
    _quiet_planes()
    for P in PKGS:
        for plane in (P.live, P.blackbox, P.attrib, P.roofline, P.profiler):
            plane.reset()


def fake_provider(P, gate=None):
    """The counting fake of tests/test_serve.py on package ``P``'s base."""

    class FakeProvider(P.Provider):
        def __init__(self):
            self._lock = threading.Lock()
            self.calls: list = []  # (model, prompt, max_tokens)

        def query(self, ctx, req):
            with self._lock:
                self.calls.append((req.model, req.prompt, req.max_tokens))
            if gate is not None and req.model in PANEL:
                assert gate.wait(WAIT), "test gate never released"
            ctx.raise_if_done()
            return P.Response(model=req.model, content=f"{req.model} says: {req.prompt[:24]}",
                              provider="fake")

        def query_stream(self, ctx, req, callback):
            resp = self.query(ctx, req)
            if callback is not None:
                callback(resp.content)
            return resp

        def panel_calls(self):
            with self._lock:
                return [c[:2] for c in self.calls if c[0] in PANEL]

    return FakeProvider()


def make_gateway(P, tmp_path, provider, models=PANEL + [JUDGE], panel=PANEL, judge=JUDGE, **kw):
    registry = P.Registry()
    for m in models:
        registry.register(m, provider)
    kw.setdefault("timeout", 30.0)
    kw.setdefault("max_concurrency", 4)
    gw = P.serve.build_gateway(registry, list(panel), judge,
                               data_dir=os.path.join(str(tmp_path), P.name, "data"), **kw)
    gw.start()
    return gw


def data_dir(P, tmp_path) -> str:
    return os.path.join(str(tmp_path), P.name, "data")


def post(port, body, path="/v1/consensus", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", path, json.dumps(body), hdrs)
        r = conn.getresponse()
        out = r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()
    return out


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        out = r.status, r.getheader("Content-Type", ""), r.read()
    finally:
        conn.close()
    return out


def get_json(port, path):
    status, _ctype, data = get(port, path)
    return status, json.loads(data)


def wait_for(predicate, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def start(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


def join(threads):
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive(), "request thread hung"


_VOLATILE = ("run_id", "trace_id", "latency_ms")


def norm(doc):
    """A response document less what differs between any two runs: ids,
    timings, and the order of panel answers that landed together (the
    runner keeps landing order)."""
    if isinstance(doc, dict):
        out = {k: norm(v) for k, v in doc.items() if k not in _VOLATILE}
        if isinstance(out.get("responses"), list):
            out["responses"] = sorted(out["responses"],
                                      key=lambda r: json.dumps(r, sort_keys=True))
        return out
    if isinstance(doc, list):
        return [norm(v) for v in doc]
    return doc


def run_dir_view(P, tmp_path, run_id):
    """A run directory's listing and its result.json, normalized."""
    d = os.path.join(data_dir(P, tmp_path), run_id)
    with open(os.path.join(d, "result.json")) as f:
        result = norm(json.load(f))
    return sorted(os.listdir(d)), result


def parse_sse(data: bytes) -> list:
    events = []
    for frame in data.decode("utf-8").split("\n\n"):
        if not frame.strip():
            continue
        name, doc = None, None
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                doc = json.loads(line[len("data: "):])
        events.append((name, doc))
    return events


def both(scenario, tmp_path):
    """Run ``scenario`` through the JAX gateway, then the port's, and hold
    the port's observations equal to the JAX ones."""
    out = {}
    for P in PKGS:
        _quiet_planes()
        out[P.name] = scenario(P, tmp_path)
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------------------------
# tests/test_serve.py, case by case


def test_json_consensus_roundtrip(tmp_path):
    def scenario(P, tmp):
        provider = fake_provider(P)
        gw = make_gateway(P, tmp, provider)
        try:
            status, _, data = post(gw.address[1], {"prompt": "what is up?"})
            assert status == 200, data
            doc = json.loads(data)
            assert doc["consensus"] and doc["judge"] == JUDGE
            assert [r["model"] for r in doc["responses"]] == PANEL
            assert doc["cached"] is False and doc["coalesced"] is False
            listing, saved = run_dir_view(P, tmp, doc["run_id"])
            assert saved["consensus"] == doc["consensus"]
            assert len(provider.calls) == 3
            return norm(doc), listing, saved
        finally:
            gw.close(timeout=5.0)

    listing = both(scenario, tmp_path)[1]
    assert listing == ["consensus.md", "prompt.txt", "result.json", "run.json"]


def test_healthz_and_statsz(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            health = get_json(port, "/healthz")
            assert health == (200, {"status": "ok", "draining": False,
                                    "lifecycle": "serving", "placeable": True})
            status, doc = get_json(port, "/statsz")
            assert status == 200
            assert doc["admission"]["max_concurrency"] == 4
            assert doc["cache"]["capacity"] == 256
            assert doc["runs_executed"] == 0
            return health, sorted(doc), doc["admission"], doc["cache"], sorted(doc["elastic"])
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_bad_requests(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            out = []
            for body, path in (({"prompt": ""}, "/v1/consensus"),
                               ({"prompt": "x", "models": ["nope"]}, "/v1/consensus"),
                               ({"prompt": "x", "timeout": -1}, "/v1/consensus"),
                               ({"prompt": "x", "max_tokens": 0}, "/v1/consensus"),
                               ({"prompt": "x", "stream": "yes"}, "/v1/consensus"),
                               ({"prompt": "x"}, "/v2/nope")):
                status, _, data = post(port, body, path=path)
                out.append((status, json.loads(data)))
            assert [s for s, _ in out] == [400, 400, 400, 400, 400, 404]
            assert "prompt" in out[0][1]["error"] and "unknown model" in out[1][1]["error"]
            return out
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_concurrent_load_distinct_prompts(tmp_path):
    def scenario(P, tmp):
        provider = fake_provider(P)
        gw = make_gateway(P, tmp, provider, max_concurrency=3, max_queue=16)
        try:
            port = gw.address[1]
            n = 6
            results = [None] * n
            join([start(lambda i=i: results.__setitem__(
                i, post(port, {"prompt": f"question #{i}"}))) for i in range(n)])
            docs = []
            for status, _, data in results:
                assert status == 200, data
                docs.append(json.loads(data))
            assert len({d["run_id"] for d in docs}) == n
            assert gw.scheduler.runs_executed == n
            assert len(provider.panel_calls()) == n * len(PANEL)
            return [norm(d) for d in docs], sorted(provider.panel_calls())
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_duplicate_burst_coalesces_to_one_run(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        provider = fake_provider(P, gate)
        gw = make_gateway(P, tmp, provider)
        try:
            port = gw.address[1]
            m = 4
            results = [None] * m
            threads = [start(lambda i=i: results.__setitem__(
                i, post(port, {"prompt": "identical question"}))) for i in range(m)]
            wait_for(lambda: gw._flights.followers() == m - 1, what="followers to join")
            gate.set()
            join(threads)
            assert all(status == 200 for status, _, _ in results)
            docs = [json.loads(data) for _, _, data in results]
            assert gw.scheduler.runs_executed == 1
            assert len(provider.panel_calls()) == len(PANEL)
            assert len({d["consensus"] for d in docs}) == 1
            run_ids = {d["run_id"] for d in docs}
            assert len(run_ids) == m
            views = sorted(json.dumps(run_dir_view(P, tmp, rid), sort_keys=True)
                           for rid in run_ids)
            assert sum(1 for d in docs if d["coalesced"]) == m - 1
            return sorted(json.dumps(norm(d), sort_keys=True) for d in docs), views
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_cache_hit_and_ttl_expiry(tmp_path):
    def scenario(P, tmp):
        clock = [0.0]
        gw = make_gateway(P, tmp, fake_provider(P), cache_ttl_s=10.0, clock=lambda: clock[0])
        try:
            port = gw.address[1]
            body = {"prompt": "cache me"}
            seen = []
            first = json.loads(post(port, body)[2])
            hit = json.loads(post(port, body)[2])
            assert hit["cached"] is True and hit["run_id"] != first["run_id"]
            assert gw.scheduler.runs_executed == 1
            other = json.loads(post(port, dict(body, max_tokens=7))[2])
            assert other["cached"] is False and gw.scheduler.runs_executed == 2
            clock[0] = 11.0
            expired = json.loads(post(port, body)[2])
            assert expired["cached"] is False and gw.scheduler.runs_executed == 3
            assert gw.cache.stats()["expirations"] == 1
            seen = [norm(d) for d in (first, hit, other, expired)]
            return seen, gw.cache.stats(), run_dir_view(P, tmp, hit["run_id"])
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_queue_full_backpressure(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate), max_concurrency=1, max_queue=0)
        try:
            port = gw.address[1]
            leader = [None]
            t = start(lambda: leader.__setitem__(0, post(port, {"prompt": "slow one"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="leader slot")
            status, headers, data = post(port, {"prompt": "overflow"})
            assert status == 429, data
            assert float(headers["Retry-After"]) >= 1
            body = json.loads(data)
            assert 1.0 <= body["retry_after_s"] < 2.0
            gate.set()
            join([t])
            assert leader[0][0] == 200
            assert gw.admission.snapshot()["rejected"] == 1
            return status, headers["Retry-After"], body["error"], gw.admission.snapshot()
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_graceful_drain_ordering(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate), max_concurrency=2)
        port = gw.address[1]
        try:
            inflight = [None]
            t = start(lambda: inflight.__setitem__(
                0, post(port, {"prompt": "riding out the drain"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="in flight")
            gw.admission.begin_drain()
            status, headers, data = post(port, {"prompt": "too late"})
            assert status == 503 and "Retry-After" in headers, data
            health = get_json(port, "/healthz")
            assert health[0] == 503 and health[1]["draining"] is True
            threading.Timer(0.1, gate.set).start()
            assert gw.close(drain=True, timeout=10.0) is True
            join([t])
            status2, _, data2 = inflight[0]
            assert status2 == 200
            doc = json.loads(data2)
            view = run_dir_view(P, tmp, doc["run_id"])
            with pytest.raises(OSError):
                post(port, {"prompt": "anyone home?"})
            return status, json.loads(data)["error"], health, norm(doc), view
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_follower_of_shed_leader_gets_retryable_status(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate), max_concurrency=1, max_queue=1)
        try:
            port = gw.address[1]
            blocker = [None]
            t0 = start(lambda: blocker.__setitem__(0, post(port, {"prompt": "slot holder"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="slot holder")
            dupes = [None, None]
            threads = [start(lambda i=i: dupes.__setitem__(
                i, post(port, {"prompt": "duplicate pair"}))) for i in range(2)]
            wait_for(lambda: gw.admission.snapshot()["waiting"] == 1
                     and gw._flights.followers() == 1, what="leader queued + follower")
            gw.admission.begin_drain()
            join(threads)
            for status, headers, data in dupes:
                assert status == 503, (status, data)
                assert "Retry-After" in headers
            gate.set()
            join([t0])
            assert blocker[0][0] == 200
            return sorted(status for status, _, _ in dupes), blocker[0][0]
        finally:
            gate.set()
            gw.close(timeout=10.0)

    both(scenario, tmp_path)


def test_sse_stream_mirrors_run(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            status, headers, data = post(gw.address[1], {"prompt": "stream it", "stream": True})
            assert status == 200 and headers["Content-Type"] == "text/event-stream"
            events = parse_sse(data)
            chunks = [d for n, d in events if n == "chunk"]
            assert {c["model"] for c in chunks if c["kind"] == "model_chunk"} == set(PANEL)
            assert [c["model"] for c in chunks if c["kind"] == "judge_chunk"] == [JUDGE]
            done = [d for n, d in events if n == "done"]
            assert len(done) == 1 and done[0]["consensus"] and done[0]["run_id"]
            # Panel chunks arrive in worker order; compare them as a set.
            panel = sorted(json.dumps(c, sort_keys=True) for c in chunks
                           if c["kind"] == "model_chunk")
            judge = [c for c in chunks if c["kind"] == "judge_chunk"]
            return [n for n, _ in events if n != "chunk"], panel, judge, norm(done[0])
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_sse_cached_replay(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            post(port, {"prompt": "replay me"})
            status, _, data = post(port, {"prompt": "replay me", "stream": True})
            assert status == 200
            events = parse_sse(data)
            done = [d for n, d in events if n == "done"]
            assert done[0]["cached"] is True
            chunks = [d for n, d in events if n == "chunk"]
            assert {c["model"] for c in chunks if c["kind"] == "model_chunk"} == set(PANEL)
            assert gw.scheduler.runs_executed == 1
            return [(n, norm(d)) for n, d in events]
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_served_run_records_serve_spans(tmp_path):
    def scenario(P, tmp):
        recorder = P.obs.Recorder()
        P.obs.install(recorder)
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            post(port, {"prompt": "observe me"})
            hit = json.loads(post(port, {"prompt": "observe me"})[2])
            assert hit["cached"] is True
            run2 = json.loads(post(port, {"prompt": "something else"})[2])["run_id"]
            hit_dir = os.path.join(data_dir(P, tmp), hit["run_id"])
            assert os.path.exists(os.path.join(hit_dir, "result.json"))
            assert not os.path.exists(os.path.join(hit_dir, "trace.json"))
            with open(os.path.join(data_dir(P, tmp), run2, "trace.json")) as f:
                doc = json.load(f)
            spans = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
            instants = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"}
            assert {"queue_wait", "admit", "consensus_run"} <= spans, spans
            assert "cache_hit" in instants, instants
            with open(os.path.join(data_dir(P, tmp), run2, "metrics.json")) as f:
                counters = json.load(f)["counters"]
            assert counters["serve.cache_hit"] == 1
            assert counters["serve.admitted"] == 2 and counters["serve.runs"] == 2
            serve_spans = {s for s in spans if s in ("queue_wait", "admit", "consensus_run")}
            return (serve_spans, instants, sorted(os.listdir(hit_dir)),
                    {k: v for k, v in counters.items() if k.startswith("serve.")})
        finally:
            gw.close(timeout=5.0)
            P.obs.reset()

    both(scenario, tmp_path)


def test_coalesced_instant_recorded(tmp_path):
    def scenario(P, tmp):
        recorder = P.obs.Recorder()
        P.obs.install(recorder)
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate))
        try:
            port = gw.address[1]
            results = [None, None]
            threads = [start(lambda i=i: results.__setitem__(
                i, post(port, {"prompt": "twins"}))) for i in range(2)]
            wait_for(lambda: gw._flights.followers() == 1, what="the follower")
            gate.set()
            join(threads)
            assert all(r[0] == 200 for r in results)
            assert recorder.counters()["serve.coalesced"] == 1
            names = {e.name for e in recorder.events() if e.ph == "i"}
            assert "coalesced" in names
            return recorder.counters()["serve.coalesced"], sorted(r[0] for r in results)
        finally:
            gate.set()
            gw.close(timeout=5.0)
            P.obs.reset()

    both(scenario, tmp_path)


def test_injected_queue_full_rejects(tmp_path):
    def scenario(P, tmp):
        P.faults.install(P.faults.FaultPlan("queue_full", seed=3))
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            status, headers, data = post(port, {"prompt": "shed me"})
            assert status == 429 and "Retry-After" in headers, data
            status2, _, data2 = post(port, {"prompt": "shed me"})
            assert status2 == 200, data2
            return status, json.loads(data)["error"], status2, norm(json.loads(data2))
        finally:
            gw.close(timeout=5.0)
            P.faults.reset()

    both(scenario, tmp_path)


def test_injected_slow_admit_delays_grant(tmp_path):
    def scenario(P, tmp):
        P.faults.install(P.faults.FaultPlan("slow_admit@s=0.2", seed=3))
        try:
            admission = P.Admission(max_concurrency=1)
            t0 = time.monotonic()
            ticket = admission.admit()
            elapsed = time.monotonic() - t0
            ticket.release()
            assert elapsed >= 0.2
            return admission.snapshot()
        finally:
            P.faults.reset()

    both(scenario, tmp_path)


def test_injected_disconnect_stops_stream_not_run(tmp_path):
    def scenario(P, tmp):
        P.faults.install(P.faults.FaultPlan("disconnect@phase=stream", seed=3))
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            status, _, data = post(port, {"prompt": "vanishing client", "stream": True})
            assert status == 200
            events = parse_sse(data)
            assert not [d for n, d in events if n == "done"]
            assert gw.scheduler.runs_executed == 1
            status2, _, data2 = post(port, {"prompt": "vanishing client"})
            assert status2 == 200 and json.loads(data2)["cached"] is True
            return [n for n, _ in events], norm(json.loads(data2))
        finally:
            gw.close(timeout=5.0)
            P.faults.reset()

    both(scenario, tmp_path)


def test_runner_per_run_callbacks_do_not_cross_talk():
    """The scheduler's contract: concurrent runs never share callback
    state (the port's scheduler builds one Runner a run with its own
    callbacks; the JAX one passes them per ``run()`` call)."""
    from llm_consensus_tpu_torch.providers import ProviderFunc
    from llm_consensus_tpu_torch.runner import Callbacks, Runner
    from llm_consensus_tpu_torch.utils.context import Context

    registry = Registry()
    registry.register("m", ProviderFunc(lambda ctx, req: Response(
        model=req.model, content=req.prompt, provider="fake")))
    seen: dict = {"a": [], "b": []}
    barrier = threading.Barrier(2, timeout=10.0)

    def go(tag):
        barrier.wait()
        runner = Runner(registry, timeout=10.0).with_callbacks(
            Callbacks(on_model_stream=lambda m, c, _tag=tag: seen[_tag].append(c)))
        runner.run(Context.background(), ["m"], f"prompt-{tag}")

    join([start(go, t) for t in ("a", "b")])
    assert seen == {"a": ["prompt-a"], "b": ["prompt-b"]}


def test_retry_after_jitter_bounds_and_spread(tmp_path):
    def scenario(P, tmp):
        ctl = P.Admission(1, retry_after_s=2.0)
        draws = [ctl.retry_after() for _ in range(64)]
        assert all(2.0 <= d < 4.0 for d in draws), draws
        assert len({round(d, 6) for d in draws}) > 8
        # The class spread: LOW waits longer than HIGH, both jittered.
        low = [ctl.retry_after(2) for _ in range(32)]
        high = [ctl.retry_after(0) for _ in range(32)]
        return (min(low) >= 3.0, max(low) < 6.0, min(high) >= 1.0, max(high) < 2.0)

    assert both(scenario, tmp_path) == (True, True, True, True)


def test_shed_responses_carry_jittered_retry_after(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate), max_concurrency=1, max_queue=0)
        try:
            port = gw.address[1]
            leader = [None]
            t = start(lambda: leader.__setitem__(0, post(port, {"prompt": "jitter leader"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="leader slot")
            bodies = [json.loads(post(port, {"prompt": f"overflow {i}"})[2]) for i in range(8)]
            assert all(1.0 <= b["retry_after_s"] < 2.0 for b in bodies), bodies
            assert len({b["retry_after_s"] for b in bodies}) > 1
            gate.set()
            join([t])
            assert leader[0][0] == 200
            return [sorted(b) for b in bodies], leader[0][0]
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def recovery_provider(P):
    provider = fake_provider(P)
    provider.recovery_stats = lambda: {
        "state": "recovering", "restarts": 2, "replayed_streams": 3, "journal_depth": 1,
        "heartbeats": {"tiny-llama": {"age_s": 0.5, "busy": True}},
        "decode_heartbeat_age_s": 0.5,
    }
    return provider


def test_healthz_and_statsz_report_recovery(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, recovery_provider(P))
        try:
            port = gw.address[1]
            status, health = get_json(port, "/healthz")
            assert status == 200 and health["status"] == "recovering"
            assert health["engines"]["heartbeats"]["tiny-llama"]["busy"] is True
            _, stats = get_json(port, "/statsz")
            assert stats["recovery"] == {"state": "recovering", "restarts": 2,
                                         "replayed_streams": 3, "journal_depth": 1}
            return status, health, stats["recovery"]
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_healthz_shape_unchanged_without_recovery_providers(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            health = get_json(port, "/healthz")
            assert health == (200, {"status": "ok", "draining": False,
                                    "lifecycle": "serving", "placeable": True})
            assert "recovery" not in get_json(port, "/statsz")[1]
            return health
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_statsz_load_score_idle_and_under_load(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        gw = make_gateway(P, tmp, fake_provider(P, gate), max_concurrency=2)
        try:
            port = gw.address[1]
            idle = get_json(port, "/statsz")[1]["load_score"]
            assert idle == 0.0
            inflight = [None]
            t = start(lambda: inflight.__setitem__(0, post(port, {"prompt": "load probe"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="admission")
            busy = get_json(port, "/statsz")[1]["load_score"]
            assert 0.0 < busy <= 1.0
            gate.set()
            join([t])
            assert inflight[0][0] == 200
            return idle, busy
        finally:
            gate.set()
            gw.close(timeout=5.0)

    assert both(scenario, tmp_path) == (0.0, 0.25)


def test_recovering_engines_raise_load_score(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, recovery_provider(P))
        try:
            score = get_json(gw.address[1], "/statsz")[1]["load_score"]
            assert score > 0.0
            return score
        finally:
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def abandoned_post(port, body):
    """Send a full request, then hang up before reading the response."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/v1/consensus", json.dumps(body),
                 {"Content-Type": "application/json"})
    conn.close()


def test_queued_client_disconnect_dropped_at_dequeue(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        provider = fake_provider(P, gate)
        gw = make_gateway(P, tmp, provider, max_concurrency=1, max_queue=4)
        try:
            port = gw.address[1]
            leader = [None]
            t = start(lambda: leader.__setitem__(0, post(port, {"prompt": "slot holder"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="leader slot")
            abandoned_post(port, {"prompt": "abandoned while queued"})
            wait_for(lambda: gw.admission.snapshot()["dropped_disconnected"] == 1,
                     what="disconnect drop")
            gate.set()
            join([t])
            assert leader[0][0] == 200
            assert ("alpha", "abandoned while queued") not in provider.panel_calls()
            assert gw.scheduler.runs_executed == 1
            after = post(port, {"prompt": "after the drop"})[0]
            assert after == 200
            return gw.admission.snapshot()["dropped_disconnected"], after
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


def test_queued_leader_with_followers_still_runs(tmp_path):
    def scenario(P, tmp):
        gate = threading.Event()
        provider = fake_provider(P, gate)
        gw = make_gateway(P, tmp, provider, max_concurrency=1, max_queue=4, cache_size=0)
        try:
            port = gw.address[1]
            blocker = [None]
            tb = start(lambda: blocker.__setitem__(0, post(port, {"prompt": "blocker"})))
            wait_for(lambda: gw.admission.snapshot()["active"] == 1, what="blocker slot")
            leader_conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            leader_conn.request("POST", "/v1/consensus",
                                json.dumps({"prompt": "shared question"}),
                                {"Content-Type": "application/json"})
            wait_for(lambda: gw.admission.snapshot()["waiting"] == 1, what="leader queued")
            follower = [None]
            tf = start(lambda: follower.__setitem__(
                0, post(port, {"prompt": "shared question"})))
            wait_for(lambda: gw._flights.followers() == 1, what="follower joined")
            leader_conn.close()
            gate.set()
            join([tb, tf])
            assert blocker[0][0] == 200
            status, _, data = follower[0]
            assert status == 200, data
            doc = json.loads(data)
            assert doc["coalesced"] is True and doc["consensus"]
            assert gw.admission.snapshot()["dropped_disconnected"] == 0
            shared = [c for c in provider.panel_calls() if c[1] == "shared question"]
            assert len(shared) == len(PANEL)
            return norm(doc), len(shared)
        finally:
            gate.set()
            gw.close(timeout=5.0)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# the gateway cases of tests/test_pressure.py


def _pressure_gateway(P, tmp, governor):
    provider = fake_provider(P)
    gw = make_gateway(P, tmp, provider, models=["alpha", "beta", "big-judge", "small-judge"],
                      judge="big-judge", cache_size=0, governor=governor)
    return gw, provider


def _gov(P, **kw):
    kw.setdefault("high_water", 0.75)
    kw.setdefault("low_water", 0.35)
    kw.setdefault("up_patience", 2)
    kw.setdefault("down_patience", 3)
    return P.Governor(**kw)


def test_gateway_brownout_downgrades_judge_and_tags(tmp_path):
    def scenario(P, tmp):
        gov = _gov(P, up_patience=1, judge_fallback={"big-judge": "small-judge"},
                   brownout_max_new=32, poll_s=3600.0)
        gw, provider = _pressure_gateway(P, tmp, gov)
        try:
            port = gw.address[1]
            full = json.loads(post(port, {"prompt": "full quality"})[2])
            assert "degraded" not in full and full["judge"] == "big-judge"
            for _ in range(3):
                gov.observe(1.0)
            assert gov.brownout
            status, _, data = post(port, {"prompt": "brown quality"})
            brown = json.loads(data)
            assert status == 200 and brown["degraded"] == "brownout"
            assert brown["judge"] == "small-judge"
            assert any(m == "small-judge" for m, _p, _mt in provider.calls)
            assert all(mt == 32 for _m, p, mt in provider.calls if "brown quality" in p)
            stats = get_json(port, "/statsz")[1]
            assert stats["pressure"]["state"] == "brownout"
            assert stats["pressure"]["brownouts"] >= 1
            pressure = {k: v for k, v in stats["pressure"].items() if k != "signals"}
            return norm(full), norm(brown), pressure, sorted(stats["pressure"]["signals"])
        finally:
            gw.close(drain=False, timeout=5.0)

    both(scenario, tmp_path)


def test_gateway_shed_rejects_low_class_with_scaled_retry_after(tmp_path):
    def scenario(P, tmp):
        gov = _gov(P, up_patience=1, poll_s=3600.0)
        gw, _provider = _pressure_gateway(P, tmp, gov)
        try:
            port = gw.address[1]
            for _ in range(4):
                gov.observe(1.0)
            assert gov.state == "shed"
            status, headers, data = post(port, {"prompt": "flood traffic", "priority": "low"})
            assert status == 429 and "Retry-After" in headers, data
            low_ra = json.loads(data)["retry_after_s"]
            status2, _, data2 = post(port, {"prompt": "interactive traffic", "priority": "high"})
            assert status2 == 200, data2
            assert low_ra >= gw.admission.retry_after_s
            return status, json.loads(data)["error"], status2, gov.snapshot()["shed"]
        finally:
            gw.close(drain=False, timeout=5.0)

    both(scenario, tmp_path)


def test_gateway_rejects_bad_priority(tmp_path):
    def scenario(P, tmp):
        gw, _provider = _pressure_gateway(P, tmp, _gov(P, poll_s=3600.0))
        try:
            status, _, data = post(gw.address[1], {"prompt": "x", "priority": "urgent"})
            assert status == 400
            return status, json.loads(data)
        finally:
            gw.close(drain=False, timeout=5.0)

    both(scenario, tmp_path)


# ---------------------------------------------------------------------------
# the gateway cases of tests/test_live_obs.py


def _families(text: str, P) -> tuple:
    """(histogram metric → label-name sets, gauge name → label sets) of a
    /metricsz body, parsed by package ``P``'s parser. ``build_info``'s
    runtime label (jax / torch) is named for the package."""
    parsed = P.prom.parse_text(text)
    hists: dict = {}
    for (metric, labels) in parsed["histograms"]:
        hists.setdefault(metric, set()).add(labels)
    gauges: dict = {}
    for (name, labels) in parsed["gauges"]:
        if name == "build_info":
            labels = tuple(("runtime" if k in ("jax", "torch") else k, "*" if k in (
                "jax", "torch", "version") else v) for k, v in labels)
        gauges.setdefault(name, set()).add(labels)
    return hists, gauges, parsed


def test_gateway_metricsz_histograms_labeled_by_class(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P), live=P.live.LiveMetrics(window_s=60.0))
        try:
            port = gw.address[1]
            status, _, data = post(port, {"prompt": "interactive q", "priority": "high"})
            assert status == 200 and json.loads(data)["trace_id"]
            assert post(port, {"prompt": "batch q", "priority": "low"})[0] == 200
            deadline = time.monotonic() + 5.0
            while True:
                status, ctype, body = get(port, "/metricsz")
                assert status == 200 and ctype.startswith("text/plain")
                hists, gauges, parsed = _families(body.decode("utf-8"), P)
                e2e = sum(h["count"] for (m, _), h in parsed["histograms"].items() if m == "e2e")
                if e2e >= 2 or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            for metric in ("ttft", "e2e", "queue_wait"):
                classes = {dict(labels).get("class") for labels in hists[metric]}
                assert {"high", "low"} <= classes, (metric, classes)
            assert "judge_synthesis" in hists
            stat_blocks = {dict(labels)["block"] for labels in gauges["stat"]}
            assert {"admission", "cache"} <= stat_blocks
            assert ("load_score", ()) in parsed["gauges"]
            counts = {m: sum(h["count"] for (mm, _), h in parsed["histograms"].items()
                             if mm == m) for m in hists}
            return hists, {k: v for k, v in gauges.items()}, counts
        finally:
            gw.close(drain=False, timeout=5.0)

    both(scenario, tmp_path)


def test_trace_header_honored_and_returned(tmp_path):
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P), live=P.live.LiveMetrics(window_s=60.0))
        try:
            port = gw.address[1]
            _, _, data = post(port, {"prompt": "traced"},
                              headers={"X-LLMC-Trace": "feedbeefcafe0001"})
            assert json.loads(data)["trace_id"] == "feedbeefcafe0001"
            minted = json.loads(post(port, {"prompt": "untraced"})[2])["trace_id"]
            assert len(minted) == 16
            int(minted, 16)
            return json.loads(data)["trace_id"], len(minted)
        finally:
            gw.close(drain=False, timeout=5.0)

    both(scenario, tmp_path)


def test_prom_render_and_roundtrip_equal_the_jax_exposition():
    """The same observations render byte-identical text-format in both
    packages (family names, label sets, bucket edges), and both parse it
    back to the same structure."""
    texts = []
    for P in PKGS:
        lm = P.live.LiveMetrics(window_s=60.0)
        for v, cls in ((0.01, "high"), (0.2, "normal"), (3.0, "normal")):
            lm.observe("ttft", v, outcome="ok", **{"class": cls})
        texts.append(P.prom.render(lm, stats_blocks={"kv": {"p": {"hits": 3}}},
                                   gauges={"load_score": 0.25},
                                   families={"integrity_checks_total": {
                                       "type": "counter",
                                       "samples": [({"surface": "ckpt"}, 2)]}}))
    assert texts[0] == texts[1]
    parsed = prom.parse_text(texts[1])
    assert parsed == jax_prom.parse_text(texts[0])
    key = ("ttft", (("class", "normal"), ("outcome", "ok")))
    assert parsed["histograms"][key]["count"] == 2
    assert prom.parse_text(prom.render_parsed(parsed)) == parsed


def test_slo_watcher_burns_after_n_windows():
    fired = []
    for P in PKGS:
        burns = []
        w = P.live.SLOWatcher(threshold_s=0.1, windows=3, on_burn=burns.append)
        lm = P.live.LiveMetrics(window_s=60.0)
        seq = []
        for _ in range(3):
            lm.observe("ttft", 5.0, outcome="ok", **{"class": "high"})
            lm.rotate()
            seq.append(w.check(lm))
        lm.rotate()  # a quiet window resets the streak
        seq.append(w.check(lm))
        seq.append(P.live.SLOWatcher(threshold_s=0.0).check(lm))
        fired.append((seq, burns))
    assert fired[0] == fired[1]
    assert fired[1][0] == [False, False, True, False, False]


def test_live_rotator_runs_callbacks_and_stops():
    lm = live.LiveMetrics(window_s=0.05)
    ticks = []
    lm.on_rotate(lambda m: ticks.append(m))
    lm.start()
    try:
        wait_for(lambda: len(ticks) >= 2, what="two rotations")
    finally:
        lm.close()
    lm.remove_rotate(ticks.append)  # an unknown callback is ignored
    assert all(t is lm for t in ticks)


def test_governor_escalation_past_preempt_dumps_blackbox(tmp_path):
    out = []
    for P in PKGS:
        d = tmp_path / P.name
        P.blackbox.install(P.blackbox.FlightRecorder(capacity=64, out_dir=str(d),
                                                     min_interval_s=0.0))
        gov = P.Governor(high_water=0.8, low_water=0.2, up_patience=1, down_patience=100)
        for _ in range(3):
            gov.observe(1.0)
        fr = P.blackbox.ring()
        assert gov.state == "brownout" and fr.dumps >= 1
        with open(fr.last_path) as f:
            doc = json.load(f)
        names = {e.get("name") for e in doc["traceEvents"] if isinstance(e, dict)}
        assert "pressure_escalate" in names
        out.append((gov.state, fr.dumps, fr.last_reason))
    assert out[0] == out[1] == ("brownout", 1, "pressure_brownout")


def test_stats_registry_contract():
    for P in PKGS:
        reg = P.StatsRegistry()
        reg.register("good", lambda: {"x": 1})
        reg.register("empty", lambda: {})
        reg.register("none", lambda: None)
        reg.register("boom", lambda: 1 / 0)
        assert reg.collect() == {"good": {"x": 1}}
        assert reg.names() == ["good", "empty", "none", "boom"]
        reg.register("good", lambda: {"x": 2})
        assert reg.collect() == {"good": {"x": 2}}


# ---------------------------------------------------------------------------
# the integrity and admin surfaces


def test_gateway_swap_maps_digest_refusal_to_409(tmp_path, monkeypatch):
    """tests/test_integrity.py: a digest-refused swap answers 409, counts a
    ckpt strike, and the second strike quarantines the replica (threshold
    2: the JAX gateway reads it from the environment, the port's gateway
    takes it as an argument); the quarantine walk answers the JAX shape."""
    monkeypatch.setenv("LLMC_INTEGRITY_QUARANTINE_AFTER", "2")

    def scenario(P, tmp):
        P.integrity.install(P.integrity.IntegrityPlane(sample=0.05))
        provider = fake_provider(P)
        provider.swap_weights = lambda model, path, version=None, *, wait=False, meta=None: {
            "accepted": False, "rejected": "params_digest_mismatch", "weight_version": 1}
        kw = {"quarantine_after": 2} if P is TORCH else {}
        gw = make_gateway(P, tmp, provider, **kw)
        try:
            doc = {"model": "alpha", "checkpoint": "/nonexistent/params", "version": 2}
            first = gw.swap_checkpoint(doc)
            assert first[0] == 409 and first[1]["rejected"] == "params_digest_mismatch"
            assert gw.lifecycle == "serving"
            second = gw.swap_checkpoint(doc)
            assert second[0] == 409 and gw.lifecycle == "quarantined"
            health = get_json(gw.address[1], "/healthz")
            assert health[0] == 503 and health[1]["status"] == "quarantined"
            stats = get_json(gw.address[1], "/statsz")[1]
            return first, second, health, stats["integrity"]["quarantine"], stats["elastic"]
        finally:
            gw.close(drain=False)
            P.integrity.reset()

    both(scenario, tmp_path)


def test_quarantine_probe_windows_lift_it(tmp_path):
    def scenario(P, tmp):
        P.integrity.install(P.integrity.IntegrityPlane(sample=0.05))
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            status, _, data = post(gw.address[1], {}, path="/v1/quarantine")
            walked = json.loads(data)
            assert status == 200 and walked["lifecycle"] == "quarantined"
            probes = [gw.probe_quarantine() for _ in range(3)]
            assert probes == [False, False, True] and gw.lifecycle == "serving"
            return walked, probes
        finally:
            gw.close(drain=False)
            P.integrity.reset()

    both(scenario, tmp_path)


def test_swap_route_errors_match(tmp_path):
    """The swap route's validation answers the JAX gateway's codes (400 for
    an unknown model or a malformed body, 501 for a provider without swaps,
    409 for a rollback with nothing to roll back to)."""
    def scenario(P, tmp):
        provider = fake_provider(P)
        gw = make_gateway(P, tmp, provider)
        try:
            port = gw.address[1]
            out = [post(port, body, path="/v1/swap")[0] for body in (
                {"model": "nope", "checkpoint": "/x"}, {"model": "alpha"},
                {"model": "alpha", "checkpoint": "/x", "version": "2"},
                {"model": "alpha", "checkpoint": "/x"},
                {"model": "alpha", "action": "rollback"},
                {"model": "alpha", "action": "sideways"})]
            provider.rollback_weights = lambda model, meta=None: None
            out.append(post(port, {"model": "alpha", "action": "rollback"}, path="/v1/swap")[0])
            return out
        finally:
            gw.close(drain=False)

    assert both(scenario, tmp_path) == [400, 400, 400, 501, 501, 400, 409]


def test_fleet_routes_answer_on_both_gateways(tmp_path):
    """The gateway's fleet half: ``/v1/migrate`` parks a record (400 without
    a key), a quarantine with ``to`` and a retire with ``to`` walk the
    lifecycle with no resident to ship, and a bad ``to`` is a 400 — the
    JAX gateway's answers."""
    def scenario(P, tmp):
        gw = make_gateway(P, tmp, fake_provider(P))
        try:
            port = gw.address[1]
            out = []
            for path, body in (("/v1/migrate", {}),
                               ("/v1/migrate", {"key": "k", "resume": {"alpha": {"text": ""}}}),
                               ("/v1/quarantine", {"to": "http://127.0.0.1:9"}),
                               ("/v1/retire", {"to": 5}),
                               ("/v1/retire", {"to": "http://127.0.0.1:9"})):
                status, _, data = post(port, body, path=path)
                out.append((status, json.loads(data)))
            elastic = get_json(port, "/statsz")[1]["elastic"]
            return out, {k: elastic[k] for k in ("lifecycle", "migrations_in", "retires",
                                                 "quarantines", "table")}
        finally:
            gw.close(drain=False)

    out, elastic = both(scenario, tmp_path)
    assert [s for s, _ in out] == [400, 200, 200, 400, 200]
    assert elastic["lifecycle"] == "retiring" and elastic["table"]["depth"] == 1


def test_swap_out_dir_answers_501_until_the_flywheel(tmp_path):
    """The swap body's ``out_dir`` form (a distill output root) answered 501
    until the port had the flywheel; now it answers as the JAX gateway does:
    404 with no checkpoint under the root, else the newest version's
    ``params`` path, version and ``version.json`` meta go to the provider's
    ``swap_weights`` (200 when it accepts), the lifecycle untouched."""
    root = tmp_path / "distill"
    (root / "v0002" / "params").mkdir(parents=True)
    (root / "v0002" / "version.json").write_text(json.dumps(
        {"version": 2, "corpus_hash": "abc", "step": 8}))

    def scenario(P, tmp):
        provider = fake_provider(P)
        calls = []

        def swap_weights(model, path, version, wait=False, meta=None):
            calls.append((model, os.path.relpath(path, root), version, wait, meta))
            return {"accepted": True, "weight_version": version}

        provider.swap_weights = swap_weights
        gw = make_gateway(P, tmp, provider)
        try:
            port = gw.address[1]
            missing = post(port, {"model": "alpha", "out_dir": str(tmp / "none")},
                           path="/v1/swap")[0]
            status, _, data = post(port, {"model": "alpha", "out_dir": str(root)},
                                   path="/v1/swap")
            return missing, status, json.loads(data)["weight_version"], calls, gw.lifecycle
        finally:
            gw.close(drain=False)

    got = both(scenario, tmp_path)
    assert got[:3] == (404, 200, 2)
    assert got[3] == [("alpha", "v0002/params", 2, False,
                       {"version": 2, "corpus_hash": "abc", "step": 8})]
    assert got[4] == "serving"


def test_debugz_blackbox_and_profile_contracts(tmp_path):
    """POST /debugz/blackbox and /debugz/profile: 404 with the plane off;
    on, 200 with a path, then 429 inside the rate limit. The profile window
    closes on its own thread and its directory appears complete."""
    gw = make_gateway(TORCH, tmp_path, fake_provider(TORCH))
    try:
        port = gw.address[1]
        assert post(port, {}, path="/debugz/blackbox")[0] == 404
        assert post(port, {}, path="/debugz/profile")[0] == 404
    finally:
        gw.close(drain=False)
    blackbox.install(blackbox.FlightRecorder(capacity=64, out_dir=str(tmp_path / "bb"),
                                             min_interval_s=3600.0))
    profiler.install(profiler.DeepProfiler(out_dir=str(tmp_path / "prof"), max_s=0.3,
                                           min_interval_s=3600.0))
    gw = make_gateway(TORCH, tmp_path, fake_provider(TORCH))
    try:
        port = gw.address[1]
        assert post(port, {"prompt": "fill the ring"})[0] == 200
        status, _, data = post(port, {}, path="/debugz/blackbox")
        assert status == 200 and os.path.exists(json.loads(data)["path"])
        assert post(port, {}, path="/debugz/blackbox")[0] == 429
        status, _, data = post(port, {"duration_s": 0.2, "tag": "t"}, path="/debugz/profile")
        doc = json.loads(data)
        assert status == 200 and doc["status"] == "armed"
        assert post(port, {}, path="/debugz/profile")[0] == 429
        assert post(port, {"duration_s": "x"}, path="/debugz/profile")[0] == 400
        wait_for(lambda: os.path.isdir(doc["path"]), what="the profile window to close")
        assert os.path.exists(os.path.join(doc["path"], "trace.json"))
    finally:
        gw.close(drain=False)
