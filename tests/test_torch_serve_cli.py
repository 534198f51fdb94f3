"""``serve`` end to end: the JAX ``serve_main`` and the port's, in process
with a shutdown event, on the same synthetic tiny-llama checkpoint
(``LLMC_CHECKPOINT_DIR``) and real engines on the CPU.

For the same prompt the two servers give the same JSON consensus, the same
``result.json`` fields and the same run-directory listing. The port's
server parks a migration record on ``/v1/migrate``, then drains with a
request in flight (exit 0, the run flushed), and serves ``--disagg`` (the
handoff's arguments reach the provider). Two real-engine servers in all:
JAX compiles are slow.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import threading
import time

import pytest

from llm_consensus_tpu.pressure.governor import PressureGovernor as JaxGovernor
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.cli.main import main as port_main
from llm_consensus_tpu_torch.pressure.governor import PressureGovernor

WAIT = 240.0
PROMPT = "what is consensus?"
ARGS = ["--max-tokens", "8", "--port", "0", "--max-batch", "2", "--queue-depth", "4"]


def _port_of(stderr: io.StringIO, thread: threading.Thread) -> int:
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        text = stderr.getvalue()
        if "http://" in text:
            return int(text.split("http://", 1)[1].split("/", 1)[0].rsplit(":", 1)[1])
        assert thread.is_alive(), text
        time.sleep(0.02)
    raise AssertionError("server never printed its address")


def _post(port, body, path="/v1/consensus"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


class _Server:
    """One ``serve_main`` on a thread, stopped by its shutdown event."""

    def __init__(self, fn, argv, **kw):
        self.stop = threading.Event()
        self.stderr = io.StringIO()
        self.rc: list = []
        self.thread = threading.Thread(target=lambda: self.rc.append(fn(
            argv, stdout=io.StringIO(), stderr=self.stderr, install_signal_handlers=False,
            shutdown=self.stop, **kw)), daemon=True)
        self.thread.start()
        self.port = _port_of(self.stderr, self.thread)

    def close(self) -> int:
        self.stop.set()
        self.thread.join(WAIT)
        assert not self.thread.is_alive(), "server never drained"
        return self.rc[0]


def _run_dir(data, run_id):
    d = os.path.join(data, run_id)
    with open(os.path.join(d, "result.json")) as f:
        return sorted(os.listdir(d)), json.load(f)


def _strip(doc):
    """A result less its timings and run ids, with the JAX names (the
    ``tpu:`` scheme, the ``tpu`` provider) in the port's spelling."""
    text = json.dumps(doc).replace("tpu:", "gpu:").replace('"provider": "tpu"',
                                                           '"provider": "gpu"')
    out = json.loads(text)
    for key in ("run_id", "trace_id"):
        out.pop(key, None)
    for r in out.get("responses", []):
        for key in ("latency_ms", "tokens_per_sec", "mfu", "mbu"):
            r.pop(key, None)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both servers on one checkpoint: the JAX one with ``tpu:`` names,
    the port's with ``gpu:``; each answers one request, then the JAX server
    stops and the port's stays up for the drain test."""
    from llm_consensus_tpu.cli.serve import serve_main as jax_serve_main
    from llm_consensus_tpu.models import get_config as jax_config
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("serve-cli")
    _make_hf_checkpoint(jax_config("tiny-llama"), str(root / "ckpt" / "tiny-llama"), seed=0)
    out: dict = {}
    governors: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        for scheme, cls in (("tpu", JaxGovernor), ("gpu", PressureGovernor)):
            def init(self, *a, _real=cls.__init__, _scheme=scheme, **k):
                _real(self, *a, **k)
                governors[_scheme] = self  # the governor build_gateway made

            mp.setattr(cls, "__init__", init)
        mp.setenv("LLMC_CHECKPOINT_DIR", str(root / "ckpt"))
        mp.setenv("LLMC_LIVE", "0")
        mp.delenv("LLMC_FAULTS", raising=False)
        obs.reset_planes()
        faults.reset()
        integrity.reset()
        _reset_jax_planes()
        for scheme, fn, kw in (("tpu", jax_serve_main, {}),
                               ("gpu", port_main, {"device": "cpu"})):
            data = str(root / scheme)
            argv = (["serve"] if scheme == "gpu" else []) + [
                "--models", f"{scheme}:tiny-llama,{scheme}:tiny-llama",
                "--judge", f"{scheme}:tiny-llama", "--data-dir", data] + ARGS
            server = _Server(fn, argv, **kw)
            try:
                status, doc = _post(server.port, {"prompt": PROMPT})
                assert status == 200, doc
                health = _get(server.port, "/healthz")
                stats = _get(server.port, "/statsz")[1]
            except BaseException:
                server.close()
                raise
            out[scheme] = {"doc": doc, "data": data, "health": health, "stats": stats,
                           "server": server, "governor": governors[scheme]}
            if scheme == "tpu":
                assert server.close() == 0
        yield out
        server = out["gpu"]["server"]
        if server.thread.is_alive():
            server.close()
    obs.reset_planes()
    _reset_jax_planes()


def _reset_jax_planes():
    """No JAX recorder, fault plan or integrity plane left by an earlier test
    of this worker: the JAX server would write trace.json and metrics.json
    into its run directories with one."""
    import llm_consensus_tpu.faults as jax_faults
    import llm_consensus_tpu.integrity as jax_integrity
    import llm_consensus_tpu.obs as jax_obs

    jax_obs.reset()
    jax_faults.reset()
    jax_integrity.reset()


def test_the_consensus_equals_the_jax_servers(served):
    jax_doc, doc = served["tpu"]["doc"], served["gpu"]["doc"]
    assert list(doc) == list(jax_doc)
    assert _strip(doc) == _strip(jax_doc)
    assert doc["cached"] is False and doc["coalesced"] is False
    assert [r["model"] for r in doc["responses"]] == ["gpu:tiny-llama", "gpu:tiny-llama"]


def test_the_run_directory_equals_the_jax_servers(served):
    jax_listing, jax_result = _run_dir(served["tpu"]["data"], served["tpu"]["doc"]["run_id"])
    listing, result = _run_dir(served["gpu"]["data"], served["gpu"]["doc"]["run_id"])
    assert listing == jax_listing == ["consensus.md", "prompt.txt", "result.json", "run.json"]
    assert list(result) == list(jax_result)
    assert _strip(result) == _strip(jax_result)
    with open(os.path.join(served["gpu"]["data"], served["gpu"]["doc"]["run_id"],
                           "run.json")) as f:
        manifest = json.load(f)
    assert manifest["source"] == "serve" and manifest["prompt"] == PROMPT


def _ages(doc):
    """A health document less its heartbeat ages (timings)."""
    doc = json.loads(json.dumps(doc))
    for beat in doc.get("engines", {}).get("heartbeats", {}).values():
        beat.pop("age_s", None)
    return doc


# The pressure block's readings that follow the rung's walk under load.
PRESSURE_LIVE = ("state", "pressure", "signals", "escalations", "de_escalations",
                 "preempt_nudges", "evicted_blocks", "brownouts", "shed")
GOVERNOR_CONFIG = ("high_water", "low_water", "up_patience", "down_patience", "poll_s",
                   "judge_fallback", "brownout_max_new", "shed_class", "evict_target")


def _steady(block):
    """A /statsz pressure block less its live readings (the pools' too)."""
    out = {k: v for k, v in block.items() if k not in PRESSURE_LIVE}
    out["pools"] = {m: {k: v for k, v in pool.items() if k not in ("live", "queued")}
                    for m, pool in block.get("pools", {}).items()}
    return out


def test_health_and_stats_blocks_equal_the_jax_servers(served):
    (status, health), (jax_status, jax_health) = served["gpu"]["health"], served["tpu"]["health"]
    assert status == jax_status == 200
    assert _ages(health) == _ages(jax_health)
    stats, jax_stats = served["gpu"]["stats"], served["tpu"]["stats"]
    assert stats["admission"] == jax_stats["admission"]
    assert stats["admission"]["max_concurrency"] == 1  # --max-batch 2 over multiplicity 2
    assert set(stats["batchers"]) == set(jax_stats["batchers"]) == {"tiny-llama"}
    # The rung depends on timing (a busy pool reads as pressure 1.0 to both
    # governors): the block less its live readings, then the configuration
    # each governor was built with.
    assert _steady(stats["pressure"]) == _steady(jax_stats["pressure"])
    assert {stats["pressure"]["state"], jax_stats["pressure"]["state"]} <= {
        "ok", "evict", "preempt", "brownout", "shed"}
    assert set(stats["pressure"]["signals"]) == set(jax_stats["pressure"]["signals"])
    gov, jax_gov = served["gpu"]["governor"], served["tpu"]["governor"]
    assert {k: getattr(gov, k) for k in GOVERNOR_CONFIG} == {
        k: getattr(jax_gov, k) for k in GOVERNOR_CONFIG}
    assert stats["flywheel"]["tiny-llama"]["weight_version"] == 0


def test_migrate_parks_a_record_on_the_served_gateway(served):
    port = served["gpu"]["server"].port
    status, doc = _post(port, {}, path="/v1/migrate")
    assert status == 400 and "bad record" in doc["error"]
    status, doc = _post(port, {"key": "k-cli", "resume": {"gpu:tiny-llama": {"text": ""}}},
                        path="/v1/migrate")
    assert status == 200 and doc == {"accepted": True, "key": "k-cli"}
    elastic = _get(port, "/statsz")[1]["elastic"]
    assert elastic["migrations_in"] == 1 and elastic["table"]["depth"] == 1


def test_drain_with_a_request_in_flight_flushes_the_run(served):
    server = served["gpu"]["server"]
    result: list = []
    t = threading.Thread(target=lambda: result.append(_post(
        server.port, {"prompt": "a second question", "max_tokens": 48})), daemon=True)
    t.start()
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if _get(server.port, "/statsz")[1]["admission"]["active"] == 1:
            break
        time.sleep(0.01)
    assert server.close() == 0
    t.join(WAIT)
    status, doc = result[0]
    assert status == 200, doc
    listing, saved = _run_dir(served["gpu"]["data"], doc["run_id"])
    assert "result.json" in listing and saved["consensus"] == doc["consensus"]
    assert "Drained cleanly" in server.stderr.getvalue()


@pytest.mark.parametrize("flag", [["--disagg"]])
def test_announce_and_disagg_exit_1(flag, monkeypatch):
    """``--disagg`` exited 1 while the port had no handoff; now the server
    starts with the provider's disaggregation and the KV pool (its channel)
    on, both passed as arguments (nothing is written to the environment),
    the gateway's ``disagg`` feature on, and drains with exit 0."""
    from llm_consensus_tpu_torch import serve
    from llm_consensus_tpu_torch.cli import serve as serve_cli

    seen: dict = {}
    real_build, real_provider = serve.build_gateway, serve_cli._gpu_provider

    def build(*a, **k):
        seen["features"] = k["features"]
        return real_build(*a, **k)

    def provider(cfg, dev):
        p = real_provider(cfg, dev)
        seen["provider"] = (p.disagg["disagg"], p.kv["kv_pool"])
        return p

    monkeypatch.setattr(serve, "build_gateway", build)
    monkeypatch.setattr(serve_cli, "_gpu_provider", provider)
    for knob in ("LLMC_KV_POOL", "LLMC_DISAGG"):
        monkeypatch.delenv(knob, raising=False)
    before = dict(os.environ)
    stop = threading.Event()
    stop.set()  # drain as soon as it serves
    err = io.StringIO()
    rc = port_main(["serve", "--models", "gpu:tiny-llama", "--port", "0", "--quiet"] + flag,
                   device="cpu", stdout=io.StringIO(), stderr=err,
                   install_signal_handlers=False, shutdown=stop)
    assert rc == 0, err.getvalue()
    assert seen["provider"] == (True, True) and seen["features"]["disagg"] is True
    assert dict(os.environ) == before


@pytest.mark.parametrize("sub", ["distill"])
def test_other_subcommands_exit_1(sub, tmp_path):
    """``distill`` exited 1 while the port had no flywheel; now an empty
    corpus prints the JAX CLI's summary and exits 2, as the JAX CLI does."""
    from llm_consensus_tpu.cli.main import main as jax_main

    outs = []
    for entry, kw in ((port_main, {"device": "cpu"}), (jax_main, {})):
        out = io.StringIO()
        rc = entry([sub, "--data-dir", str(tmp_path), "--quiet"], stdout=out,
                   stderr=io.StringIO(), install_signal_handlers=False, **kw)
        outs.append((rc, json.loads(out.getvalue())))
    assert outs[0] == outs[1]
    assert outs[0][0] == 2 and outs[0][1]["error"] == "no training examples in corpus"


def test_concurrency_is_resolved_like_the_jax_cli():
    from llm_consensus_tpu.cli import serve as jax_cli
    from llm_consensus_tpu.cli.main import CLIError as JaxCLIError
    from llm_consensus_tpu_torch.cli import serve as port_cli
    from llm_consensus_tpu_torch.cli.main import CLIError

    cases = [
        "--models gpu:llama-3-8b,gpu:consensus-1b --judge gpu:llama-3-8b --max-batch 8",
        "--models gpu:tiny-llama,gpu:tiny-llama,gpu:tiny-llama --judge gpu:tiny-qwen2 --max-batch 8",
        "--models gpu:tiny-llama --judge gpu:tiny-llama --max-batch 8 --max-concurrency 4",
        "--models gpu:tiny-llama --judge gpu:tiny-llama --max-batch 8 --max-concurrency 5",
        "--models claude-opus-4-5 --judge claude-opus-4-5",
    ]
    for case in cases:
        got = want = None
        try:
            got = port_cli.resolve_concurrency(port_cli.parse_serve_args(case.split()))
        except CLIError as err:
            got = str(err).replace("gpu", "tpu")
        try:
            want = jax_cli.resolve_concurrency(
                jax_cli.parse_serve_args(case.replace("gpu:", "tpu:").split()))
        except JaxCLIError as err:
            want = str(err)
        assert got == want, case
    assert port_cli.resolve_concurrency(port_cli.parse_serve_args(cases[0].split())) == 4
