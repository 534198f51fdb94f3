"""``route`` end to end and the provider's migration surface, against the
JAX package.

  * ``parse_route_args`` gives the JAX parser's settings and refusals over
    the same argv.
  * Both packages run ``route`` (in process, with a shutdown event) and a
    ``serve --announce`` gateway on one synthetic tiny-llama checkpoint
    (``LLMC_CHECKPOINT_DIR``) with real engines on the CPU: the gateway
    registers by heartbeat, the router answers one request over it, and the
    request's ``X-LLMC-Trace`` reaches the ``route`` span, the gateway's
    ``engine_stream`` span and the stream's journal entry (its WAL header).
    Both subcommands exit 0 on shutdown.
  * One float32 engine-level case: ``seal_stream`` on a journaled batcher
    mid-decode, then the payload's ``resume`` through another provider's
    batcher, gives the JAX engine's uninterrupted greedy stream.
"""

from __future__ import annotations

import glob
import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import obs as jax_obs
from llm_consensus_tpu import recovery as jax_recovery
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.recovery.journal import read_wal as jax_read_wal
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.cli.main import main as port_main
from llm_consensus_tpu_torch.engine import Engine
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.providers import Request
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.recovery import StreamJournal
from llm_consensus_tpu_torch.recovery.journal import read_wal
from llm_consensus_tpu_torch.utils.context import Context

WAIT = 240.0
TRACE = "feedbeefcafe0042"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- argument parsing ------------------------------------------------------------------


def test_parse_route_args_matches_jax():
    from llm_consensus_tpu.cli.main import CLIError as JaxCLIError
    from llm_consensus_tpu.cli.route import parse_route_args as jax_parse
    from llm_consensus_tpu_torch.cli.main import CLIError
    from llm_consensus_tpu_torch.cli.route import parse_route_args

    cases = [
        [],
        ["--replica", "http://a:1", "--replica", "http://b:2,http://c:3", "--port", "0"],
        ["--poll-s", "0.5", "--saturation", "0.5", "--min-replicas", "2",
         "--max-replicas", "3", "--quiet", "--events", "--save", "--data-dir", "d"],
        ["--spillover-models", "gpt-4o,claude-opus-4-5", "--spillover-judge", "gpt-4o"],
        ["--spillover", "off", "--spillover-models", "gpt-4o"],
        ["--replica", "a:1"],
        ["--spillover", "saturated"],
    ]
    for argv in cases:
        try:
            ns, replicas, spill, policy = parse_route_args(argv)
            got = (vars(ns), replicas, spill, policy)
        except CLIError as err:
            got = str(err)
        try:
            ns, replicas, spill, policy = jax_parse(argv)
            want = (vars(ns), replicas, spill, policy)
        except JaxCLIError as err:
            want = str(err)
        assert got == want, argv
    with pytest.raises(CLIError, match="expected an http"):
        parse_route_args(["--replica", "a:1"])


# -- route over an announced gateway, both packages -------------------------------------


def _port_of(stderr: io.StringIO, thread: threading.Thread) -> int:
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        text = stderr.getvalue()
        if "http://" in text:
            return int(text.split("http://", 1)[1].split(" ", 1)[0].split("/", 1)[0]
                       .rsplit(":", 1)[1])
        assert thread.is_alive(), text
        time.sleep(0.02)
    raise AssertionError("server never printed its address")


class _Server:
    """One in-process subcommand on a thread, stopped by its shutdown event."""

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
        assert not self.thread.is_alive(), "server never stopped"
        return self.rc[0]


def _request(method, port, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request(method, path, None if body is None else json.dumps(body), hdrs)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _reset_jax_planes():
    from llm_consensus_tpu import faults as jax_faults
    from llm_consensus_tpu import integrity as jax_integrity
    from llm_consensus_tpu.obs import attrib, blackbox, live, profiler, roofline

    jax_obs.reset()
    jax_faults.reset()
    jax_integrity.reset()
    jax_recovery.reset()
    for plane in (live, blackbox, attrib, roofline, profiler):
        plane.reset()


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """For each package: ``route`` with no static replica, then ``serve
    --announce`` to it (``--events``, journal WAL files under
    ``LLMC_JOURNAL``); one traced request through the router; both stopped.
    Returns each package's observations."""
    from llm_consensus_tpu.cli.route import route_main as jax_route_main
    from llm_consensus_tpu.cli.serve import serve_main as jax_serve_main
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("route-cli")
    _make_hf_checkpoint(jax_config("tiny-llama"), str(root / "ckpt" / "tiny-llama"), seed=0)
    out: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_CHECKPOINT_DIR", str(root / "ckpt"))
        mp.setenv("LLMC_LIVE", "0")
        mp.setenv("LLMC_FLEET_HEARTBEAT_S", "0.2")
        mp.delenv("LLMC_FAULTS", raising=False)
        for scheme in ("tpu", "gpu"):
            obs.reset_planes()
            faults.reset()
            integrity.reset()
            _reset_jax_planes()
            wal_dir = root / scheme / "wal"
            wal_dir.mkdir(parents=True)
            mp.setenv("LLMC_JOURNAL", str(wal_dir))
            if scheme == "tpu":
                route_fn, serve_fn, kw = jax_route_main, jax_serve_main, {}
            else:
                route_fn, serve_fn, kw = port_main, port_main, {"device": "cpu"}
            router = _Server(route_fn, (["route"] if scheme == "gpu" else []) + [
                "--port", "0", "--poll-s", "60", "--events"])
            router_url = f"http://127.0.0.1:{router.port}"
            gateway = _Server(serve_fn, (["serve"] if scheme == "gpu" else []) + [
                "--models", f"{scheme}:tiny-llama", "--judge", f"{scheme}:tiny-llama",
                "--max-tokens", "8", "--port", "0", "--max-batch", "2", "--events",
                "--data-dir", str(root / scheme / "data"), "--announce", router_url], **kw)
            try:
                deadline = time.monotonic() + WAIT
                while time.monotonic() < deadline:
                    _, stats = _request("GET", router.port, "/statsz")
                    if stats["fleet"]["replicas"]:
                        break
                    time.sleep(0.05)
                registered = stats["fleet"]["replicas"][0]
                status, doc = _request("POST", router.port, "/v1/consensus",
                                       {"prompt": "what is consensus?"},
                                       headers={"X-LLMC-Trace": TRACE})
                recorder = (jax_obs if scheme == "tpu" else obs).recorder()
                spans = {}
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    spans = {name: [e.args.get("trace") for e in recorder.events()
                                    if e.ph == "X" and e.name == name]
                             for name in ("route", "engine_stream", "worker")}
                    if spans["route"]:
                        break
                    time.sleep(0.02)
                _, rstats = _request("GET", router.port, "/statsz")
            finally:
                serve_rc = gateway.close()
                route_rc = router.close()
            reader = jax_read_wal if scheme == "tpu" else read_wal
            wal_traces = [reader(p)["header"].get("trace")
                          for p in sorted(glob.glob(str(wal_dir / "*.wal")))]
            out[scheme] = {
                "registered": registered, "gateway_port": gateway.port, "status": status,
                "doc": doc, "spans": spans, "router_stats": rstats, "wal_traces": wal_traces,
                "serve_rc": serve_rc, "route_rc": route_rc,
                "route_stderr": router.stderr.getvalue(),
                "serve_stderr": gateway.stderr.getvalue(),
            }
    obs.reset_planes()
    _reset_jax_planes()
    for provider in GPUProvider._shared.values():
        provider.release()
    GPUProvider._shared.clear()
    return out


def test_serve_announce_registers_with_the_router(routed):
    for scheme, seen in routed.items():
        reg = seen["registered"]
        assert reg["url"] == f"http://127.0.0.1:{seen['gateway_port']}", scheme
        assert (reg["source"], reg["state"], reg["lifecycle"]) == (
            "heartbeat", "healthy", "serving"), scheme
        assert "announcing to fleet router http://127.0.0.1:" in seen["serve_stderr"]
    assert sorted(routed["gpu"]["registered"]) == sorted(routed["tpu"]["registered"])


def test_route_answers_one_request_and_exits_0(routed):
    for scheme, seen in routed.items():
        assert seen["status"] == 200, seen["doc"]
        doc = seen["doc"]
        assert doc["replica"] == f"http://127.0.0.1:{seen['gateway_port']}"
        assert doc["trace_id"] == TRACE and doc["consensus"]
        assert seen["router_stats"]["counters"]["requests"] == 1
        assert seen["router_stats"]["counters"]["failovers"] == 0
        assert seen["route_rc"] == 0 and seen["serve_rc"] == 0, scheme
        assert "fleet router on http://127.0.0.1:" in seen["route_stderr"]
    gpu, tpu = routed["gpu"], routed["tpu"]
    assert sorted(gpu["doc"]) == sorted(tpu["doc"])
    assert sorted(gpu["router_stats"]) == sorted(tpu["router_stats"])
    counters = [{k: v for k, v in seen["router_stats"]["counters"].items()
                 if k != "registered"} for seen in (gpu, tpu)]  # one per heartbeat
    assert counters[0] == counters[1]


def test_trace_id_reaches_the_engine_span_and_the_journal(routed):
    """One id from the client's header through the router to the engine:
    the ``route`` span, the runner's ``worker`` span, the provider's
    ``engine_stream`` span and the batcher's journal entry carry it."""
    for scheme, seen in routed.items():
        spans = seen["spans"]
        assert spans["route"] == [TRACE], scheme
        assert TRACE in spans["worker"], scheme
        assert TRACE in spans["engine_stream"], (scheme, spans)
        assert seen["wal_traces"] and set(seen["wal_traces"]) == {TRACE}, scheme
    assert len(routed["gpu"]["wal_traces"]) == len(routed["tpu"]["wal_traces"])


# -- seal on one provider, resume on another -------------------------------------------


PROMPT = "a migrated stream resumes where it was sealed"
MAX_NEW = 24


def test_sealed_stream_resumes_on_another_provider():
    jcfg = jax_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=256).generate(
        PROMPT, JaxSampling(max_new_tokens=MAX_NEW, ignore_eos=True))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"),
                           torch.device("cpu"), torch.float32)

    def provider():
        p = GPUProvider(device="cpu", batch_streams=2, journal=StreamJournal(),
                        stream_interval=4, ignore_eos=True)
        p._engines["tiny-llama"] = Engine(get_config("tiny-llama"), params=tp,
                                          dtype=torch.float32, max_seq=256,
                                          stream_interval=4, device="cpu")
        return p

    src, dst = provider(), provider()
    try:
        first = threading.Event()
        hold = threading.Event()
        src_ctx = Context.background().with_cancel()

        def on_chunk(text):
            first.set()
            assert hold.wait(WAIT)

        box: dict = {}
        req = Request(model="gpu:tiny-llama", prompt=PROMPT, max_tokens=MAX_NEW,
                      trace_id="t-migrate")

        def run_source():
            try:
                src.query_stream(src_ctx, req, on_chunk)
            except Exception as err:  # noqa: BLE001 — the source is cancelled
                box["err"] = err

        t = threading.Thread(target=run_source, daemon=True)
        t.start()
        assert first.wait(WAIT)
        assert src.seal_stream("no-such-trace") is None
        payload = src.seal_stream("t-migrate")
        src_ctx.cancel()
        hold.set()
        t.join(WAIT)
        assert payload is not None
        assert payload["prompt_ids"] == list(src.engines()["tiny-llama"].tokenizer.encode(PROMPT))
        assert 0 < len(payload["tokens"]) < MAX_NEW
        assert payload["tokens"] == want.token_ids[:len(payload["tokens"])]
        assert payload["sampling"]["max_new_tokens"] == MAX_NEW

        streamed: list = []
        resp = dst.query_stream(Context.background(), Request(
            model="gpu:tiny-llama", prompt=PROMPT, max_tokens=MAX_NEW, trace_id="t-migrate",
            resume=json.loads(json.dumps(payload))), streamed.append)
        assert resp.content == want.text and resp.tokens == MAX_NEW
        assert "".join(streamed) == want.text
        snap = dst.batcher_stats()["tiny-llama"]
        assert snap["admitted"] == 1
    finally:
        src.release()
        dst.release()
