"""Three faults of the port held against the JAX package.

  * ``LLMC_MAX_SEQ``, ``LLMC_PREFILL_CHUNK`` and ``LLMC_STALL_GRACE`` reach
    the port's engines and runners through ``utils/knobs.py``, as the JAX
    CLI reads them: both CLIs build engines of the same capacity and
    prefill length, and abandon a stalled panel worker after the same
    grace.
  * A gateway request's trace id reaches the engine: the ``engine_stream``
    span and the batcher's journal entry carry it.
  * An idle pool whose queue head cannot sit next to the frontier of the
    wave's longest prompt still admits: the port re-plans the frontier from
    the head (a departure from the JAX batcher, which admits nothing, again
    and again), and every stream equals the JAX engine's single-stream
    greedy tokens in float32.
"""

from __future__ import annotations

import io
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.cli.main import main as port_main
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.providers import Response
from llm_consensus_tpu_torch.providers.gpu import GPUProvider

WAIT = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax(argv, factory=None):
    """The JAX CLI in this process with a fresh shared TPU provider;
    returns (rc, stdout, stderr, the provider it built or None)."""
    from llm_consensus_tpu.cli.main import main as jax_main
    from llm_consensus_tpu.providers.tpu import TPUProvider

    saved = TPUProvider._shared
    TPUProvider._shared = None
    try:
        stdout, stderr = io.StringIO(), io.StringIO()
        kw = {} if factory is None else {"factory": factory}
        rc = jax_main(argv, stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                      install_signal_handlers=False, **kw)
        built = TPUProvider._shared
    finally:
        TPUProvider._shared = saved
    return rc, stdout.getvalue(), stderr.getvalue(), built


def _run_port(argv, factory=None):
    stdout, stderr = io.StringIO(), io.StringIO()
    kw = {} if factory is None else {"factory": factory}
    rc = port_main(argv, device="cpu", stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                   install_signal_handlers=False, **kw)
    return rc, stdout.getvalue(), stderr.getvalue()


def test_max_seq_and_prefill_chunk_knobs_reach_both_clis(tmp_path, monkeypatch):
    """Under ``LLMC_MAX_SEQ=64`` and ``LLMC_PREFILL_CHUNK=0`` both CLIs
    build their tiny-llama engine with 64 slots and one-shot prefill (the
    port used the preset's 4,096 and 512 before it read the knobs)."""
    monkeypatch.setenv("LLMC_MAX_SEQ", "64")
    monkeypatch.setenv("LLMC_PREFILL_CHUNK", "0")
    monkeypatch.setenv("LLMC_LIVE", "0")
    for provider in GPUProvider._shared.values():
        provider.release()
    GPUProvider._shared.clear()
    seen = {}
    try:
        for scheme in ("tpu", "gpu"):
            argv = ["--models", f"{scheme}:tiny-llama", "--judge", f"{scheme}:tiny-llama",
                    "--max-tokens", "4", "--json", "--data-dir", str(tmp_path / scheme),
                    "what is consensus?"]
            if scheme == "tpu":
                rc, out, err, provider = _run_jax(argv)
            else:
                rc, out, err = _run_port(argv)
                (provider,) = GPUProvider._shared.values()
            assert rc == 0, err
            assert json.loads(out)["responses"][0]["tokens"] <= 4
            eng = provider.engines()["tiny-llama"] if scheme == "gpu" else (
                provider._engines["tiny-llama"])
            seen[scheme] = (eng.max_seq, eng.prefill_chunk)
    finally:
        for provider in GPUProvider._shared.values():
            provider.release()
        GPUProvider._shared.clear()
        obs.reset_planes()
    assert seen["gpu"] == seen["tpu"] == (64, 0)


def _stall_factory(response_cls, sleep_s):
    """A registry factory of fakes: ``stall`` sleeps ``sleep_s`` without
    cooperating (the wedge the watchdog catches), every other model answers."""
    from llm_consensus_tpu.providers.base import Provider as JaxProvider
    from llm_consensus_tpu_torch.providers import Provider

    base = JaxProvider if response_cls is JaxResponse else Provider

    class Fake(base):
        def query(self, ctx, req):
            if req.model == "stall":
                time.sleep(sleep_s)
            return response_cls(model=req.model, content=f"{req.model} says hi",
                                provider="fake")

        def query_stream(self, ctx, req, callback):
            resp = self.query(ctx, req)
            if callback is not None:
                callback(resp.content)
            return resp

    fake = Fake()
    return lambda model: fake


def test_stall_grace_knob_reaches_both_clis(tmp_path, monkeypatch):
    """Under ``LLMC_STALL_GRACE=0.3`` both CLIs abandon a wedged panel worker
    about 0.3 s past its 1 s deadline, with the same warning (the port
    waited its 5 s default before it read the knob)."""
    monkeypatch.setenv("LLMC_STALL_GRACE", "0.3")
    monkeypatch.setenv("LLMC_LIVE", "0")
    docs = {}
    try:
        for scheme, runner, resp_cls in (("tpu", _run_jax, JaxResponse),
                                         ("gpu", _run_port, Response)):
            argv = ["--models", "stall,good", "--judge", "good", "--timeout", "1", "--json",
                    "--data-dir", str(tmp_path / scheme), "q"]
            t0 = time.monotonic()
            out = runner(argv, factory=_stall_factory(resp_cls, 4.0))
            wall = time.monotonic() - t0
            assert out[0] == 0, out[2]
            assert wall < 3.0, (scheme, wall)
            docs[scheme] = json.loads(out[1])
    finally:
        obs.reset_planes()
    warnings = {s: d["warnings"] for s, d in docs.items()}
    shapes = {s: [re.sub(r"by \d+\.\d+s", "by Xs", w) for w in ws]
              for s, ws in warnings.items()}
    assert shapes["gpu"] == shapes["tpu"] == [
        "stall: worker exceeded its deadline by Xs without streaming; abandoned"]
    for ws in warnings.values():
        overdue = float(re.search(r"by (\d+\.\d+)s", ws[0]).group(1))
        assert 0.3 <= overdue < 1.0
    assert docs["gpu"]["failed_models"] == docs["tpu"]["failed_models"] == ["stall"]


# -- the admission livelock --------------------------------------------------------


def _gated(cls, engine, **kw):
    """A batcher whose scheduler waits on a gate: the submissions queued
    before it opens form one admission queue."""
    gate = threading.Event()
    real_loop = cls._loop

    def gated(self):
        gate.wait(timeout=WAIT)
        real_loop(self)

    cls._loop = gated
    try:
        b = cls(engine, **kw)
    finally:
        cls._loop = real_loop
    return b, gate


# Ten prompts of 19 to 119 tokens (BOS included); the head's 75 tokens
# cannot sit next to the 119-token frontier of the first wave in 160 slots:
# (119 - 75) + 128 > 160.
LENS = [75, 119, 19, 64, 97, 31, 108, 42, 86, 53]
PROMPTS = ["x" * (n - 1) for n in LENS]
MAX_NEW = 8


def test_idle_pool_admits_a_head_that_does_not_fit_the_longest_frontier():
    jcfg = jax_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    je = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=160, stream_interval=8)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"),
                           torch.device("cpu"), torch.float32)
    te = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, max_seq=160,
                stream_interval=8, device="cpu")
    assert [len(te.tokenizer.encode(p)) for p in PROMPTS] == LENS

    # The JAX pool admits nothing: every pass plans the same frontier.
    jb, gate = _gated(JaxBatcher, je, max_batch=4)
    try:
        futs = [jb.submit(p, JaxSampling(max_new_tokens=MAX_NEW, ignore_eos=True))
                for p in PROMPTS]
        gate.set()
        time.sleep(2.0)
        assert not any(f.done() for f in futs)
    finally:
        jb.close()

    # The port re-plans from the head and finishes every stream exactly.
    tb, gate = _gated(ContinuousBatcher, te, max_batch=4)
    try:
        futs = [tb.submit(p, SamplingParams(max_new_tokens=MAX_NEW, ignore_eos=True))
                for p in PROMPTS]
        gate.set()
        results = [f.result(timeout=WAIT) for f in futs]
    finally:
        tb.close()
    for p, r in zip(PROMPTS, results):
        want = je.generate(p, JaxSampling(max_new_tokens=MAX_NEW, ignore_eos=True))
        assert r.finish_reason == "length"
        assert r.token_ids == want.token_ids, len(p)


def test_a_head_that_fits_keeps_the_longest_frontier(monkeypatch):
    """A pass that admits today keeps its frontier: the re-plan runs only
    when the head cannot fit (the wave below plans from its longest row)."""
    te = Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=160, stream_interval=8,
                device="cpu")
    calls = []
    real = ContinuousBatcher._head_frontier

    def spy(self, candidates, wave_p):
        calls.append(len(candidates))
        return real(self, candidates, wave_p)

    monkeypatch.setattr(ContinuousBatcher, "_head_frontier", spy)
    tb, gate = _gated(ContinuousBatcher, te, max_batch=4)
    try:
        futs = [tb.submit("x" * (n - 1), SamplingParams(max_new_tokens=4, ignore_eos=True))
                for n in (119, 108, 97, 86)]
        gate.set()
        assert all(len(f.result(timeout=WAIT).token_ids) == 4 for f in futs)
    finally:
        tb.close()
    assert calls == []


# -- the trace id below the scheduler ----------------------------------------------


def test_gateway_trace_id_reaches_the_engine_span_and_the_journal(tmp_path):
    """A request's ``X-LLMC-Trace`` on the gateway reaches the runner's
    ``worker`` span, the provider's ``engine_stream`` span and the batcher's
    journal entry (its WAL header): the JAX gateway's path (the route CLI
    test holds both packages to it through ``serve``)."""
    import http.client
    import os

    from llm_consensus_tpu_torch import serve
    from llm_consensus_tpu_torch.providers import Registry
    from llm_consensus_tpu_torch.recovery import StreamJournal
    from llm_consensus_tpu_torch.recovery.journal import read_wal

    trace = "0123456789abcdef"
    rec = obs.Recorder()
    obs.reset_planes()
    obs.install(rec)
    wal = str(tmp_path / "wal")
    provider = GPUProvider(device="cpu", batch_streams=2, journal=StreamJournal(path=wal))
    registry = Registry()
    registry.register("gpu:tiny-llama", provider)
    gw = serve.build_gateway(registry, ["gpu:tiny-llama"], "gpu:tiny-llama", max_tokens=4,
                             data_dir=str(tmp_path / "data"), save=False,
                             pressure={"enabled": False})
    gw.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.address[1], timeout=WAIT)
        conn.request("POST", "/v1/consensus", json.dumps({"prompt": "trace me"}),
                     {"Content-Type": "application/json", "X-LLMC-Trace": trace})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
    finally:
        gw.close(drain=False)
        provider.release()
        obs.reset_planes()
    assert r.status == 200 and doc["trace_id"] == trace
    spans = {name: [e.args.get("trace") for e in rec.events() if e.ph == "X" and e.name == name]
             for name in ("worker", "engine_stream")}
    assert spans == {"worker": [trace], "engine_stream": [trace]}
    headers = [read_wal(os.path.join(wal, f))["header"] for f in sorted(os.listdir(wal))]
    assert [h["trace"] for h in headers] == [trace]
