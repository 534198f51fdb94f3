"""The port's fault injection (llm_consensus_tpu_torch/faults/) against the
JAX package's (mirrors tests/test_faults.py).

Three layers, as in the reference file: the plan's mechanics (grammar,
counter and attribute matching, kinds only at their site, ``times``, the
seeded probability draws) held equal to the JAX plan's, down to the trace
bytes of the same spec, seed and fire sequence; the injector sites of the
engine, the provider's build, the batcher's admission, the SSE loop and the
runner, each absorbed by the port's real recovery machinery; and no plan
without an install.
"""

import time

import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.faults import FaultPlan, InjectedFault, parse_spec
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.providers import Request
from llm_consensus_tpu_torch.providers.base import ProviderFunc, Response
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.providers.registry import Registry
from llm_consensus_tpu_torch.runner import Runner
from llm_consensus_tpu_torch.utils.context import Context
from tests.test_torch_http_providers import FakeAPI, fake_api  # noqa: F401 — the fixture

PLANS = {"port": FaultPlan, "jax": jax_faults.FaultPlan}


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """Every test starts and ends with no fault plan, integrity plane or
    recorder installed, in either package (they are process-wide)."""
    monkeypatch.delenv("LLMC_FAULTS", raising=False)
    for mod in (faults, integrity, jax_faults):
        mod.reset()
    obs.reset()
    yield
    for mod in (faults, integrity, jax_faults):
        mod.reset()
    obs.reset()


# -- plan mechanics, each held to the JAX plan ------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_parse_spec_grammar(pkg):
    parse = parse_spec if pkg == "port" else jax_faults.parse_spec
    specs = parse("prefill_oom@step=3,controller_drop@host=1,sse_reset@chunk=2")
    assert [s.kind for s in specs] == ["prefill_oom", "controller_drop", "sse_reset"]
    assert specs[0].args == {"step": "3"}
    assert specs[1].args == {"host": "1"}
    assert specs[2].args == {"chunk": "2"}
    assert all(s.times == 1 for s in specs)


def test_parse_spec_rejects_what_jax_rejects():
    for bad in ("meteor_strike@step=1", "crash@chunk"):
        with pytest.raises(ValueError) as ours:
            parse_spec(bad)
        with pytest.raises(ValueError) as theirs:
            jax_faults.parse_spec(bad)
        assert str(ours.value) == str(theirs.value)


def test_site_table_is_the_jax_one():
    assert faults.SITE_KINDS == jax_faults.SITE_KINDS


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_counter_matching_is_one_indexed(pkg):
    plan = PLANS[pkg]("decode_fault@step=3")
    assert plan.fire("decode") is None
    assert plan.fire("decode") is None
    assert plan.fire("decode") is not None  # the 3rd dispatch
    assert plan.fire("decode") is None  # times=1 exhausted


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_attribute_matching(pkg):
    plan = PLANS[pkg]("worker_stall@model=slow")
    assert plan.fire("runner", model="fast") is None
    assert plan.fire("runner", model="slow") is not None


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_kinds_only_fire_at_their_site(pkg):
    plan = PLANS[pkg]("prefill_oom@step=1")
    assert plan.fire("decode") is None
    assert plan.fire("sse") is None
    assert plan.fire("prefill") is not None


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_times_caps_fires(pkg):
    plan = PLANS[pkg]("decode_fault@times=2")
    assert plan.fire("decode") is not None
    assert plan.fire("decode") is not None
    assert plan.fire("decode") is None


def _drive(plan) -> bytes:
    for i in range(64):
        plan.fire("decode", step=i)
    plan.fire("prefill")
    plan.fire("prefill")
    plan.fire("runner", model="m")
    plan.fire("engine", model="tiny-llama")
    plan.fire("corrupt", surface="logits", model="tiny-llama")
    return plan.trace_bytes()


def test_same_seed_same_spec_byte_identical_sequence():
    spec = "decode_fault@p=0.5@times=-1,prefill_oom@step=2"
    a = _drive(FaultPlan(spec, seed=1234))
    assert a == _drive(FaultPlan(spec, seed=1234))  # byte-identical
    assert a != _drive(FaultPlan(spec, seed=4321))  # the draws depend on the seed


@pytest.mark.parametrize("spec,seed", [
    ("decode_fault@p=0.5@times=-1,prefill_oom@step=2", 1234),
    ("decode_fault@p=0.3@times=3,worker_stall@model=m@p=0.9", 7),
    ("crash@chunk=2,nan_logits@row=1,prefill_oom@p=0.5", 99),
    ("wedge@model=tiny-llama@s=30,bit_flip@surface=wal@p=0.5@times=-1", 0),
])
def test_trace_bytes_equal_the_jax_plans(spec, seed):
    """The same spec, seed and fire sequence give the JAX plan's trace
    bytes exactly (the seeded draws are the same random.Random stream)."""
    assert _drive(FaultPlan(spec, seed=seed)) == _drive(jax_faults.FaultPlan(spec, seed=seed))


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_probability_draw_is_order_independent(pkg):
    """``p=`` draws only when every other qualifier matched, wherever it
    sits in the spec, so unrelated dispatches cannot shift later draws."""
    def drive(spec: str) -> list:
        plan = PLANS[pkg](spec + ",decode_fault@p=0.5@times=-1", seed=5)
        fired = []
        for _ in range(32):
            plan.fire("prefill", model="other")  # never matches model=x
            fs = plan.fire("decode")
            fired.append(fs.kind if fs else "-")
        return fired

    assert drive("prefill_oom@p=0.5@model=x") == drive("prefill_oom@model=x@p=0.5")


def test_fire_lands_on_the_recorder():
    rec = obs.Recorder()
    obs.install(rec)
    FaultPlan("crash@chunk=1").fire("engine", model="tiny-llama")
    (ev,) = [e for e in rec.events() if e.name == "fault:crash"]
    assert ev.tid == "faults" and ev.args["site"] == "engine" and ev.args["n"] == 1


def test_no_plan_without_an_install(monkeypatch):
    # The port reads no environment: only the CLI installs from LLMC_FAULTS.
    monkeypatch.setenv("LLMC_FAULTS", "decode_fault@step=1")
    assert faults.plan() is None
    plan = FaultPlan("decode_fault@step=1", seed=99)
    faults.install(plan)
    assert faults.plan() is plan and plan.seed == 99
    faults.reset()
    assert faults.plan() is None


# -- engine sites ---------------------------------------------------------------------------


def _tiny_engine():
    return Engine(get_config("tiny-llama"), stream_interval=4, max_seq=128, device="cpu",
                  dtype=torch.float32)


def test_engine_binds_no_plan_when_disabled():
    assert _tiny_engine()._faults is None  # one None check per dispatch


def test_injected_prefill_oom_fails_then_clears():
    faults.install(FaultPlan("prefill_oom@step=1"))
    eng = _tiny_engine()
    with pytest.raises(InjectedFault, match="prefill_oom"):
        eng.generate("boom", SamplingParams(max_new_tokens=2, ignore_eos=True))
    # times=1: the very next generate prefills cleanly.
    out = eng.generate("fine now", SamplingParams(max_new_tokens=2, ignore_eos=True))
    assert len(out.token_ids) == 2


def test_injected_decode_fault():
    faults.install(FaultPlan("decode_fault@step=1"))
    eng = _tiny_engine()
    with pytest.raises(InjectedFault, match="decode_fault"):
        eng.generate("boom", SamplingParams(max_new_tokens=8, ignore_eos=True))


def test_engine_sites_fire_like_the_jax_engines():
    """One generate on each package's engine under a plan that never fires:
    the same sites in the same order (one prefill, one decode check per
    chunk), so the trace bytes are equal."""
    from llm_consensus_tpu.engine import Engine as JaxEngine
    from llm_consensus_tpu.engine import SamplingParams as JaxSampling
    from llm_consensus_tpu.models import get_config as jax_config

    spec = "decode_fault@step=999,prefill_oom@step=999"
    faults.install(FaultPlan(spec))
    _tiny_engine().generate("site order probe", SamplingParams(max_new_tokens=13,
                                                                ignore_eos=True))
    jax_faults.install(jax_faults.FaultPlan(spec))
    JaxEngine(jax_config("tiny-llama"), stream_interval=4, max_seq=128).generate(
        "site order probe", JaxSampling(max_new_tokens=13, ignore_eos=True))
    ours, theirs = faults.plan().trace_bytes(), jax_faults.plan().trace_bytes()
    assert ours == theirs
    assert ours.count(b"prefill#") == 1 and ours.count(b"decode#") >= 3


def test_provider_ladder_absorbs_an_injected_prefill_oom():
    """The evict, rebuild and retry ladder absorbs one injected prefill OOM:
    the query still answers."""
    faults.install(FaultPlan("prefill_oom@step=1"))
    provider = GPUProvider(device="cpu", max_seq=128, ignore_eos=True, stream_interval=4)
    try:
        resp = provider.query(Context.background(),
                              Request(model="gpu:tiny-llama", prompt="recover", max_tokens=2))
    finally:
        provider.release()
    assert resp.tokens == 2
    assert any(ln.endswith("->prefill_oom") for ln in faults.plan().trace)


def test_injected_build_fail_rides_the_ladder():
    """build_fail on the first construction: the second build serves."""
    faults.install(FaultPlan("build_fail@preset=tiny-llama"))
    provider = GPUProvider(device="cpu", max_seq=128, ignore_eos=True, stream_interval=4)
    try:
        resp = provider.query(Context.background(),
                              Request(model="gpu:tiny-llama", prompt="rebuild", max_tokens=2))
    finally:
        provider.release()
    assert resp.tokens == 2
    assert faults.plan().trace[:2] == ["build#1[preset=tiny-llama]->build_fail",
                                       "build#2[preset=tiny-llama]->-"]


def test_batcher_books_admit_time_for_failed_prefill():
    """A failed admission prefill fails THAT stream and still counts its
    host wall toward admit_s."""
    # times=2: the batched wave and the one-by-one fallback both die.
    faults.install(FaultPlan("prefill_oom@times=2"))
    batcher = ContinuousBatcher(_tiny_engine(), max_batch=2)
    try:
        fut = batcher.submit("doomed", SamplingParams(max_new_tokens=2, ignore_eos=True))
        with pytest.raises(InjectedFault):
            fut.result(timeout=60)
        deadline = time.monotonic() + 10
        while batcher.snapshot()["admit_s"] == 0.0:
            assert time.monotonic() < deadline, "admit_s never booked"
            time.sleep(0.01)
    finally:
        batcher.close()


# -- SSE site ---------------------------------------------------------------------------------


def test_sse_reset_injector_unit():
    plan = FaultPlan("sse_reset@chunk=2")
    assert plan.fire("sse") is None
    assert plan.fire("sse") is not None


def test_sse_reset_is_a_retried_transient(fake_api):  # noqa: F811 — the fixture
    """sse_reset@chunk=1 resets the first data event before it reaches the
    caller, so the stream retries and the answer is whole; at chunk 2 the
    first chunk was delivered and the reset fails the stream."""
    from llm_consensus_tpu_torch.providers.http_sse import (
        TransientHTTPError, stream_json_events)

    FakeAPI.respond = lambda path, body: (200, [
        'data: {"t": "a"}', 'data: {"t": "b"}', "data: [DONE]"])

    def run():
        chunks = []
        text = stream_json_events(Context.background(), fake_api + "/v1", {}, {},
                                  lambda e: e.get("t"), chunks.append, retries=2, backoff=0.0)
        return text, chunks

    faults.install(FaultPlan("sse_reset@chunk=1"))
    assert run() == ("ab", ["a", "b"])
    assert len(FakeAPI.requests) == 2
    faults.install(FaultPlan("sse_reset@chunk=2"))
    with pytest.raises(TransientHTTPError, match="injected mid-stream reset"):
        run()


# -- runner site ----------------------------------------------------------------------------


def _fake(content: str = "answer"):
    return ProviderFunc(lambda ctx, req: Response(model=req.model, content=content,
                                                  provider="fake"))


def test_worker_stall_watchdog_abandons_without_blocking_join():
    faults.install(FaultPlan("worker_stall@model=stuck@s=5"))
    reg = Registry()
    reg.register("alive", _fake())
    reg.register("stuck", _fake())
    runner = Runner(reg, timeout=0.2, stall_grace=0.2)
    t0 = time.monotonic()
    result = runner.run(Context.background(), ["alive", "stuck"], "q")
    wall = time.monotonic() - t0
    assert wall < 4.0, f"join blocked on the stalled worker ({wall:.1f}s)"
    assert [r.model for r in result.responses] == ["alive"]
    assert result.failed_models == ["stuck"]
    assert any("abandoned" in w for w in result.warnings)


def test_duplicate_model_stall_does_not_conflate_workers():
    """Watchdog state is per worker: with one model twice and ONE worker
    stalled (times=1), the other duplicate's response survives."""
    faults.install(FaultPlan("worker_stall@model=m@s=5"))
    reg = Registry()
    reg.register("m", _fake())
    runner = Runner(reg, timeout=0.2, stall_grace=0.2)
    result = runner.run(Context.background(), ["m", "m"], "q")
    assert [r.model for r in result.responses] == ["m"]
    assert result.failed_models == ["m"]
    assert sum("abandoned" in w for w in result.warnings) == 1


def test_streaming_worker_is_not_declared_stalled():
    """A worker past its deadline but still streaming gets grace from its
    last activity: slow but alive is not stalled."""
    from llm_consensus_tpu_torch.providers.base import Provider

    class SlowStreamer(Provider):
        name = "slow"

        def query(self, ctx, req):
            return self.query_stream(ctx, req, None)

        def query_stream(self, ctx, req, callback):
            for _ in range(6):
                time.sleep(0.1)
                if callback is not None:
                    callback("chunk ")
            return Response(model=req.model, content="done", provider="fake")

    reg = Registry()
    reg.register("slow", SlowStreamer())
    result = Runner(reg, timeout=0.2, stall_grace=0.3).run(Context.background(), ["slow"], "q")
    assert [r.model for r in result.responses] == ["slow"]
    assert result.failed_models == []
