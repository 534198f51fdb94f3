"""The GPU provider's retry ladder on the CPU (mirrors the engine-failure
cases of tests/test_tpu_provider.py): a failed generate gets one fresh
engine, a second failure or a failure after streaming fails the model (a
warning in the run), a failed build gets one more build, a refused or
cancelled batcher submission runs single-stream, and a kernel that failed
to build or launch propagates with no rebuild and no fallback."""

import threading
from concurrent.futures import Future

import pytest
import torch

from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError
from llm_consensus_tpu_torch.providers import Registry, Request
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.runner import Runner
from llm_consensus_tpu_torch.utils.context import Context

MODEL = "gpu:tiny-llama"
REQ = Request(model=MODEL, prompt="recover", max_tokens=4)


@pytest.fixture
def provider():
    p = GPUProvider(device="cpu", max_seq=128)
    yield p
    p.release()


class _FakeEngine:
    """What ``GPUProvider.release()`` calls on an engine."""

    def drop_prefix(self):
        pass

    def close_sessions(self):
        pass


class _Boom(_FakeEngine):
    """An engine whose every generate raises ``err`` (and counts)."""

    def __init__(self, err):
        self.err = err
        self.calls = 0

    def generate(self, *a, **k):
        self.calls += 1
        raise self.err


def test_engine_crash_is_contained_as_warning(provider, monkeypatch):
    """A panel model whose engine keeps failing is a failed model and a
    warning while its sibling answers (the runner's best-effort rule)."""
    panel = [MODEL, "gpu:tiny-qwen2"]
    real = provider._engine_for
    boom = _Boom(RuntimeError("out of memory on the card"))
    monkeypatch.setattr(provider, "_engine_for",
                        lambda m: boom if m == "gpu:tiny-qwen2" else real(m))
    registry = Registry()
    for m in panel:
        registry.register(m, provider)
    result = Runner(registry, timeout=300.0, max_tokens=6).run(
        Context.background(), panel, "isolation probe")
    assert [r.model for r in result.responses] == [MODEL]
    assert result.failed_models == ["gpu:tiny-qwen2"]
    assert any("out of memory on the card" in w for w in result.warnings)
    assert boom.calls == 2  # the first try and the one retry


@pytest.mark.parametrize("err", [
    RuntimeError("transient"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
], ids=["runtime", "oom"])
def test_transient_failure_recovers_with_a_fresh_engine(provider, err):
    real = provider._engine_for(MODEL)
    ref = provider.query(Context.background(), REQ)
    flaky = _Boom(err)
    provider._engines["tiny-llama"] = flaky
    resp = provider.query(Context.background(), REQ)
    assert resp.tokens == 4 and resp.content == ref.content
    assert flaky.calls == 1
    rebuilt = provider._engines["tiny-llama"]
    assert rebuilt is not flaky and rebuilt is not real


def test_failure_after_streaming_is_not_retried(provider):
    class StreamThenDie(_FakeEngine):
        calls = 0

        def generate(self, prompt, sampling, ctx, on_text=None):
            StreamThenDie.calls += 1
            if on_text is not None:
                on_text("partial ")
            raise RuntimeError("died mid-stream")

    provider._engines["tiny-llama"] = StreamThenDie()
    chunks = []
    with pytest.raises(RuntimeError, match="died mid-stream"):
        provider.query_stream(Context.background(), REQ, chunks.append)
    assert chunks == ["partial "]
    assert StreamThenDie.calls == 1


def test_engine_failure_retries_exactly_once(provider, monkeypatch):
    calls = {"n": 0}

    class AlwaysDies(_FakeEngine):
        def generate(self, *a, **k):
            calls["n"] += 1
            raise RuntimeError(f"persistent failure #{calls['n']}")

    provider._engines["tiny-llama"] = AlwaysDies()
    monkeypatch.setattr(provider, "_build_engine", lambda preset: AlwaysDies())
    with pytest.raises(RuntimeError, match="persistent failure #2"):
        provider.query(Context.background(), REQ)
    assert calls["n"] == 2


def test_failed_build_gets_one_more_build(provider, monkeypatch):
    real_build = provider._build_engine
    builds = {"n": 0}

    def flaky_build(preset):
        builds["n"] += 1
        if builds["n"] == 1:
            raise RuntimeError("allocation race during the build")
        return real_build(preset)

    monkeypatch.setattr(provider, "_build_engine", flaky_build)
    assert provider.query(Context.background(), REQ).tokens == 4
    assert builds["n"] == 2


@pytest.mark.parametrize("err", [KernelLaunchError("decode_bf16: launch failed"),
                                 KernelBuildError("nvcc failed")], ids=["launch", "build"])
def test_kernel_errors_propagate_with_no_rebuild(provider, monkeypatch, err):
    boom = _Boom(err)
    provider._engines["tiny-llama"] = boom
    builds = {"n": 0}
    monkeypatch.setattr(provider, "_build_engine",
                        lambda preset: builds.__setitem__("n", builds["n"] + 1))
    with pytest.raises(type(err)):
        provider.query(Context.background(), REQ)
    assert boom.calls == 1 and builds["n"] == 0
    assert provider._engines["tiny-llama"] is boom  # not evicted


def test_kernel_build_error_at_engine_build_is_not_retried(provider, monkeypatch):
    builds = {"n": 0}

    def build(preset):
        builds["n"] += 1
        raise KernelBuildError("nvcc failed")

    monkeypatch.setattr(provider, "_build_engine", build)
    with pytest.raises(KernelBuildError):
        provider.query(Context.background(), REQ)
    assert builds["n"] == 1


def test_request_value_error_is_not_retried(provider):
    boom = _Boom(ValueError("prompt length exceeds max sequence length"))
    provider._engines["tiny-llama"] = boom
    with pytest.raises(ValueError):
        provider.query(Context.background(), REQ)
    assert boom.calls == 1


# -- the batcher submission's fallback ----------------------------------------------------


@pytest.fixture
def batched():
    p = GPUProvider(device="cpu", max_seq=128, batch_streams=2)
    yield p
    p.release()


def _single_stream_ref():
    p = GPUProvider(device="cpu", max_seq=128)
    try:
        return p.query(Context.background(), REQ).content
    finally:
        p.release()


@pytest.mark.parametrize("how", ["closed", "refused", "cancelled"])
def test_batcher_submit_fallback_runs_single_stream(batched, monkeypatch, how):
    engine = batched._engine_for(MODEL)
    batcher = batched._batcher_for("tiny-llama", engine)
    if how == "closed":
        batcher.close()  # submit raises RuntimeError("batcher is closed")
    elif how == "refused":
        monkeypatch.setattr(batcher, "submit",
                            lambda *a, **k: (_ for _ in ()).throw(ValueError("sampling")))
    else:
        def cancelled(*a, **k):
            fut = Future()
            fut.cancel()
            return fut

        monkeypatch.setattr(batcher, "submit", cancelled)
    calls = {"n": 0}
    real_generate = engine.generate

    def counted(*a, **k):
        calls["n"] += 1
        return real_generate(*a, **k)

    monkeypatch.setattr(engine, "generate", counted)
    assert batched.query(Context.background(), REQ).content == _single_stream_ref()
    assert calls["n"] == 1


@pytest.mark.parametrize("err", [KernelLaunchError("launch failed"),
                                 KernelBuildError("nvcc failed")], ids=["launch", "build"])
def test_batcher_submit_kernel_error_propagates(batched, monkeypatch, err):
    engine = batched._engine_for(MODEL)
    batcher = batched._batcher_for("tiny-llama", engine)

    def submit(*a, **k):
        raise err

    monkeypatch.setattr(batcher, "submit", submit)
    generate = _Boom(RuntimeError("must not run"))
    monkeypatch.setattr(engine, "generate", generate.generate)
    with pytest.raises(type(err)):
        batched.query(Context.background(), REQ)
    assert generate.calls == 0
    assert batched._engines["tiny-llama"] is engine


def test_batched_failure_rebuilds_engine_and_batcher(batched, monkeypatch):
    """A failed batched generate evicts the engine with its batcher (closed),
    and the retry runs on a fresh pair."""
    engine = batched._engine_for(MODEL)
    batcher = batched._batcher_for("tiny-llama", engine)

    def failing(*a, **k):
        fut = Future()
        fut.set_exception(RuntimeError("pool died"))
        return fut

    monkeypatch.setattr(batcher, "submit", failing)
    assert batched.query(Context.background(), REQ).content == _single_stream_ref()
    assert batched._engines["tiny-llama"] is not engine
    assert batched._batchers["tiny-llama"] is not batcher
    assert isinstance(batched._batchers["tiny-llama"], ContinuousBatcher)
    with pytest.raises(RuntimeError, match="closed"):
        ContinuousBatcher.submit(batcher, "x")


def test_release_drops_snapshots_and_sessions(provider):
    engine = provider._engine_for(MODEL)
    provider.query(Context.background(), Request(model=MODEL, prompt="x " * 40, max_tokens=4))
    assert engine._prefix_cache is not None
    session = engine.prefill_session()
    session.append_text("an open judge session")
    provider.release()
    assert engine._prefix_cache is None and engine._prefix_ids is None
    assert session.closed
    with pytest.raises(RuntimeError, match="consumed"):
        session.append([1, 2, 3])
    assert provider.engines() == {}


def test_concurrent_failures_share_one_rebuild_each(provider):
    """Two panel threads failing on one engine each rebuild at most once and
    both answer."""
    provider._engine_for(MODEL)
    provider._engines["tiny-llama"] = _Boom(RuntimeError("transient"))
    out, errors = [], []

    def worker():
        try:
            out.append(provider.query(Context.background(), REQ).content)
        except Exception as err:  # noqa: BLE001
            errors.append(err)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(out) == 2 and out[0] == out[1]
