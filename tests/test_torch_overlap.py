"""The port's incremental judge prefill (``PrefillSession`` and
consensus/overlap.py) against the one-shot paths and the JAX package's
(mirrors the session and judge-shim cases of tests/test_overlap.py; its
interleaved-admission cases belong to the batcher's budgeted admission,
which is not ported).

Session logits agree with the one-shot prefill within rtol/atol 2e-4 (the
growing attention widths sum in other orders), its tokens equal the
one-shot generate's and the JAX session's on the same float32 weights. The
overlap judge's text equals the classic judge's, and every condition it
cannot honor falls back to the classic path, except a fault of the card,
which surfaces from ``synthesize_stream``."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch.consensus import (
    Judge, NoResponsesError, make_overlap_judge, render_judge_prompt)
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.ops.kernels.build import KernelLaunchError
from llm_consensus_tpu_torch.providers import ProviderFunc, Registry, Response
from llm_consensus_tpu_torch.runner import Callbacks, Runner
from llm_consensus_tpu_torch.utils.context import Context


def _weights(seed):
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"),
                           torch.device("cpu"), torch.float32)
    return jp, tp


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's engine on the same float32 weights, the JAX
    test file's settings (max_seq 256, stream_interval 8, chunk 16)."""
    jp, tp = _weights(0)
    kw = dict(max_seq=256, stream_interval=8, prefill_chunk=16)
    return (JaxEngine(jax_config("tiny-llama"), params=jp, dtype=jnp.float32, **kw),
            Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu", **kw))


# -- the session ------------------------------------------------------------------------


def test_session_logits_match_one_shot(pair):
    _, engine = pair
    ids = list(engine.tokenizer.encode("parity probe " * 8))[:48]  # 3 chunks
    with torch.inference_mode():
        ll_ref, _ = engine._prefill_ids(list(ids))
    sess = engine.prefill_session()
    sess.append(ids[:10])
    sess.append(ids[10:33])
    sess.append(ids[33:])
    sess.sync()
    assert sess.prefilled == 48 and sess.tokens == 48
    np.testing.assert_allclose(sess._last_logits.numpy(), ll_ref.numpy(), rtol=2e-4, atol=2e-4)


def test_session_generate_matches_one_shot_and_jax(pair):
    je, engine = pair
    ids = list(engine.tokenizer.encode("session decode parity prompt, with some length to it"))
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    ref = Engine(engine.cfg, params=engine.params, dtype=torch.float32, max_seq=256,
                 stream_interval=8, prefill_chunk=16, device="cpu",
                 prefix_cache=False).generate_ids(list(ids), s)
    sess = engine.prefill_session()
    for i in range(0, len(ids), 13):
        sess.append(ids[i:i + 13])
    got = sess.generate(s)
    assert got.token_ids == ref.token_ids
    assert got.text == ref.text
    assert got.prompt_tokens == len(ids)
    jsess = je.prefill_session()
    for i in range(0, len(ids), 13):
        jsess.append(ids[i:i + 13])
    assert jsess.generate(JaxSampling(max_new_tokens=16, ignore_eos=True)).token_ids == \
        got.token_ids
    with pytest.raises(RuntimeError):
        sess.generate(s)  # single use


def test_session_append_text_keeps_one_bos(pair):
    _, engine = pair
    sess = engine.prefill_session()
    sess.append_text("first piece ")
    sess.append_text("second piece ")
    sess.append_text("third")
    assert sess._ids == list(engine.tokenizer.encode("first piece second piece third"))
    assert sess._ids.count(engine.tokenizer.bos_id) == 1
    sess.close()


def test_session_overflow_flags(pair):
    _, engine = pair
    sess = engine.prefill_session()
    sess.append([1] * (engine.max_seq + 5))
    assert sess.overflowed and sess.prefilled == 0
    with pytest.raises(ValueError):
        sess.generate(SamplingParams(max_new_tokens=4, ignore_eos=True))


def test_session_capacity_not_a_chunk_multiple():
    """max_seq 72, chunk 16: a prompt whose final padded chunk would end
    past capacity overflows; chunk-covered lengths still run."""
    _, tp = _weights(0)
    eng = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, max_seq=72,
                 stream_interval=8, prefill_chunk=16, device="cpu")
    sess = eng.prefill_session()
    sess.append([1] * 70)  # ceil(70/16)*16 = 80 > 72
    assert sess.overflowed
    ok = eng.prefill_session()
    ok.append([1] * 60)  # 64 <= 72
    assert not ok.overflowed
    assert len(ok.generate(SamplingParams(max_new_tokens=4, ignore_eos=True)).token_ids) == 4


def test_session_leaves_the_snapshot_alone_until_it_generates(pair):
    """A session on an engine that also serves generates never reads or
    writes the engine's prefix snapshot; its own generate retains."""
    _, engine = pair
    s = SamplingParams(max_new_tokens=6, ignore_eos=True)
    engine.generate("a panel answer prompt " * 4, s)
    snap_ids, snap = engine._prefix_ids, engine._prefix_cache
    before = snap["k"].clone()
    sess = engine.prefill_session()
    sess.append_text("the judge header " * 6)
    assert engine._prefix_ids == snap_ids and torch.equal(snap["k"], before)
    got = sess.generate(s)
    assert engine._prefix_ids == tuple(sess._ids + got.token_ids)[:len(engine._prefix_ids)]
    assert engine._prefix_cache is not snap


# -- the judge shim ----------------------------------------------------------------------


class _EngineProvider:
    """A provider over one float32 engine: the shim's engine hook and the
    classic query path its fallback takes; ``queries`` counts the latter."""

    name = "gpu"

    def __init__(self, engine):
        self._engine = engine
        self.stats = {"tokens": 0, "runs": 0}
        self._lock = threading.Lock()
        self.queries = 0

    def _engine_for(self, model):
        return self._engine

    def query(self, ctx, req):
        return self.query_stream(ctx, req, None)

    def query_stream(self, ctx, req, callback):
        self.queries += 1
        s = SamplingParams(max_new_tokens=req.max_tokens or 64, temperature=0.0)
        result = self._engine.generate(req.prompt, s, ctx, on_text=callback)
        return Response(model=req.model, content=result.text, provider=self.name,
                        truncated=result.truncated_prompt)


@pytest.fixture(scope="module")
def judge_weights():
    return _weights(1)


@pytest.fixture
def provider(judge_weights):
    eng = Engine(get_config("tiny-llama"), params=judge_weights[1], dtype=torch.float32,
                 max_seq=2048, stream_interval=8, prefill_chunk=64, device="cpu")
    return _EngineProvider(eng)


PROMPT = "judge overlap probe prompt"
RESP_A = Response(model="model-a", content="alpha answer text", provider="t")
RESP_B = Response(model="model-b", content="beta answer, different", provider="t")


def _classic(provider, prompt, responses):
    return Judge(provider, "gpu:tiny-llama", max_tokens=8).synthesize_stream(
        Context.background(), prompt, responses, None)


def test_flag_off_is_classic(monkeypatch, provider):
    monkeypatch.delenv("LLMC_JUDGE_OVERLAP", raising=False)
    assert make_overlap_judge(provider, "gpu:tiny-llama", PROMPT) is None
    assert make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, enabled=True) is not None
    http = ProviderFunc(lambda ctx, req: Response(model=req.model, content="x", provider="f"))
    assert make_overlap_judge(http, "m", PROMPT, enabled=True) is None
    monkeypatch.setenv("LLMC_JUDGE_OVERLAP", "1")
    assert make_overlap_judge(provider, "gpu:tiny-llama", PROMPT) is not None
    assert make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, enabled=False) is None


def test_out_of_order_arrival_matches_classic_and_jax(provider, judge_weights):
    """Answers arriving out of panel order: the arrival order becomes the
    judge prompt's, and the text equals the classic path's for that order
    and the JAX overlap judge's on the same weights."""
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    ov.on_response(RESP_B)
    ov.on_response(RESP_A)
    assert [r.model for r in ov.arrival_order] == ["model-b", "model-a"]
    chunks: list = []
    out = ov.synthesize_stream(Context.background(), PROMPT, [RESP_B, RESP_A], chunks.append)
    assert out and out == "".join(chunks)
    assert ov.fallbacks == 0 and ov.prefilled > 0 and provider.queries == 0
    assert out == _classic(provider, PROMPT, [RESP_B, RESP_A])

    from llm_consensus_tpu.consensus import make_overlap_judge as jax_make
    from llm_consensus_tpu.providers.base import Response as JaxResponse

    class _JaxProvider:
        _ignore_eos = False

        def __init__(self):
            self._engine = JaxEngine(jax_config("tiny-llama"), params=judge_weights[0],
                                     dtype=jnp.float32, max_seq=2048, stream_interval=8,
                                     prefill_chunk=64)

        def _engine_for(self, model):
            return self._engine

    jov = jax_make(_JaxProvider(), "tpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    jb, ja = (JaxResponse(r.model, r.content, r.provider) for r in (RESP_B, RESP_A))
    jov.on_response(jb)
    jov.on_response(ja)
    assert jov.synthesize_stream(Context.background(), PROMPT, [jb, ja], None) == out


def test_order_mismatch_falls_back(provider):
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    ov.on_response(RESP_B)
    ov.on_response(RESP_A)
    out = ov.synthesize_stream(Context.background(), PROMPT, [RESP_A, RESP_B], None)
    assert ov.fallbacks == 1
    assert out == _classic(provider, PROMPT, [RESP_A, RESP_B])


def test_single_response_shortcut(provider):
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    ov.on_response(RESP_A)
    chunks: list = []
    out = ov.synthesize_stream(Context.background(), PROMPT, [RESP_A], chunks.append)
    assert out == RESP_A.content and chunks == [RESP_A.content]
    assert provider.queries == 0
    with pytest.raises(NoResponsesError):
        ov.synthesize_stream(Context.background(), PROMPT, [], None)


def test_unfed_falls_back_classic(provider):
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    out = ov.synthesize_stream(Context.background(), PROMPT, [RESP_A, RESP_B], None)
    assert ov.fallbacks == 1
    assert out == _classic(provider, PROMPT, [RESP_A, RESP_B])


def test_refine_prompt_falls_back(provider):
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    ov.on_response(RESP_A)
    ov.on_response(RESP_B)
    other = "a different (refine-round) prompt"
    out = ov.synthesize_stream(Context.background(), other, [RESP_A, RESP_B], None)
    assert ov.fallbacks == 1
    assert out == _classic(provider, other, [RESP_A, RESP_B])


def test_runner_feeds_arrival_order(provider):
    """The runner's on_model_response hook feeds the shim in completion
    order, and synthesis consumes the fed session."""
    reg = Registry()
    reg.register("fast", ProviderFunc(lambda ctx, req: Response(
        model=req.model, content="fast answer", provider="fake")))

    def slow(ctx, req):
        time.sleep(0.3)
        return Response(model=req.model, content="slow answer", provider="fake")

    reg.register("slow", ProviderFunc(slow))
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    runner = Runner(reg, timeout=30.0).with_callbacks(Callbacks(on_model_response=ov.on_response))
    result = runner.run(Context.background(), ["slow", "fast"], PROMPT)
    assert [r.model for r in ov.arrival_order] == ["fast", "slow"]
    out = ov.synthesize_stream(Context.background(), PROMPT, result.responses, None)
    assert out and ov.fallbacks == 0
    assert out == _classic(provider, PROMPT, list(ov.arrival_order))


def test_kernel_error_in_on_response_surfaces_at_synthesis(provider, monkeypatch):
    """A kernel that fails to launch while an answer appends is a fault of
    the card, not a failed optimization: synthesis raises it and the
    classic path never runs."""
    def boom(*a, **k):
        raise KernelLaunchError("decode_bf16_kernel: launch failed (an illegal address)")

    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    monkeypatch.setattr(provider._engine, "_prefill_chunk", boom)
    ov.on_response(RESP_A)  # the hook itself never raises
    ov.on_response(RESP_B)
    with pytest.raises(RuntimeError, match="illegal address") as err:
        ov.synthesize_stream(Context.background(), PROMPT, [RESP_A, RESP_B], None)
    assert isinstance(err.value.__cause__, KernelLaunchError)
    assert provider.queries == 0 and ov.fallbacks == 0


def test_kernel_error_in_session_generate_propagates(provider, monkeypatch):
    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    ov.on_response(RESP_A)
    ov.on_response(RESP_B)

    def boom(*a, **k):
        raise KernelLaunchError("decode kernel launch failed")

    monkeypatch.setattr(provider._engine, "_decode_stream", boom)
    with pytest.raises(RuntimeError, match="decode kernel launch failed"):
        ov.synthesize_stream(Context.background(), PROMPT, [RESP_A, RESP_B], None)
    assert provider.queries == 0 and ov.fallbacks == 0


def test_out_of_memory_in_on_response_falls_back(provider, monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    ov = make_overlap_judge(provider, "gpu:tiny-llama", PROMPT, max_tokens=8, enabled=True)
    with monkeypatch.context() as mp:
        mp.setattr(provider._engine, "_prefill_chunk", oom)
        ov.on_response(RESP_A)
    ov.on_response(RESP_B)
    out = ov.synthesize_stream(Context.background(), PROMPT, [RESP_A, RESP_B], None)
    assert ov.fallbacks == 1 and provider.queries == 1
    assert out == _classic(provider, PROMPT, [RESP_A, RESP_B])


def test_render_judge_prompt_block_contract():
    p = render_judge_prompt("q", [RESP_A])
    assert "\n--- Model: model-a | Provider: t ---\nalpha answer text\n" in p
