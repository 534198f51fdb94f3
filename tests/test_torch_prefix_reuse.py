"""The port's prefix snapshot reuse against the JAX engine's (mirrors the
prefix-reuse cases of tests/test_engine.py): reuse must be invisible, so
every case's greedy tokens equal a fresh port engine's exactly and, on the
same float32 weights, the JAX engine's after the same sequence of
generates (tiny-llama, max_seq 256, prefill_chunk 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine import engine as engine_mod
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy

WAIT = 300
CHUNK = 16
SHARED = "the quick brown fox jumps over the lazy dog " * 2  # 88 ids


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"),
                           torch.device("cpu"), torch.float32)
    return jp, tp


def _port(weights, **kw):
    kw.setdefault("prefill_chunk", CHUNK)
    return Engine(get_config("tiny-llama"), params=weights[1], dtype=torch.float32,
                  max_seq=256, device="cpu", **kw)


def _jax(weights, **kw):
    kw.setdefault("prefill_chunk", CHUNK)
    return JaxEngine(jax_config("tiny-llama"), params=weights[0], dtype=jnp.float32,
                     max_seq=256, **kw)


def _both(weights, prompts, n=10, **kw):
    """Greedy tokens of each prompt in turn on one port engine (reusing), one
    JAX engine (reusing) and a fresh port engine per prompt."""
    te, je = _port(weights, **kw), _jax(weights, **kw)
    out = []
    for p in prompts:
        got = te.generate(p, SamplingParams(max_new_tokens=n, ignore_eos=True)).token_ids
        ref = je.generate(p, JaxSampling(max_new_tokens=n, ignore_eos=True)).token_ids
        fresh = _port(weights, prefix_cache=False, **kw).generate(
            p, SamplingParams(max_new_tokens=n, ignore_eos=True)).token_ids
        out.append((got, ref, fresh))
    return te, out


def _assert_exact(out):
    for got, ref, fresh in out:
        assert got == fresh == ref


def test_reuse_of_an_extended_prompt(weights):
    te, out = _both(weights, [SHARED, SHARED + "and then some more text."])
    _assert_exact(out)
    assert te._prefix_ids is not None


def test_divergent_prompt_is_unaffected(weights):
    _, out = _both(weights, ["a" * 80, "completely different prompt with other words " * 2])
    _assert_exact(out)


def test_repeated_prompt_three_times(weights):
    """The snapshot is only read: the second and third reuse of one
    snapshot decode from the same KV as the first."""
    prompt = "judge this panel of answers carefully " * 3
    _, out = _both(weights, [prompt] * 3)
    _assert_exact(out)
    assert out[0][0] == out[1][0] == out[2][0]


def test_reuse_with_the_int8_cache(weights):
    shared = "shared conversation context for every round " * 2
    _, out = _both(weights, [shared, shared + "now critique the draft."], n=8,
                   kv_quant="int8")
    _assert_exact(out)


def test_disabled_keeps_no_snapshot(weights, monkeypatch):
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")
    te, je = _port(weights, prefix_cache=False), _jax(weights)
    assert not te.prefix_cache_enabled and not je.prefix_cache_enabled
    te.generate("hello", SamplingParams(max_new_tokens=4, ignore_eos=True))
    je.generate("hello", JaxSampling(max_new_tokens=4, ignore_eos=True))
    assert te._prefix_cache is None and je._prefix_cache is None


def test_snapshot_over_the_cap_is_not_kept(weights, monkeypatch):
    monkeypatch.setenv("LLMC_PREFIX_CACHE_MAX_MB", "0.000001")
    te, je = _port(weights, prefix_cache_max_mb=0.000001), _jax(weights)
    te.generate("hello", SamplingParams(max_new_tokens=4, ignore_eos=True))
    je.generate("hello", JaxSampling(max_new_tokens=4, ignore_eos=True))
    assert te._prefix_cache is None and je._prefix_cache is None


def test_chunking_off_disables_reuse(weights):
    prompt = "one shot prefill only " * 4
    te, out = _both(weights, [prompt, prompt + "more"], n=6, prefill_chunk=0)
    _assert_exact(out)
    assert not te.prefix_cache_enabled
    assert te._reusable_prefix(te.tokenizer.encode(prompt + "more")) == (0, None)


@pytest.mark.parametrize("n", [12, 17])
def test_reuse_covers_the_generated_continuation(weights, n):
    """The snapshot holds the prompt and the generated ids, so a follow-up
    extending prompt + answer reuses past the old prompt. At n = 17 (one
    more than a 16-step chunk) the last emitted id was never fed back, so
    its KV was never written: the port keeps it out of the snapshot's ids
    (the JAX engine's snapshot claims it)."""
    te = _port(weights)
    s = SamplingParams(max_new_tokens=n, ignore_eos=True)
    ids0 = te.tokenizer.encode("tell me a story " * 3)
    first = te.generate_ids(ids0, s)
    follow = ids0 + first.token_ids + list(b" continue it.")
    written = len(ids0) + (n if n <= 16 else 16)
    assert te._reusable_prefix(follow)[0] == written
    got = te.generate_ids(follow, s).token_ids
    assert got == _port(weights, prefix_cache=False).generate_ids(follow, s).token_ids
    if n == 12:
        je = _jax(weights)
        js = JaxSampling(max_new_tokens=n, ignore_eos=True)
        je.generate_ids(ids0, js)
        assert je.generate_ids(follow, js).token_ids == got


def test_prefill_span_reports_the_reused_tokens(weights):
    rec = obs.Recorder()
    obs.install(rec)
    try:
        te = _port(weights)
        s = SamplingParams(max_new_tokens=4, ignore_eos=True)
        te.generate(SHARED, s)
        te.generate(SHARED + " and more.", s)
    finally:
        obs.install(None)
    reused = [e.args["reused"] for e in rec.events() if e.name == "prefill"]
    n_shared = len(te.tokenizer.encode(SHARED))
    assert reused[0] == 0 and reused[1] >= n_shared


def test_restore_is_a_fresh_masked_copy(weights):
    te = _port(weights, kv_quant="int8")
    te.generate(SHARED, SamplingParams(max_new_tokens=4, ignore_eos=True))
    saved = te._prefix_cache
    before = {k: saved["k"][k].clone() for k in ("q8", "s")}
    restored = engine_mod._restore_prefix(saved, 40)
    for name in ("q8", "s"):
        src, out = saved["k"][name], restored["k"][name]
        assert out.data_ptr() != src.data_ptr()
        ax = 2 if out.dim() == 5 else 3
        assert torch.equal(out.narrow(ax, 0, 40), src.narrow(ax, 0, 40))
        assert not out.narrow(ax, 40, out.shape[ax] - 40).any()
        out.fill_(7)  # the forward writes caches in place
        assert torch.equal(saved["k"][name], before[name])


# -- admission waves ------------------------------------------------------------------


def _gated(eng, **kw):
    """A batcher whose scheduler waits on a gate, so submissions queued
    before it opens form one admission wave."""
    import threading

    gate = threading.Event()
    real_loop = ContinuousBatcher._loop

    def gated(self):
        gate.wait(timeout=WAIT)
        real_loop(self)

    ContinuousBatcher._loop = gated
    try:
        b = ContinuousBatcher(eng, **kw)
    finally:
        ContinuousBatcher._loop = real_loop
    return b, gate


def test_admission_wave_forks_the_snapshot(weights, monkeypatch):
    """A full-prompt chunked wave whose rows share whole chunks with the
    snapshot forks it and prefills only the later chunks; every row's tokens
    equal the fresh engine's and the JAX engine's, and row 0 is retained."""
    te = _port(weights, stream_interval=8)
    s = SamplingParams(max_new_tokens=10, ignore_eos=True)
    te.generate(SHARED, s)
    forks = []
    real_fork = engine_mod._fork_prefix
    monkeypatch.setattr(engine_mod, "_fork_prefix",
                        lambda *a: forks.append(a[1:]) or real_fork(*a))
    prompts = [SHARED + tail for tail in ("first question?", "a second one", "third", "4")]
    b, gate = _gated(te, max_batch=4, pool_prefix=False)
    try:
        futs = [b.submit(p, s) for p in prompts]
        gate.set()
        got = [f.result(timeout=WAIT).token_ids for f in futs]
    finally:
        b.close()
    assert forks and forks[0][0] == len(te.tokenizer.encode(SHARED)) // CHUNK * CHUNK
    assert te._prefix_ids == tuple(te.tokenizer.encode(prompts[0]))
    fresh = _port(weights, prefix_cache=False)
    je = _jax(weights)
    for p, toks in zip(prompts, got):
        assert toks == fresh.generate(p, s).token_ids
        assert toks == je.generate(p, JaxSampling(max_new_tokens=10, ignore_eos=True)).token_ids


def test_wave_of_unrelated_prompts_keeps_the_snapshot(weights):
    te = _port(weights, stream_interval=8)
    s = SamplingParams(max_new_tokens=6, ignore_eos=True)
    te.generate(SHARED, s)
    kept = te._prefix_ids
    rows = [te.tokenizer.encode(p) for p in ("x" * 40, "y" * 45, "z" * 50)]
    te._prefill_rows(rows)
    assert te._prefix_ids == kept
