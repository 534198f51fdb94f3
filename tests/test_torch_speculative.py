"""The port's speculative decoding (engine/speculative.py) against the JAX
package's (mirrors tests/test_speculative.py's single-stream, control-plane
and drafter cases; the pool's are in tests/test_torch_spec_pool.py, the
provider's and the CLI's in tests/test_torch_spec_cli.py).

The load-bearing property is the reference's: greedy speculative output is
token-exact against the plain target engine for any draft. Here every case
runs the JAX ``SpeculativeEngine`` and the port's on the same float32
weights (tiny-llama, max_seq 512, stream_interval 8: the JAX file's
settings; ``params_from_numpy``) and holds the port's tokens to the JAX
engine's, the JAX speculative engine's and the port's plain engine's. The
sampled path draws from a ``torch.Generator``: its tokens agree with JAX in
distribution, which :func:`test_rejection_accept_keeps_the_target_distribution`
holds the acceptance step to.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import OracleDrafter as JaxOracle
from llm_consensus_tpu.engine import PromptLookupDrafter as JaxLookup
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.engine import SpeculativeEngine as JaxSpec
from llm_consensus_tpu.engine import speculative as jax_spec
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.utils import Context as JaxContext
from llm_consensus_tpu_torch.engine import (
    Engine, OracleDrafter, PromptLookupDrafter, SamplingParams, SpeculativeEngine)
from llm_consensus_tpu_torch.engine import speculative as spec_mod
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.utils.context import Context

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _weights(seed):
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"), CPU,
                           torch.float32)
    return jp, tp


def _pair(seed, **kw):
    """(JAX engine, port engine) on the same float32 weights."""
    jp, tp = _weights(seed)
    kw.setdefault("max_seq", 512)
    kw.setdefault("stream_interval", 8)
    return (JaxEngine(jax_config("tiny-llama"), params=jp, dtype=jnp.float32, **kw),
            Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu",
                   **kw))


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def unrelated_draft():
    return _pair(7)  # same family, other weights


def _js(**kw):
    return JaxSampling(**kw)


def _ts(**kw):
    return SamplingParams(**kw)


def _plain(target, prompt, **kw):
    """The plain engines' tokens, equal across the packages."""
    ref = target[1].generate(prompt, _ts(**kw))
    assert ref.token_ids == target[0].generate(prompt, _js(**kw)).token_ids
    return ref


def test_exact_vs_plain_with_unrelated_draft(target, unrelated_draft):
    """Near-zero acceptance: output still equal to the target's."""
    kw = dict(max_new_tokens=48, ignore_eos=True)
    prompt = "speculative decoding exactness probe"
    ref = _plain(target, prompt, **kw)
    theirs = JaxSpec(target[0], unrelated_draft[0], k=3)
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=3)
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids == theirs.generate(prompt, _js(**kw)).token_ids
    assert got.text == ref.text and got.finish_reason == ref.finish_reason
    assert 1.0 <= spec.mean_accepted < 2.0
    assert spec.mean_accepted == pytest.approx(theirs.mean_accepted)


def test_self_draft_accepts_everything(target):
    kw = dict(max_new_tokens=40, ignore_eos=True)
    prompt = "self speculation accepts all drafts"
    ref = _plain(target, prompt, **kw)
    theirs = JaxSpec(target[0], target[0], k=3)
    spec = SpeculativeEngine(target[1], target[1], k=3)
    assert spec.generate(prompt, _ts(**kw)).token_ids == ref.token_ids
    assert theirs.generate(prompt, _js(**kw)).token_ids == ref.token_ids
    assert spec.mean_accepted == pytest.approx(4.0) == theirs.mean_accepted


def test_self_draft_shares_engine_safely(target):
    spec = SpeculativeEngine(target[1], target[1], k=2)
    s = _ts(max_new_tokens=16, ignore_eos=True)
    a = spec.generate("first call", s).token_ids
    assert a == spec.generate("first call", s).token_ids
    theirs = JaxSpec(target[0], target[0], k=2)
    assert a == theirs.generate("first call", _js(max_new_tokens=16, ignore_eos=True)).token_ids


def test_eos_respected(target, unrelated_draft):
    kw = dict(max_new_tokens=64)
    prompt = "eos handling probe"
    ref = _plain(target, prompt, **kw)
    got = SpeculativeEngine(target[1], unrelated_draft[1], k=3).generate(prompt, _ts(**kw))
    theirs = JaxSpec(target[0], unrelated_draft[0], k=3).generate(prompt, _js(**kw))
    assert got.finish_reason == ref.finish_reason == theirs.finish_reason
    assert got.token_ids == ref.token_ids == theirs.token_ids


def test_streaming_callbacks(target, unrelated_draft):
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=2)
    chunks: list[str] = []
    got = spec.generate("stream me", _ts(max_new_tokens=20, ignore_eos=True),
                        on_text=chunks.append)
    assert "".join(chunks) == got.text
    theirs = JaxSpec(target[0], unrelated_draft[0], k=2).generate(
        "stream me", _js(max_new_tokens=20, ignore_eos=True))
    assert got.text == theirs.text


def test_topk_topp_delegate_to_plain_engine(target, unrelated_draft):
    """Truncated-distribution sampling stays on the plain engine."""
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=2)
    s = _ts(max_new_tokens=12, temperature=0.8, top_k=20, seed=3, ignore_eos=True)
    got = spec.generate("sampled fallback", s)
    assert got.token_ids == target[1].generate("sampled fallback", s).token_ids
    assert got.spec is None and spec.stats["rounds"] == 0
    s = _ts(max_new_tokens=12, temperature=0.8, top_p=0.9, seed=3, ignore_eos=True)
    assert spec.generate("nucleus", s).token_ids == target[1].generate("nucleus", s).token_ids


def test_buffer_drafter_under_sampling_delegates(target):
    """Buffer drafters propose point masses: sampled requests run plain."""
    s = _ts(max_new_tokens=12, temperature=0.8, seed=4, ignore_eos=True)
    spec = SpeculativeEngine(target[1], PromptLookupDrafter(), k=3)
    got = spec.generate("lookup under sampling", s)
    assert got.token_ids == target[1].generate("lookup under sampling", s).token_ids
    assert spec.stats["rounds"] == 0


def test_sampled_rejection_speculation_runs(target, unrelated_draft):
    """Pure temperature rides the draft by rejection sampling: the
    requested count, valid ids, sane stats (as the JAX engine)."""
    kw = dict(max_new_tokens=24, temperature=0.8, seed=5, ignore_eos=True)
    for spec, s in ((SpeculativeEngine(target[1], unrelated_draft[1], k=3), _ts(**kw)),
                    (JaxSpec(target[0], unrelated_draft[0], k=3), _js(**kw))):
        got = spec.generate("rejection sampling probe", s)
        assert len(got.token_ids) == 24 and got.finish_reason == "length"
        assert all(0 <= t < target[1].cfg.vocab_size for t in got.token_ids)
        assert spec.stats["rounds"] > 0 and spec.mean_accepted >= 1.0


def test_sampled_first_token_is_the_plain_engines(target, unrelated_draft):
    """The first token is the plain engine's first draw (same seed)."""
    s = _ts(max_new_tokens=1, temperature=0.9, seed=21, ignore_eos=True)
    prompt = "first draw"
    got = SpeculativeEngine(target[1], unrelated_draft[1], k=3).generate(prompt, s)
    assert got.token_ids == target[1].generate(prompt, s).token_ids


def test_sampled_self_draft_mean_acceptance_above_one(target):
    """p == q: every draft is accepted (k + 1 a round), in both packages."""
    kw = dict(max_new_tokens=32, temperature=0.7, seed=11, ignore_eos=True)
    for spec, s in ((SpeculativeEngine(target[1], target[1], k=3), _ts(**kw)),
                    (JaxSpec(target[0], target[0], k=3), _js(**kw))):
        got = spec.generate("self drafted sampled speculation", s)
        assert len(got.token_ids) == 32
        assert spec.mean_accepted > 3.0, spec.mean_accepted


def test_cancellation(target, unrelated_draft):
    got = SpeculativeEngine(target[1], unrelated_draft[1], k=2).generate(
        "deadline immediately", _ts(max_new_tokens=400, ignore_eos=True),
        ctx=Context.background().with_timeout(0.0))
    theirs = JaxSpec(target[0], unrelated_draft[0], k=2).generate(
        "deadline immediately", _js(max_new_tokens=400, ignore_eos=True),
        ctx=JaxContext.background().with_timeout(0.0))
    assert got.finish_reason == theirs.finish_reason == "deadline"
    assert len(got.token_ids) < 400


def test_partial_acceptance_regime_stays_exact(target):
    """An int8 copy of the target's own weights drafts for it: acceptance
    strictly between the floor and the ceiling (the mid-round correction
    path) and the output still exact, in both packages."""
    jp, tp = _weights(0)
    jdraft = JaxEngine(jax_config("tiny-llama"), params=jp, dtype=jnp.float32, max_seq=512,
                       stream_interval=8, quant="int8")
    tdraft = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu",
                    max_seq=512, stream_interval=8, quant="int8")
    kw = dict(max_new_tokens=64, ignore_eos=True)
    prompt = "partial acceptance statistics probe"
    ref = _plain(target, prompt, **kw)
    spec = SpeculativeEngine(target[1], tdraft, k=4)
    theirs = JaxSpec(target[0], jdraft, k=4)
    assert spec.generate(prompt, _ts(**kw)).token_ids == ref.token_ids
    assert theirs.generate(prompt, _js(**kw)).token_ids == ref.token_ids
    assert 1.0 < spec.mean_accepted < 5.0
    assert 1.0 < theirs.mean_accepted < 5.0


def test_draft_window_too_small_delegates(target):
    jsmall, tsmall = _pair(3, max_seq=16)
    kw = dict(max_new_tokens=12, ignore_eos=True)
    prompt = "a prompt comfortably longer than the draft's tiny window"
    ref = _plain(target, prompt, **kw)
    spec = SpeculativeEngine(target[1], tsmall, k=4)
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids and len(got.token_ids) == 12
    assert spec.stats["rounds"] == 0
    assert JaxSpec(target[0], jsmall, k=4).generate(prompt, _js(**kw)).token_ids == ref.token_ids


def test_draft_of_another_vocabulary_is_refused(target):
    """The JAX engine refuses a draft it cannot co-locate (a multi-device
    mesh); the port's draft must share the target's device and, since it
    ingests the target's tokens, its vocabulary."""
    cfg = get_config("tiny-llama")
    other = Engine(get_config("tiny-llama", vocab_size=cfg.vocab_size + 64), device="cpu",
                   dtype=torch.float32, max_seq=64)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeEngine(target[1], other)


def test_multi_device_engines_rejected(target):
    """The JAX case as it stands (a 2-device mesh is refused); the port's
    counterpart: a draft on another device is refused."""
    from jax.sharding import Mesh

    jsharded, _ = _pair(1)
    jsharded.mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("tp",))
    with pytest.raises(ValueError, match="unsharded"):
        JaxSpec(target[0], jsharded)
    draft = Engine(get_config("tiny-llama"), device="cpu", dtype=torch.float32, max_seq=64)
    draft.device = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        SpeculativeEngine(target[1], draft)


def test_same_single_device_mesh_accepted():
    """The JAX planner pins one-chip models to single-device meshes and
    speculation attaches there; the port's engines on one device too."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("tp",))
    jp, tp = _weights(0)
    jdp, tdp = _weights(7)
    jt = JaxEngine(jax_config("tiny-llama"), params=jp, dtype=jnp.float32, max_seq=512,
                   stream_interval=8, mesh=mesh)
    jd = JaxEngine(jax_config("tiny-llama"), params=jdp, dtype=jnp.float32, max_seq=512,
                   stream_interval=8, mesh=mesh)
    tt = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu",
                max_seq=512, stream_interval=8)
    td = Engine(get_config("tiny-llama"), params=tdp, dtype=torch.float32, device="cpu",
                max_seq=512, stream_interval=8)
    kw = dict(max_new_tokens=10, ignore_eos=True)
    prompt = "single device mesh speculation"
    got = SpeculativeEngine(tt, td, k=2).generate(prompt, _ts(**kw)).token_ids
    assert got == tt.generate(prompt, _ts(**kw)).token_ids
    assert got == JaxSpec(jt, jd, k=2).generate(prompt, _js(**kw)).token_ids


def test_requested_tokens_beyond_draft_window_delegate(target):
    """prompt + max_new past the draft's window: the target's limits alone
    decide the length (the whole generation runs plain)."""
    jsmall, tsmall = _pair(3, max_seq=64)
    kw = dict(max_new_tokens=120, ignore_eos=True)
    prompt = "short prompt"
    ref = _plain(target, prompt, **kw)
    got = SpeculativeEngine(target[1], tsmall, k=4).generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids and len(got.token_ids) == 120
    assert got.finish_reason == ref.finish_reason == "length"
    theirs = JaxSpec(target[0], jsmall, k=4).generate(prompt, _js(**kw))
    assert theirs.token_ids == ref.token_ids


def test_max_new_zero_returns_at_once(target, unrelated_draft):
    got = SpeculativeEngine(target[1], unrelated_draft[1], k=2).generate(
        "nothing", _ts(max_new_tokens=0))
    theirs = JaxSpec(target[0], unrelated_draft[0], k=2).generate("nothing",
                                                                  _js(max_new_tokens=0))
    assert got.token_ids == theirs.token_ids == [] and got.finish_reason == "length"


# Greedy equality per drafter: the port's speculative tokens equal the JAX
# speculative engine's and both plain engines'.
DRAFTERS = ["model", "self", "lookup", "oracle-1", "oracle-2", "oracle-3", "oracle-4",
            "oracle-all"]


@pytest.mark.parametrize("drafter", DRAFTERS)
def test_greedy_equals_jax_and_plain_per_drafter(target, unrelated_draft, drafter):
    kw = dict(max_new_tokens=33, ignore_eos=True)
    prompt = "the judge quotes the panel: the judge quotes the panel again"
    ref = _plain(target, prompt, **kw)
    if drafter == "model":
        ours, theirs = unrelated_draft[1], unrelated_draft[0]
    elif drafter == "self":
        ours, theirs = target[1], target[0]
    elif drafter == "lookup":
        ours, theirs = PromptLookupDrafter(2), JaxLookup(2)
    else:
        accept = None if drafter == "oracle-all" else int(drafter.split("-")[1])
        ours = OracleDrafter(ref.token_ids, accept=accept)
        theirs = JaxOracle(ref.token_ids, accept=accept)
    spec = SpeculativeEngine(target[1], ours, k=3, adaptive=False, governor=False)
    jspec = JaxSpec(target[0], theirs, k=3, adaptive=False, governor=False)
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids
    assert jspec.generate(prompt, _js(**kw)).token_ids == ref.token_ids
    assert spec.stats["rounds"] == jspec.stats["rounds"]
    assert spec.stats["accepted"] == jspec.stats["accepted"]
    if drafter.startswith("oracle"):
        want = 4.0 if accept is None else float(accept)
        assert spec.mean_accepted == pytest.approx(want, abs=0.35)


@pytest.mark.parametrize("probe", [16, 24])
def test_governor_on_stays_exact_and_locks_like_jax(target, unrelated_draft, probe):
    """The single-stream governor on a losing drafter: plain windows (with
    the draft's catch-up ingest), the same tokens, and a decision."""
    kw = dict(max_new_tokens=96, ignore_eos=True)
    prompt = "governor probe stream"
    ref = _plain(target, prompt, **kw)
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=3, probe_tokens=probe)
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids
    assert got.spec["governor"] in ("plain_locked", "spec_locked")
    assert got.spec["plain_tokens"] >= probe
    jspec = JaxSpec(target[0], unrelated_draft[0], k=3, probe_tokens=probe)
    assert jspec.generate(prompt, _js(**kw)).token_ids == ref.token_ids


def test_acceptance_collapse_fault_single_stream(target, unrelated_draft):
    """The spec fault site on the single-stream engine: junk proposals,
    unchanged greedy output, counted collapses."""
    from llm_consensus_tpu_torch import faults

    kw = dict(max_new_tokens=20, ignore_eos=True)
    prompt = "collapse fault exactness probe"
    ref = _plain(target, prompt, **kw)
    faults.install(faults.FaultPlan("acceptance_collapse@times=-1", seed=3))
    try:
        spec = SpeculativeEngine(target[1], target[1], k=3, adaptive=False, governor=False)
    finally:
        faults.reset()
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids
    assert spec.stats["collapse_faults"] > 0 and spec.mean_accepted == 1.0


def test_stats_and_spec_summary(target, unrelated_draft):
    """``stats``, ``mean_accepted`` and the result's ``spec`` summary carry
    the JAX keys."""
    kw = dict(max_new_tokens=24, ignore_eos=True)
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=3)
    jspec = JaxSpec(target[0], unrelated_draft[0], k=3)
    got = spec.generate("summary probe", _ts(**kw))
    theirs = jspec.generate("summary probe", _js(**kw))
    assert set(spec.stats) == set(jspec.stats)
    assert set(got.spec) == set(theirs.spec)
    assert got.spec["rounds"] == theirs.spec["rounds"]
    assert got.spec["accepted"] == theirs.spec["accepted"]


def test_retains_the_target_cache_for_reuse(target, unrelated_draft):
    """The finished cache is retained with the ids whose KV it holds: a
    follow-up sharing a prefill chunk reuses it and stays exact."""
    jp, tp = _weights(0)
    eng = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu",
                 max_seq=512, stream_interval=8, prefill_chunk=16)
    spec = SpeculativeEngine(eng, unrelated_draft[1], k=3)
    prompt = "a retained speculative stream with a prompt of some length"
    got = spec.generate(prompt, _ts(max_new_tokens=20, ignore_eos=True))
    written = eng._prefix_ids
    assert written is not None and len(written) >= len(prompt)
    ids = eng.tokenizer.encode(prompt) + got.token_ids
    assert list(written) == ids[:len(written)]
    follow = prompt + eng.tokenizer.decode(got.token_ids) + " and more"
    fresh = Engine(get_config("tiny-llama"), params=tp, dtype=torch.float32, device="cpu",
                   max_seq=512, stream_interval=8, prefill_chunk=16, prefix_cache=False)
    s = _ts(max_new_tokens=12, ignore_eos=True)
    assert spec.generate(follow, s).token_ids == fresh.generate(follow, s).token_ids


def test_one_host_fetch_per_round_group(target, unrelated_draft, monkeypatch):
    """Rounds chain on the device: one host copy per ``rounds`` rounds."""
    calls = []
    real = spec_mod._to_host
    monkeypatch.setattr(spec_mod, "_to_host", lambda t: calls.append(len(t)) or real(t))
    spec = SpeculativeEngine(target[1], unrelated_draft[1], k=3, adaptive=False,
                             governor=False, rounds_per_chunk=4)
    spec.generate("fetch counting probe", _ts(max_new_tokens=40, ignore_eos=True))
    rounds = spec.stats["rounds"]
    assert len(calls) <= -(-rounds // 4) + 1, (len(calls), rounds)


def test_sampled_key_schedule_immune_to_fetch_batching(target, unrelated_draft):
    """The sampled path's draws are a function of the round counter, not
    of fetch cadence (k pinned: the controller observes at fetches)."""
    s = _ts(max_new_tokens=24, temperature=0.8, seed=9, ignore_eos=True)
    prompt = "key schedule collision probe"
    one = SpeculativeEngine(target[1], unrelated_draft[1], k=3, rounds_per_chunk=1,
                            adaptive=False).generate(prompt, s)
    batched = SpeculativeEngine(target[1], unrelated_draft[1], k=3, rounds_per_chunk=8,
                                adaptive=False).generate(prompt, s)
    assert one.token_ids == batched.token_ids
    js = _js(max_new_tokens=24, temperature=0.8, seed=9, ignore_eos=True)
    j1 = JaxSpec(target[0], unrelated_draft[0], k=3, rounds_per_chunk=1, adaptive=False)
    j8 = JaxSpec(target[0], unrelated_draft[0], k=3, rounds_per_chunk=8, adaptive=False)
    assert j1.generate(prompt, js).token_ids == j8.generate(prompt, js).token_ids


# -- the sampled path's acceptance step -------------------------------------------

TV_DRAWS = 4000
TV_BOUND = 0.05  # total variation over 6 outcomes at 4,000 draws (noise ~0.02)


@pytest.mark.parametrize("case", ["disjoint", "close", "peaked-draft"])
def test_rejection_accept_keeps_the_target_distribution(case):
    """Drafts drawn from q, the acceptance step at seeded uniforms: the
    first emitted token follows p_0 and the token after a fully accepted
    first draft follows p_1 (the correction or the bonus), within TV_BOUND
    total variation over TV_DRAWS seeded draws."""
    g = torch.Generator().manual_seed(1234)
    v, k = 6, 2
    p = torch.softmax(torch.randn(k + 1, v, generator=g) * 1.5, -1)
    if case == "disjoint":
        q = torch.zeros(k, v)
        q[:, :3] = 1.0 / 3
        p = torch.zeros(k + 1, v)
        p[:, 2:] = 0.25
    elif case == "close":
        q = torch.softmax(torch.log(p[:k]) + 0.3 * torch.randn(k, v, generator=g), -1)
    else:
        q = torch.full((k, v), 0.02)
        q[:, 0] = 1.0 - 0.02 * (v - 1)
    first = torch.zeros(v)
    second = torch.zeros(v)
    n_second = 0
    for _ in range(TV_DRAWS):
        drafts = torch.stack([torch.multinomial(q[i], 1, generator=g)[0] for i in range(k)])
        us = torch.rand(k + 1, generator=g)
        out, a, _lead = spec_mod.rejection_accept(p, q, drafts, us)
        first[out[0]] += 1
        if int(a) >= 2:
            second[out[1]] += 1
            n_second += 1
    tv = 0.5 * (first / TV_DRAWS - p[0]).abs().sum()
    assert tv < TV_BOUND, (case, float(tv))
    if n_second >= 500:
        tv2 = 0.5 * (second / n_second - p[1]).abs().sum()
        assert tv2 < 2 * TV_BOUND, (case, float(tv2), n_second)


def test_rejection_accept_matches_the_jax_acceptance_rule():
    """Where no randomness enters (acceptance is certain or impossible),
    the port's step accepts exactly as the JAX verify does."""
    v, k = 5, 3
    p = torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.0]] * (k + 1))
    q = torch.full((k, v), 0.2)
    drafts = torch.tensor([1, 1, 3])
    out, a, lead = spec_mod.rejection_accept(p, q, drafts, torch.tensor([0.5, 0.5, 0.5, 0.5]))
    assert int(lead) == 2 and int(a) == 3  # p(3) = 0: the third is rejected
    assert out.tolist() == [1, 1, 1, 0]  # the correction from max(p - q, 0): token 1


# -- control plane (host units) ------------------------------------------------


def test_adaptive_k_converges_down_on_collapse():
    c = spec_mod.AdaptiveK(8)
    assert c.k == 8
    for _ in range(40):
        c.observe(1.0, c.k)
    assert c.k == 1


def test_adaptive_k_regrows_on_wins():
    c = spec_mod.AdaptiveK(8)
    for _ in range(40):
        c.observe(1.0, c.k)
    for _ in range(60):
        c.observe(c.k + 1, c.k)
    assert c.k == 8


def test_adaptive_k_ladder_is_pow2_bounded():
    for k in (1, 2, 3, 4, 6, 8, 13):
        assert spec_mod.k_ladder(k) == jax_spec.k_ladder(k)
    assert spec_mod.k_ladder(6) == [1, 2, 4, 6]


def test_adaptive_off_pins_k():
    c = spec_mod.AdaptiveK(4, adaptive=False)
    for _ in range(50):
        c.observe(1.0, c.k)
    assert c.k == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k_max", [1, 4, 6, 8])
def test_adaptive_k_follows_jax_decisions(seed, k_max):
    """The same acceptance sequence walks the same ladder in both."""
    rng = random.Random(seed * 31 + k_max)
    ours, theirs = spec_mod.AdaptiveK(k_max), jax_spec.AdaptiveK(k_max)
    for _ in range(200):
        k = ours.k
        assert k == theirs.k
        a = rng.choice([1, 1, 1, k + 1, rng.randint(1, k + 1)])
        ours.observe(a, k)
        theirs.observe(a, k)
        assert ours.ema == pytest.approx(theirs.ema)


def test_governor_locks_faster_mode():
    g = spec_mod.SpecGovernor(probe_tokens=10)
    assert g.mode == "spec"
    assert g.feed(10, 1.0) is True
    assert g.mode == "plain"
    assert g.feed(10, 0.5) is False
    assert g.state == "plain_locked" and g.disabled_spec and g.mode == "plain"


def test_governor_keeps_winning_spec():
    g = spec_mod.SpecGovernor(probe_tokens=10)
    g.feed(10, 0.5)
    assert g.feed(10, 1.0) is True
    assert g.state == "spec_locked" and not g.disabled_spec and g.mode == "spec"


def test_governor_disabled_runs_spec_forever():
    g = spec_mod.SpecGovernor(enabled=False)
    assert g.state == "spec_locked"
    assert g.feed(1000, 1000.0) is False
    assert g.mode == "spec"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_governor_follows_jax_decisions(seed):
    rng = random.Random(seed)
    probe = rng.choice([1, 8, 64])
    ours, theirs = spec_mod.SpecGovernor(probe), jax_spec.SpecGovernor(probe)
    for _ in range(60):
        tokens, wall = rng.randint(0, 40), rng.random()
        assert ours.feed(tokens, wall) == theirs.feed(tokens, wall)
        assert (ours.state, ours.mode, ours.disabled_spec) == (
            theirs.state, theirs.mode, theirs.disabled_spec)


def test_spec_config_defaults_are_the_knobs():
    """The port's SpecConfig takes the JAX knobs' defaults from its
    constructor (the environment is read by utils/knobs.py only)."""
    from llm_consensus_tpu.utils import knobs as jax_knobs

    cfg = spec_mod.SpecConfig(kind="lookup")
    theirs = jax_spec.spec_config_from_env(kind="lookup")
    for field in ("k", "ngram", "adaptive", "governor", "probe_tokens"):
        assert getattr(cfg, field) == getattr(theirs, field), field
    assert cfg.k == jax_knobs.REGISTRY["LLMC_SPEC_K"].default


# -- drafters (device units) ---------------------------------------------------


def test_prompt_lookup_proposes_matched_continuation():
    buf = [[1, 2, 7, 8, 9, 4, 5, 6, 3, 2, 7, 8, 0, 0, 0, 0]]
    props = spec_mod._lookup_propose(torch.tensor(buf), torch.tensor([12]), k=3, g=2)
    assert props.tolist() == [[9, 4, 5]]
    assert props.tolist() == jax_spec._lookup_propose(
        jnp.asarray(buf, jnp.int32), jnp.asarray([12], jnp.int32), k=3, g=2).tolist()


def test_prompt_lookup_no_match_repeats_last():
    buf = [[1, 2, 3, 4, 5, 6, 0, 0]]
    props = spec_mod._lookup_propose(torch.tensor(buf), torch.tensor([6]), k=2, g=3)
    assert props.tolist() == [[6, 6]]


def test_oracle_propose_accept_knob():
    obuf = torch.tensor([[10, 11, 12, 13, 14, 15, 16, 17]])
    blen = torch.tensor([3])
    assert spec_mod._oracle_propose(obuf, blen, k=3, vocab=100).tolist() == [[13, 14, 15]]
    assert spec_mod._oracle_propose(obuf, blen, k=3, vocab=100,
                                    accept=2).tolist() == [[13, 15, 16]]


@pytest.mark.parametrize("seed", range(6))
def test_proposals_equal_jax_on_random_buffers(seed):
    """``_lookup_propose``, ``_oracle_propose`` and ``_junk_propose`` on
    random small-alphabet buffers (many matches) against the JAX programs."""
    rng = np.random.default_rng(seed)
    b, s = 4, 64
    buf = rng.integers(0, 4, size=(b, s))
    blen = rng.integers(1, s, size=(b,))
    k = int(rng.integers(1, 6))
    g = int(rng.integers(1, 4))
    vocab = 50
    tb, tl = torch.tensor(buf), torch.tensor(blen)
    jb, jl = jnp.asarray(buf, jnp.int32), jnp.asarray(blen, jnp.int32)
    assert (spec_mod._lookup_propose(tb, tl, k, g).tolist()
            == jax_spec._lookup_propose(jb, jl, k, g).tolist())
    for accept in (None, 1, 2, k + 1):
        assert (spec_mod._oracle_propose(tb, tl, k, vocab, accept).tolist()
                == jax_spec._oracle_propose(jb, jl, k, vocab, accept).tolist())
    assert (spec_mod._junk_propose(tb, tl, k, vocab).tolist()
            == jax_spec._junk_propose(jb, jl, k, vocab).tolist())


def test_oracle_forced_acceptance_levels(target):
    kw = dict(max_new_tokens=24, ignore_eos=True)
    prompt = "forced acceptance sweep probe"
    ref = _plain(target, prompt, **kw)
    for accept in (1, 2):
        spec = SpeculativeEngine(target[1], OracleDrafter(ref.token_ids, accept=accept), k=3,
                                 adaptive=False, governor=False)
        assert spec.generate(prompt, _ts(**kw)).token_ids == ref.token_ids
        assert spec.mean_accepted == pytest.approx(accept, abs=0.35)


def test_oracle_single_stream_ceiling(target):
    kw = dict(max_new_tokens=24, ignore_eos=True)
    prompt = "oracle ceiling probe"
    ref = _plain(target, prompt, **kw)
    spec = SpeculativeEngine(target[1], OracleDrafter(ref.token_ids), k=3, adaptive=False,
                             governor=False)
    assert spec.generate(prompt, _ts(**kw)).token_ids == ref.token_ids
    assert spec.mean_accepted == pytest.approx(4.0, abs=0.5)


def test_prompt_lookup_single_stream_exact(target):
    kw = dict(max_new_tokens=32, ignore_eos=True)
    prompt = "prompt lookup drafter single stream probe"
    ref = _plain(target, prompt, **kw)
    spec = SpeculativeEngine(target[1], PromptLookupDrafter(), k=3, governor=False)
    got = spec.generate(prompt, _ts(**kw))
    assert got.token_ids == ref.token_ids
    assert got.spec is not None and got.spec["rounds"] > 0
