"""The port's speculative continuous batcher (``ContinuousBatcher(spec=)``,
engine/speculative.py's batched programs) against single-stream decoding
and the JAX pool (mirrors tests/test_speculative.py ``TestBatchedSpec``).

Every stream of a greedy speculative pool must emit exactly the
single-stream engine's tokens (the port's and the JAX engine's on the same
float32 weights), across batch sizes, mid-round exits and admissions,
compaction with holes, row moves and faults. Where the JAX pool departs
(compaction retires a row whose holes fill its window) a test pins the
departure with its cause. Every future is waited on with a timeout and every
batcher is closed.
"""

import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu.engine import ContinuousBatcher as JaxBatcher
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.engine import SpecConfig as JaxSpecConfig
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams, SpecConfig
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy

WAIT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("LLMC_FAULTS", "LLMC_KV_POOL", "LLMC_KV_POOL_BLOCK"):
        monkeypatch.delenv(knob, raising=False)
    faults.reset()
    jax_faults.reset()
    obs.reset_planes()
    yield
    faults.reset()
    jax_faults.reset()
    obs.reset_planes()


def _weights(seed=0, preset="tiny-llama"):
    jp = jax_init(jax_config(preset), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config(preset),
                           torch.device("cpu"), torch.float32)
    return jp, tp


@pytest.fixture(scope="module")
def weights():
    return _weights()


def _port(weights, max_seq=512, **kw):
    return Engine(get_config("tiny-llama"), params=weights[1], dtype=torch.float32,
                  device="cpu", max_seq=max_seq, stream_interval=8, **kw)


def _jax(weights, max_seq=512, **kw):
    return JaxEngine(jax_config("tiny-llama"), params=weights[0], dtype=jnp.float32,
                     max_seq=max_seq, stream_interval=8, **kw)


@pytest.fixture(scope="module")
def target(weights):
    return _jax(weights), _port(weights)


def _refs(pair, prompts, max_new):
    """Single-stream greedy tokens, equal in both packages."""
    je, te = pair
    out = []
    for p, m in zip(prompts, max_new):
        ours = te.generate(p, SamplingParams(max_new_tokens=m, ignore_eos=True)).token_ids
        theirs = je.generate(p, JaxSampling(max_new_tokens=m, ignore_eos=True)).token_ids
        assert ours == theirs, p
        out.append(ours)
    return out


def _pool_run(eng, prompts, max_new, spec, stagger_s=0.0, max_batch=4, jax_pool=False):
    cls, sampling = (JaxBatcher, JaxSampling) if jax_pool else (ContinuousBatcher,
                                                                SamplingParams)
    b = cls(eng, max_batch=max_batch, spec=spec)
    try:
        futs = []
        for p, m in zip(prompts, max_new):
            futs.append(b.submit(p, sampling(max_new_tokens=m, ignore_eos=True)))
            if stagger_s:
                time.sleep(stagger_s)
        results = [f.result(timeout=WAIT) for f in futs]
        snap = b.spec_snapshot()
        stats = b.snapshot()
    finally:
        b.close()
    return results, snap, stats


PROMPTS = ["batched speculative exactness probe",
           "a second stream with a rather longer prompt body to vary", "third",
           "the fourth resident stream"]
MAX_NEW = [24, 17, 31, 9]  # staggered mid-round exits


@pytest.mark.parametrize("n", [1, 4])
def test_token_exact_across_batch_sizes(target, n):
    refs = _refs(target, PROMPTS[:n], MAX_NEW[:n])
    results, snap, _ = _pool_run(target[1], PROMPTS[:n], MAX_NEW[:n],
                                 SpecConfig(kind="lookup", k=3, governor=False))
    assert [r.token_ids for r in results] == refs
    assert snap["rounds"] > 0
    jres, jsnap, _ = _pool_run(target[0], PROMPTS[:n], MAX_NEW[:n],
                               JaxSpecConfig(kind="lookup", k=3, governor=False), jax_pool=True)
    assert [r.token_ids for r in jres] == refs
    assert set(snap) == set(jsnap)


def test_mid_stream_admission(target):
    """A stream admitted while the pool runs rounds (spliced at the
    advanced frontier, its bitmap row installed over the window)."""
    p1, p2 = "the long-running resident stream", "late admission"
    refs = _refs(target, [p1, p2], [48, 16])
    results, _snap, _ = _pool_run(target[1], [p1, p2], [48, 16],
                                  SpecConfig(kind="lookup", k=3, governor=False), stagger_s=0.3)
    assert [r.token_ids for r in results] == refs


def test_oracle_full_acceptance(target):
    """An oracle replaying the target's greedy output: a = k + 1 every
    round (the machinery's ceiling), output exact."""
    prompts = ["oracle pool stream a", "oracle pool stream b longer"]
    max_new = [20, 26]
    refs = _refs(target, prompts, max_new)
    te = target[1]
    by_ids = {tuple(te._budget_prompt(te.tokenizer.encode(p), m)[0]): r
              for p, m, r in zip(prompts, max_new, refs)}
    spec = SpecConfig(kind="oracle", k=3, adaptive=False, governor=False,
                      oracle=lambda ids: by_ids.get(tuple(ids), []))
    results, snap, _ = _pool_run(te, prompts, max_new, spec)
    assert [r.token_ids for r in results] == refs
    assert snap["mean_accepted"] > 3.0, snap


@pytest.mark.parametrize("accept", [1, 2, 3])
def test_oracle_forced_acceptance_in_a_pool(target, accept):
    prompts = ["forced pool stream one", "forced pool stream two, longer"]
    max_new = [21, 30]
    refs = _refs(target, prompts, max_new)
    te = target[1]
    by_ids = {tuple(te._budget_prompt(te.tokenizer.encode(p), m)[0]): r
              for p, m, r in zip(prompts, max_new, refs)}
    spec = SpecConfig(kind="oracle", k=3, adaptive=False, governor=False,
                      oracle=lambda ids: by_ids.get(tuple(ids), []), oracle_accept=accept)
    results, snap, _ = _pool_run(te, prompts, max_new, spec)
    assert [r.token_ids for r in results] == refs
    assert snap["mean_accepted"] == pytest.approx(accept, abs=0.35)


# The compaction case of the JAX file: max_seq 128, a 117-token prompt (10
# tokens) beside a 36-token one (24), so the frontier crosses capacity.
PA = "waterline filler prompt " * 9
PB = "the stream that outlives compaction"


def test_compaction_with_holes(weights):
    """The waterline under spec mode: holes squeezed, bitmap rolled with
    the cache, every stream equal to single-stream through the slide."""
    pair = (_jax(weights, max_seq=128), _port(weights, max_seq=128))
    refs = _refs(pair, [PA, PB], [10, 24])
    obs.install(obs.Recorder())
    try:
        results, _snap, stats = _pool_run(
            pair[1], [PA, PB], [10, 24],
            SpecConfig(kind="lookup", k=3, adaptive=False, governor=False))
        assert "compact" in obs.recorder().span_names()
    finally:
        obs.reset_planes()
    assert [r.token_ids for r in results] == refs
    assert stats["compactions"] >= 1


def test_jax_pool_departs_at_compaction_with_holes(weights):
    """Where the JAX pool departs from single-stream (and why the JAX
    file's test_compaction_with_holes fails): its compaction measures each
    row's window by its PHYSICAL slots, holes included, and retires a row
    whose window spans the cache. Stream A (117-token prompt, 10 tokens
    wanted, 128 slots) has ~1 token accepted per 4-slot round, so its
    window fills the cache after ~6 tokens and it is retired with
    ``length``: a strict prefix of the single-stream tokens. The port
    squeezes the holes out first (test_compaction_with_holes)."""
    je = _jax(weights, max_seq=128)
    ra = je.generate(PA, JaxSampling(max_new_tokens=10, ignore_eos=True)).token_ids
    results, _snap, _ = _pool_run(
        je, [PA, PB], [10, 24],
        JaxSpecConfig(kind="lookup", k=3, adaptive=False, governor=False), jax_pool=True)
    got = results[0].token_ids
    assert results[0].finish_reason == "length"
    assert len(got) < len(ra) and got == ra[:len(got)]


def test_compaction_with_holes_and_a_row_move(weights):
    """Holes, compaction and a shrink in one pool (16 slots, 8-row floor):
    rows moved with their bitmap, buffer and length stay exact."""
    pair = (_jax(weights, max_seq=160), _port(weights, max_seq=160))
    prompts = [f"row move stream number {i:02d}" for i in range(10)]
    max_new = [4] * 8 + [60, 70]
    refs = _refs(pair, prompts, max_new)
    obs.install(obs.Recorder())
    try:
        results, _snap, stats = _pool_run(pair[1], prompts, max_new,
                                          SpecConfig(kind="lookup", k=3, adaptive=False,
                                                     governor=False), max_batch=16)
        spans = obs.recorder().span_names()
    finally:
        obs.reset_planes()
    assert [r.token_ids for r in results] == refs
    assert "resize" in spans and stats["compactions"] >= 1, (spans, stats)


def test_sampled_template_keeps_classic_path(target):
    b = ContinuousBatcher(target[1], max_batch=2,
                          spec=SpecConfig(kind="lookup", k=3, governor=False))
    try:
        r = b.submit("sampled template probe", SamplingParams(
            max_new_tokens=8, temperature=0.8, seed=3, ignore_eos=True)).result(timeout=WAIT)
        snap = b.spec_snapshot()
    finally:
        b.close()
    assert len(r.token_ids) == 8
    assert snap["rounds"] == 0


def test_spec_with_kv_pool(weights):
    """Spec streams publish through the paged KV pool like any stream:
    greedy tokens pool on equal pool off."""
    eng = _port(weights, kv_pool=True, kv_pool_block=16, prefill_chunk=16)
    assert eng._kv_pool is not None
    prompts = ["kv pool spec stream one", "kv pool spec stream two"]
    refs = _refs((_jax(weights), _port(weights)), prompts, [14, 14])
    results, snap, _ = _pool_run(eng, prompts, [14, 14],
                                 SpecConfig(kind="lookup", k=3, governor=False))
    assert [r.token_ids for r in results] == refs
    assert snap["rounds"] > 0


def test_acceptance_collapse_fault_exact(weights):
    """``acceptance_collapse`` junks every round's proposals: acceptance
    pins to ~1, greedy output unchanged."""
    prompt = "collapse fault exactness probe"
    (ref,) = _refs((_jax(weights), _port(weights)), [prompt], [20])
    faults.install(faults.FaultPlan("acceptance_collapse@times=-1", seed=3))
    eng = _port(weights)  # binds the plan at construction
    results, snap, _ = _pool_run(eng, [prompt], [20],
                                 SpecConfig(kind="lookup", k=3, adaptive=False, governor=False))
    assert results[0].token_ids == ref
    assert snap["collapse_faults"] > 0
    assert snap["mean_accepted"] < 1.5, snap


def test_draft_stall_fault_is_speed_only(weights):
    prompt = "draft stall probe"
    (ref,) = _refs((_jax(weights), _port(weights)), [prompt], [12])
    faults.install(faults.FaultPlan("draft_stall@s=0.01@times=3", seed=1))
    eng = _port(weights)
    results, snap, _ = _pool_run(eng, [prompt], [12],
                                 SpecConfig(kind="lookup", k=3, governor=False))
    assert results[0].token_ids == ref and snap["rounds"] > 0
    assert sum(1 for d in faults.plan().trace if "draft_stall" in str(d)) >= 1


def test_governor_locks_and_stays_exact(target):
    """With the governor on, the pool probes drafted then plain windows
    (bitmap-keeping) and locks one; streams stay exact either way."""
    prompts = PROMPTS[:2]
    refs = _refs(target, prompts, [64] * 2)
    results, snap, _ = _pool_run(target[1], prompts, [64] * 2,
                                 SpecConfig(kind="lookup", k=3, probe_tokens=12))
    assert [r.token_ids for r in results] == refs
    assert snap["governor"] in ("plain_locked", "spec_locked")


def test_brownout_runs_plain_windows(target):
    """Brownout switches a spec pool to its plain windows: no round is
    dispatched, tokens unchanged."""
    (ref,) = _refs(target, ["brownout probe"], [20])
    b = ContinuousBatcher(target[1], max_batch=2,
                          spec=SpecConfig(kind="lookup", k=3, governor=False))
    try:
        b.set_brownout(True)
        r = b.submit("brownout probe", SamplingParams(max_new_tokens=20, ignore_eos=True))
        got = r.result(timeout=WAIT).token_ids
        snap = b.spec_snapshot()
    finally:
        b.close()
    assert got == ref and snap["rounds"] == 0


def test_sliding_window_model_warns_and_decodes_classically():
    cfg = get_config("tiny-llama", sliding_window=32)
    eng = Engine(cfg, device="cpu", dtype=torch.float32, max_seq=128, stream_interval=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = ContinuousBatcher(eng, max_batch=2, spec=SpecConfig(kind="lookup"))
    try:
        assert b.spec_snapshot() is None
        assert any("speculative pool decode disabled" in str(w.message) for w in caught)
        s = SamplingParams(max_new_tokens=10, ignore_eos=True)
        got = b.submit("windowed model", s).result(timeout=WAIT).token_ids
    finally:
        b.close()
    assert got == eng.generate("windowed model", s).token_ids


def test_kv_mask_refusals():
    """The bitmap needs a cache and row starts and refuses a window (the
    JAX forward's checks)."""
    from llm_consensus_tpu_torch.models.transformer import forward, init_kv_cache, init_params

    cfg = get_config("tiny-llama")
    params = init_params(cfg, 0, device=torch.device("cpu"), dtype=torch.float32)
    toks = torch.zeros((1, 2), dtype=torch.long)
    mask = torch.ones((1, 16), dtype=torch.bool)
    cache = init_kv_cache(cfg, 1, 16, device=torch.device("cpu"), dtype=torch.float32)
    with pytest.raises(ValueError, match="row_start"):
        forward(params, cfg, toks, cache, 0, kv_mask=mask)
    with pytest.raises(ValueError, match="cache"):
        forward(params, cfg, toks, None, 0, kv_mask=mask, row_start=torch.zeros(1))
    wcfg = get_config("tiny-llama", sliding_window=8)
    with pytest.raises(ValueError, match="sliding_window"):
        forward(params, wcfg, toks, cache, 0, kv_mask=mask,
                row_start=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("holes", [False, True])
def test_kv_mask_forward_equals_jax(weights, holes):
    """The forward's bitmap rule against the JAX forward's on the same
    cache, row starts and bitmap (holes cleared inside the window)."""
    from llm_consensus_tpu.models import forward as jax_forward
    from llm_consensus_tpu.models import init_kv_cache as jax_cache
    from llm_consensus_tpu_torch.models.transformer import forward, init_kv_cache

    cfg, jcfg = get_config("tiny-llama"), jax_config("tiny-llama")
    s, b = 32, 2
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 200, size=(b, 3))
    rs = np.array([4, 9], np.int32)
    valid = np.zeros((b, s), bool)
    for i in range(b):
        valid[i, rs[i]:20] = True
    if holes:
        valid[0, 10:13] = False
        valid[1, 15] = False
    valid[:, 20:23] = True
    tc = init_kv_cache(cfg, b, s, device=torch.device("cpu"), dtype=torch.float32)
    fill = rng.standard_normal(tuple(tc["k"].shape)).astype(np.float32) * 0.5
    tc["k"].copy_(torch.from_numpy(fill))
    tc["v"].copy_(torch.from_numpy(fill[::-1].copy()))
    jc = jax_cache(jcfg, batch=b, max_seq=s, dtype=jnp.float32)
    jc = {"k": jnp.asarray(fill), "v": jnp.asarray(fill[::-1].copy())}
    ours, _ = forward(weights[1], cfg, torch.tensor(toks), tc, 20,
                      row_start=torch.tensor(rs), kv_mask=torch.tensor(valid))
    theirs, _ = jax_forward(weights[0], jcfg, jnp.asarray(toks, jnp.int32), jc, 20,
                            row_start=jnp.asarray(rs), kv_mask=jnp.asarray(valid))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-4, rtol=2e-4)


def test_spec_snapshot_keys_follow_jax(target):
    b = ContinuousBatcher(target[1], max_batch=2, spec=SpecConfig(kind="lookup"))
    jb = JaxBatcher(target[0], max_batch=2, spec=JaxSpecConfig(kind="lookup"))
    try:
        assert set(b.spec_snapshot()) == set(jb.spec_snapshot())
    finally:
        b.close()
        jb.close()
    classic = ContinuousBatcher(target[1], max_batch=2)
    try:
        assert classic.spec_snapshot() is None
    finally:
        classic.close()


def test_concurrent_submitters(target):
    """Submissions from several threads into one spec pool: each exact."""
    prompts = [f"threaded spec submitter {i}" for i in range(4)]
    refs = _refs(target, prompts, [18] * 4)
    b = ContinuousBatcher(target[1], max_batch=4,
                          spec=SpecConfig(kind="lookup", k=2, governor=False))
    out = [None] * 4
    try:
        def run(i):
            out[i] = b.submit(prompts[i], SamplingParams(max_new_tokens=18, ignore_eos=True)
                              ).result(timeout=WAIT).token_ids

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        b.close()
    assert out == refs
