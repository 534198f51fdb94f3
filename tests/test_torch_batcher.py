"""The port's continuous batcher (engine/batcher.py) against single-stream
decoding (mirrors tests/test_continuous_batching.py and
tests/test_pool_prefix.py).

The load-bearing property is the reference's: a stream's greedy tokens are
exactly what the single-stream engine produces, whatever its slot
neighbours do and whatever sharing happens underneath. Here the port's
batcher is held to the port's single-stream engine and, on the shared-
prefix, compaction and int8-KV cases, to the JAX engine on the same
float32 weights (tiny-llama, max_seq 256, stream_interval 8: the JAX
files' own settings). Every future is waited on with a timeout and every
batcher is closed.
"""

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
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine import batcher as batcher_mod
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import init_kv_cache, params_from_numpy
from llm_consensus_tpu_torch.utils.context import Context

WAIT = 300  # seconds any future may take
PREFIX = (
    "a shared consensus prompt prefix that every stream of the wave "
    "carries verbatim before its own question suffix begins"
)


@pytest.fixture(autouse=True)
def _no_jax_prefix_reuse(monkeypatch):
    # Each JAX generate a fresh prefill: these tests compare single
    # generates (prefix reuse is held to JAX in test_torch_prefix_reuse.py).
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")


def _engines(max_seq=256, preset="tiny-llama", overrides=None, **modes):
    over = overrides or {}
    jcfg, tcfg = jax_config(preset, **over), get_config(preset, **over)
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, torch.device("cpu"),
                           torch.float32)
    je = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=max_seq, stream_interval=8,
                   **modes)
    te = Engine(tcfg, params=tp, dtype=torch.float32, max_seq=max_seq, stream_interval=8,
                device="cpu", **modes)
    return je, te


@pytest.fixture(scope="module")
def pair():
    return _engines()


@pytest.fixture(scope="module")
def engine(pair):
    return pair[1]


@pytest.fixture()
def make_batcher(engine):
    made = []

    def make(eng=engine, **kw):
        b = ContinuousBatcher(eng, **kw)
        made.append(b)
        return b

    yield make
    for b in made:
        b.close()


def _gated(make, eng, **kw):
    """A batcher whose scheduler waits on a gate: submissions queued before
    the gate opens form one admission wave."""
    gate = threading.Event()
    real_loop = ContinuousBatcher._loop

    def gated(self):
        gate.wait(timeout=WAIT)
        real_loop(self)

    ContinuousBatcher._loop = gated
    try:
        b = make(eng, **kw)
    finally:
        ContinuousBatcher._loop = real_loop
    return b, gate


def _single(engine, prompt, s):
    return engine.generate(prompt, s)


# -- plain continuous batching ------------------------------------------------------


def test_single_submission_matches_single_stream_and_jax(pair, make_batcher):
    je, te = pair
    s = SamplingParams(max_new_tokens=24, ignore_eos=True)
    got = make_batcher(max_batch=2).submit("continuous batching probe", s).result(timeout=WAIT)
    ref = _single(te, "continuous batching probe", s)
    assert got.token_ids == ref.token_ids
    assert got.text == ref.text
    assert (got.finish_reason, got.prompt_tokens) == (ref.finish_reason, ref.prompt_tokens)
    jref = je.generate("continuous batching probe", JaxSampling(max_new_tokens=24,
                                                                ignore_eos=True))
    assert got.token_ids == jref.token_ids


def test_concurrent_streams_and_oversubscription(engine, make_batcher):
    """Two streams of different lengths, then 5 streams through 2 slots:
    later submissions admit as earlier ones retire, all exact."""
    b = make_batcher(max_batch=2)
    s = SamplingParams(max_new_tokens=20, ignore_eos=True)
    prompts = ["first stream", "the second, rather longer, stream prompt"]
    prompts += [f"queued stream number {i}" for i in range(5)]
    futs = [b.submit(p, s) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.result(timeout=WAIT).token_ids == _single(engine, p, s).token_ids, p


def test_admission_mid_flight_and_per_stream_max_new(engine, make_batcher):
    b = make_batcher(max_batch=2)
    s_long = SamplingParams(max_new_tokens=48, ignore_eos=True)
    s_short = SamplingParams(max_new_tokens=8, ignore_eos=True)
    f1 = b.submit("long running stream", s_long)
    time.sleep(0.3)  # let it start decoding
    f2 = b.submit("late arrival", s_short)
    r1, r2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
    assert r1.token_ids == _single(engine, "long running stream", s_long).token_ids
    assert r2.token_ids == _single(engine, "late arrival", s_short).token_ids
    assert (len(r1.token_ids), len(r2.token_ids)) == (48, 8)


def test_streaming_callback_order(make_batcher):
    chunks: list[str] = []
    got = make_batcher(max_batch=2).submit(
        "stream text callback", SamplingParams(max_new_tokens=10, ignore_eos=True),
        on_text=chunks.append).result(timeout=WAIT)
    assert "".join(chunks) == got.text and got.text


def test_cancellation_does_not_kill_neighbors(engine, make_batcher):
    b = make_batcher(max_batch=2)
    ctx = Context.background().with_cancel()
    started = threading.Event()
    f_cancel = b.submit("doomed", SamplingParams(max_new_tokens=220, ignore_eos=True),
                        ctx=ctx, on_text=lambda _t: started.set())
    s_live = SamplingParams(max_new_tokens=30, ignore_eos=True)
    f_live = b.submit("survivor stream", s_live)
    assert started.wait(timeout=WAIT)
    ctx.cancel()
    r_cancel, r_live = f_cancel.result(timeout=WAIT), f_live.result(timeout=WAIT)
    assert r_cancel.finish_reason == "cancelled" and len(r_cancel.token_ids) < 220
    assert r_live.finish_reason == "length"
    assert r_live.token_ids == _single(engine, "survivor stream", s_live).token_ids


def test_sampling_shape_close_and_eos(engine, make_batcher):
    b = make_batcher(max_batch=1)
    s = SamplingParams(max_new_tokens=6)  # respects EOS
    fut = b.submit("eos probe", s)
    with pytest.raises(ValueError, match="sampling shape"):
        b.submit("sampled", SamplingParams(max_new_tokens=4, temperature=0.7))
    r, ref = fut.result(timeout=WAIT), _single(engine, "eos probe", s)
    assert (r.finish_reason, r.token_ids) == (ref.finish_reason, ref.token_ids)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("too late", SamplingParams(max_new_tokens=4))


def test_queued_deadline_and_close_cancel_queued(engine, make_batcher):
    from concurrent.futures import CancelledError

    b = make_batcher(max_batch=1)
    blocker = b.submit("occupies the only slot",
                       SamplingParams(max_new_tokens=200, ignore_eos=True))
    ctx = Context.background().with_timeout(0.05)
    time.sleep(0.1)
    doomed = b.submit("never admitted", SamplingParams(max_new_tokens=50), ctx=ctx)
    r = doomed.result(timeout=WAIT)
    assert r.finish_reason == "deadline" and r.token_ids == []
    queued = b.submit("never admitted before close",
                      SamplingParams(max_new_tokens=200, ignore_eos=True))
    b.close()
    blocker.result(timeout=WAIT)  # the in-flight stream finishes
    try:
        assert queued.result(timeout=10).token_ids is not None
    except CancelledError:
        pass


def test_many_streams_from_threads(engine, make_batcher):
    b = make_batcher(max_batch=2)
    s = SamplingParams(max_new_tokens=6, ignore_eos=True)
    prompts = [f"stress prompt {i}" for i in range(8)]
    futs, lock = {}, threading.Lock()

    def submit(p):
        f = b.submit(p, s)
        with lock:
            futs[p] = f

    threads = [threading.Thread(target=submit, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    for p, f in futs.items():
        assert f.result(timeout=WAIT).token_ids == _single(engine, p, s).token_ids, p


def test_long_prompt_waits_for_frontier_and_cache_tail_parity(engine, make_batcher):
    b = make_batcher(max_batch=2)
    s = SamplingParams(max_new_tokens=10, ignore_eos=True)
    short = b.submit("tiny", s)
    long_prompt = "a deliberately much longer prompt " * 4
    longf = b.submit(long_prompt, s)
    assert short.result(timeout=WAIT).token_ids == _single(engine, "tiny", s).token_ids
    assert longf.result(timeout=WAIT).token_ids == _single(engine, long_prompt, s).token_ids
    # A window reaching cache capacity emits every token the single-stream
    # engine would (1-step tail chunks).
    tail = "tail parity " * 16
    s = SamplingParams(max_new_tokens=500, ignore_eos=True)
    r = make_batcher(max_batch=1).submit(tail, s).result(timeout=WAIT)
    ref = _single(engine, tail, s)
    assert r.finish_reason == ref.finish_reason == "length"
    assert r.token_ids == ref.token_ids


def test_waterline_compaction_gives_fresh_runway(pair, make_batcher):
    """6 streams x (prompt ~25 + 60 new) through 2 slots of a 256-slot cache:
    the shared frontier must compact, and every stream stays exact (JAX
    engine too)."""
    je, te = pair
    b = make_batcher(max_batch=2)
    s = SamplingParams(max_new_tokens=60, ignore_eos=True)
    prompts = [f"compaction wave stream {i}" for i in range(6)]
    futs = [b.submit(p, s) for p in prompts]
    for i, (p, f) in enumerate(zip(prompts, futs)):
        r = f.result(timeout=WAIT)
        assert r.finish_reason == "length"
        assert r.token_ids == _single(te, p, s).token_ids, p
        if i == 5:
            assert r.token_ids == je.generate(p, JaxSampling(max_new_tokens=60,
                                                             ignore_eos=True)).token_ids


def test_compact_cache_shifts_in_place_like_a_roll(engine):
    """The in-place per-layer shift equals jnp.roll's valid region (slots
    below capacity - shift), for the bf16 stack and the int8 codes and
    seq-minor scales."""
    for quant in (None, "int8"):
        cache = init_kv_cache(engine.cfg, 2, 32, device=torch.device("cpu"),
                              dtype=torch.float32, quant=quant)
        leaves = ([cache["k"], cache["v"]] if quant is None
                  else [cache[s][x] for s in ("k", "v") for x in ("q8", "s")])
        for i, leaf in enumerate(leaves):
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=torch.Generator()
                                     .manual_seed(i)).to(leaf.dtype))
        before = [leaf.clone() for leaf in leaves]
        batcher_mod.compact_cache(cache, 5)
        for leaf, old in zip(leaves, before):
            ax = 2 if leaf.dim() == 5 else 3
            rolled = torch.roll(old, -5, dims=ax)
            assert torch.equal(leaf.narrow(ax, 0, 27), rolled.narrow(ax, 0, 27))


def test_splice_refuses_an_overrun(engine):
    cpu = torch.device("cpu")
    pool = init_kv_cache(engine.cfg, 2, 32, device=cpu, dtype=torch.float32)
    src = init_kv_cache(engine.cfg, 1, 16, device=cpu, dtype=torch.float32)
    with pytest.raises(ValueError, match="overruns capacity"):
        batcher_mod.splice_rows(pool, src, [0], [1], [20], 16)
    batcher_mod.splice_rows(pool, src, [0], [1], [16], 16)  # exactly fits


# -- batched admission --------------------------------------------------------------


def test_burst_batched_admission_exact(engine, make_batcher, monkeypatch):
    """A same-instant burst takes one batched prefill (no per-stream
    prefill), including prompts that span prefill buckets."""
    b, gate = _gated(make_batcher, engine, max_batch=4)
    calls = {"rows": 0, "single": 0}
    real_rows, real_ids = Engine._prefill_rows, Engine._prefill_ids

    def count_rows(self, rows):
        calls["rows"] += 1
        return real_rows(self, rows)

    def count_ids(self, ids):
        calls["single"] += 1
        return real_ids(self, ids)

    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    prompts = ["a", "burst admission stream two",
               "a deliberately rather longer burst admission prompt " * 2, "stream four"]
    monkeypatch.setattr(Engine, "_prefill_rows", count_rows)
    monkeypatch.setattr(Engine, "_prefill_ids", count_ids)
    futs = [b.submit(p, s) for p in prompts]
    gate.set()
    results = [f.result(timeout=WAIT) for f in futs]
    monkeypatch.undo()
    assert calls == {"rows": 1, "single": 0}
    for p, r in zip(prompts, results):
        assert r.token_ids == _single(engine, p, s).token_ids, p


def test_burst_admission_chunked_wave_exact(make_batcher):
    """A wave whose bucket exceeds prefill_chunk prefills in chunks (the
    plain op at a running start, per-row last-token logits)."""
    eng = Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=256,
                 stream_interval=8, prefill_chunk=32, device="cpu")
    b, gate = _gated(make_batcher, eng, max_batch=4)
    s = SamplingParams(max_new_tokens=10, ignore_eos=True)
    prompts = ["short one", "a chunked admission prompt that spans chunks " * 2, "mid length x"]
    futs = [b.submit(p, s) for p in prompts]
    gate.set()
    for p, f in zip(prompts, futs):
        assert f.result(timeout=WAIT).token_ids == eng.generate(p, s).token_ids, p


def test_burst_admission_prefill_failure_falls_back_to_singles(engine, make_batcher,
                                                              monkeypatch):
    b, gate = _gated(make_batcher, engine, max_batch=4)

    def boom(self, rows):
        raise RuntimeError("injected batched prefill failure")

    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    prompts = [f"fallback wave {i}" for i in range(3)]
    monkeypatch.setattr(Engine, "_prefill_rows", boom)
    futs = [b.submit(p, s) for p in prompts]
    gate.set()
    results = [f.result(timeout=WAIT) for f in futs]
    monkeypatch.undo()
    for p, r in zip(prompts, results):
        assert r.token_ids == _single(engine, p, s).token_ids, p


def test_burst_batched_admission_int8_kv_exact(make_batcher):
    """Batched admission splices int8 cache trees (codes + seq-minor
    scales): tokens equal the same engine single-stream and the JAX engine
    with the int8 cache."""
    je, te = _engines(kv_quant="int8")
    b, gate = _gated(make_batcher, te, max_batch=3)
    s = SamplingParams(max_new_tokens=10, ignore_eos=True)
    prompts = [f"quantized burst stream {i}" for i in range(3)]
    futs = [b.submit(p, s) for p in prompts]
    gate.set()
    for p, f in zip(prompts, futs):
        got = f.result(timeout=WAIT).token_ids
        assert got == _single(te, p, s).token_ids, p
        assert got == je.generate(p, JaxSampling(max_new_tokens=10, ignore_eos=True)).token_ids


# -- shared prefix -------------------------------------------------------------------


def test_shared_prefix_wave_matches_single_stream_and_jax(pair, make_batcher):
    je, te = pair
    b = make_batcher(max_batch=4, pool_prefix_min=64)
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    prompts = [f"{PREFIX} stream number {i}" for i in range(4)]
    futs = [b.submit(p, s) for p in prompts]
    results = [f.result(timeout=WAIT) for f in futs]
    assert b._prefix_cache is not None  # sharing engaged
    assert b.snapshot()["prefix_len"] == b._prefix_len_host >= 64
    for p, r in zip(prompts, results):
        ref = _single(te, p, s)
        assert r.token_ids == ref.token_ids, p
        assert r.text == ref.text
        assert r.token_ids == je.generate(p, JaxSampling(max_new_tokens=16,
                                                         ignore_eos=True)).token_ids
    snap = b.snapshot()
    assert snap["decode_tokens"] > 0 and snap["decode_s"] > 0 and snap["establish_s"] > 0
    assert (snap["admitted"], snap["establish_tokens"]) == (4, snap["prefix_len"])
    # Admission prefilled the suffixes only.
    assert snap["admit_tokens"] == sum(len(te.tokenizer.encode(p)) for p in prompts) \
        - 4 * snap["prefix_len"]


def test_followup_wave_joins_established_prefix(engine, make_batcher):
    b = make_batcher(max_batch=4, pool_prefix_min=64)
    s = SamplingParams(max_new_tokens=24, ignore_eos=True)
    first = [b.submit(f"{PREFIX} early {i}", s) for i in range(2)]
    time.sleep(0.5)  # the first wave establishes and decodes
    second = [b.submit(f"{PREFIX} late {i}", s) for i in range(2)]
    for name, futs in (("early", first), ("late", second)):
        for i, f in enumerate(futs):
            assert f.result(timeout=WAIT).token_ids == _single(
                engine, f"{PREFIX} {name} {i}", s).token_ids
    assert b._prefix_cache is not None


def test_non_matching_stream_next_to_prefix_rows(engine, make_batcher):
    """A prompt that does not share the pool prefix decodes in a slot next
    to prefix rows (whole prompt in its own window, prefix flag off)."""
    b = make_batcher(max_batch=4, pool_prefix_min=64)
    s_shared = SamplingParams(max_new_tokens=120, ignore_eos=True)
    s_other = SamplingParams(max_new_tokens=16, ignore_eos=True)
    shared = [f"{PREFIX} q{i}" for i in range(2)]
    futs = [b.submit(p, s_shared) for p in shared]
    deadline = time.monotonic() + WAIT
    while not any(st is not None and st.out_ids for st in list(b._slots)):
        assert time.monotonic() < deadline
        time.sleep(0.005)  # until the prefix rows decode
    other = "an unrelated prompt"
    r_other = b.submit(other, s_other).result(timeout=WAIT)
    assert not any(f.done() for f in futs)  # it ran beside the prefix rows
    assert r_other.token_ids == _single(engine, other, s_other).token_ids
    for p, f in zip(shared, futs):
        assert f.result(timeout=WAIT).token_ids == _single(engine, p, s_shared).token_ids
    assert b._prefix_cache is not None


@pytest.mark.parametrize("kw,prompts", [
    ({"pool_prefix_min": 64}, [f"short {i} prompt with little shared text" for i in range(3)]),
    ({"pool_prefix_min": 64, "pool_prefix": False}, [f"{PREFIX} off {i}" for i in range(3)]),
], ids=["short-common-prefix", "pool-prefix-off"])
def test_sharing_disabled_stays_exact(engine, make_batcher, kw, prompts):
    b = make_batcher(max_batch=4, **kw)
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    futs = [b.submit(p, s) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.result(timeout=WAIT).token_ids == _single(engine, p, s).token_ids
    assert b._prefix_cache is None and b.snapshot()["prefix_len"] == 0


def test_prefix_pool_compaction_stays_exact(make_batcher):
    """Suffix windows hitting the waterline mid-decode stay exact (the
    prefix itself never moves), against the JAX engine too."""
    je, te = _engines(max_seq=160)
    b = make_batcher(te, max_batch=2, pool_prefix_min=64)
    s = SamplingParams(max_new_tokens=40, ignore_eos=True)
    prompts = [f"{PREFIX} compaction probe {i}" for i in range(2)]
    first = [b.submit(p, s) for p in prompts]
    for f in first:
        f.result(timeout=WAIT)
    # A second wave joins the prefix at a frontier near capacity.
    prompts2 = [f"{PREFIX} second wave {i} with a longer suffix" for i in range(2)]
    futs = first + [b.submit(p, s) for p in prompts2]
    assert b._prefix_cache is not None
    for p, f in zip(prompts + prompts2, futs):
        r, ref = f.result(timeout=WAIT), _single(te, p, s)
        assert r.token_ids == ref.token_ids, p
        assert r.finish_reason == ref.finish_reason
        assert r.token_ids == je.generate(p, JaxSampling(max_new_tokens=40,
                                                         ignore_eos=True)).token_ids


def test_oversized_dense_prefix_falls_back_to_no_sharing(make_batcher):
    eng = Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=256,
                 stream_interval=8, device="cpu", prefix_cache_max_mb=0.001)
    b = make_batcher(eng, max_batch=4, pool_prefix_min=64)
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    prompts = [f"{PREFIX} big {i}" for i in range(2)]
    futs = [b.submit(p, s) for p in prompts]
    for p, f in zip(prompts, futs):
        assert f.result(timeout=WAIT).token_ids == eng.generate(p, s).token_ids
    assert b._prefix_cache is None


# -- what is not ported is refused ------------------------------------------------


def test_refuses_what_is_not_ported(engine):
    with pytest.raises(NotImplementedError, match="prefill_budget"):
        ContinuousBatcher(engine, max_batch=2, prefill_budget=512)
    for max_batch in (9, 16, 64):
        with pytest.raises(NotImplementedError, match="row-bucketing"):
            ContinuousBatcher(engine, max_batch=max_batch)
    with pytest.raises(ValueError, match="max_batch"):
        ContinuousBatcher(engine, max_batch=0)
    b = ContinuousBatcher(engine, max_batch=8)  # 8 rows run as in the JAX batcher
    try:
        s = SamplingParams(max_new_tokens=4, ignore_eos=True)
        assert b.submit("eight rows", s).result(timeout=WAIT).token_ids == _single(
            engine, "eight rows", s).token_ids
    finally:
        b.close()


# -- mixture of experts ------------------------------------------------------------


def _jax_gated(eng, max_batch):
    """The JAX batcher gated the same way: one deterministic wave."""
    from llm_consensus_tpu.engine.batcher import ContinuousBatcher as JaxBatcher

    gate = threading.Event()
    real_loop = JaxBatcher._loop

    def gated(self):
        gate.wait(timeout=WAIT)
        real_loop(self)

    JaxBatcher._loop = gated
    try:
        b = JaxBatcher(eng, max_batch=max_batch)
    finally:
        JaxBatcher._loop = real_loop
    return b, gate


@pytest.mark.parametrize("modes", [{}, {"kv_quant": "int8"}], ids=["f32", "int8-kv"])
def test_mixtral_wave_matches_the_jax_batcher(make_batcher, modes):
    """tiny-mixtral with 8 experts in a 4-slot pool: a decode step routes 4
    rows, so each expert holds int(2 * 4 * 2 / 8) = 2 slots and a step can
    drop a row's choice, which makes a stream's tokens depend on its
    neighbours. The port's batcher must then decode what the JAX batcher
    decodes: the same rows (idle and pad rows included) in the same order,
    so the same tokens for every stream of one gated wave."""
    je, te = _engines(preset="tiny-mixtral", overrides={"n_experts": 8}, **modes)
    prompts = ["mixture of experts stream one", "two", "stream three of the wave, longer",
               "the fourth"]
    sp = dict(max_new_tokens=20, ignore_eos=True)
    jb, jgate = _jax_gated(je, 4)
    try:
        jfuts = [jb.submit(p, JaxSampling(**sp)) for p in prompts]
        jgate.set()
        want = [f.result(timeout=WAIT).token_ids for f in jfuts]
    finally:
        jb.close()
    b, gate = _gated(make_batcher, te, max_batch=4)
    futs = [b.submit(p, SamplingParams(**sp)) for p in prompts]
    gate.set()
    got = [f.result(timeout=WAIT).token_ids for f in futs]
    assert got == want
    # Drops happened: some stream decoded otherwise than alone.
    assert got != [te.generate(p, SamplingParams(**sp)).token_ids for p in prompts]
