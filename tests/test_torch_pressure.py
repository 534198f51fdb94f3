"""The port's priority classes and the batcher's preemption, abandonment and
health hooks (mirrors tests/test_pressure.py's batcher cases).

The load-bearing contract is the JAX one: a preempted-then-resumed greedy
stream emits exactly the tokens of an uninterrupted run. Here each stream
is held to the port's single-stream engine and to the JAX engine on the
same float32 weights (tiny-llama, max_seq 256, stream_interval 8,
prefill_chunk 16: the JAX file's settings; only its kvpool-off, spec-off
case, the KV pool and speculation being unported)."""

from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.pressure import priority as jax_priority
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.pressure import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NAMES,
    PRIORITY_NORMAL,
    parse_priority,
    priority_name,
    resolve_priority,
)

WAIT = 300


@pytest.fixture(autouse=True)
def _no_jax_prefix_reuse(monkeypatch):
    # Each JAX generate a fresh prefill (the single-stream references).
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")


# -- priority classes --------------------------------------------------------


def test_parse_priority_names_and_ints():
    assert parse_priority("high") == PRIORITY_HIGH
    assert parse_priority("Normal") == PRIORITY_NORMAL
    assert parse_priority(2) == PRIORITY_LOW
    assert parse_priority(" 1 ") == PRIORITY_NORMAL
    assert PRIORITY_NAMES == jax_priority.PRIORITY_NAMES
    for bad in ("urgent", 3, -1, True, 1.5, "1.5", None):
        with pytest.raises(ValueError) as ours:
            parse_priority(bad)
        with pytest.raises(ValueError) as theirs:
            jax_priority.parse_priority(bad)
        assert str(ours.value) == str(theirs.value)
    for p in (-3, 0, 1, 2, 9):
        assert priority_name(p) == jax_priority.priority_name(p)


@pytest.mark.parametrize("env", [{}, {"LLMC_PRESSURE_DEADLINE_HIGH_S": "30",
                                      "LLMC_PRESSURE_DEADLINE_LOW_S": "100"}])
def test_resolve_priority_like_jax(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for explicit, timeout_s in (("low", 1.0), (None, 5.0), (None, 15.0), (None, 50.0),
                                (None, 120.0), (None, 600.0), (None, 3600.0), (None, None),
                                (0, 3600.0)):
        assert resolve_priority(explicit, timeout_s) == jax_priority.resolve_priority(
            explicit, timeout_s), (explicit, timeout_s)


# -- batcher: preempt-and-resume -------------------------------------------------


def _pair(max_seq=256):
    jcfg, tcfg = jax_config("tiny-llama"), get_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, torch.device("cpu"),
                           torch.float32)
    common = dict(max_seq=max_seq, stream_interval=8, prefill_chunk=16)
    return (JaxEngine(jcfg, params=jp, dtype=jnp.float32, **common),
            Engine(tcfg, params=tp, dtype=torch.float32, device="cpu", **common))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture()
def make_batcher():
    made = []

    def make(eng, **kw):
        b = ContinuousBatcher(eng, **kw)
        made.append(b)
        return b

    yield make
    for b in made:
        b.close()


def _refs(pair, prompts, s):
    """The port's single-stream tokens, checked against the JAX engine's."""
    je, te = pair
    out = []
    for p in prompts:
        ours = te.generate(p, s).token_ids
        theirs = je.generate(p, JaxSampling(max_new_tokens=s.max_new_tokens,
                                            ignore_eos=s.ignore_eos)).token_ids
        assert ours == theirs, p
        out.append(ours)
    return out


def _run_contended(b, low_prompts, hi_prompt, s_low, s_hi):
    """Fill the 2-slot pool with LOWs, then submit a HIGH latecomer; on a
    loaded machine the LOWs may finish first, so retry (bounded) until a
    preemption was seen. Every attempt's results are returned."""
    for _attempt in range(4):
        before = b.snapshot()["preemptions"]
        futs = [b.submit(p, s_low, priority=PRIORITY_LOW) for p in low_prompts]
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            if sum(1 for st in b._slots if st is not None and st.out_ids) == 2:
                break
            time.sleep(0.002)
        r_hi = b.submit(hi_prompt, s_hi, priority=PRIORITY_HIGH).result(timeout=WAIT)
        r_low = [f.result(timeout=WAIT) for f in futs]
        if b.snapshot()["preemptions"] > before:
            return r_low, r_hi
    return r_low, r_hi


@pytest.mark.parametrize("pool,spec", [(False, False)], ids=["spec-off-kvpool-off"])
def test_preempt_resume_byte_identity_matrix(pair, make_batcher, pool, spec):
    """A HIGH latecomer preempts a LOW resident in a full pool, and every
    stream, the victim included, emits exactly the uncontended greedy
    tokens (the port's single-stream engine's and the JAX engine's)."""
    s_low = SamplingParams(max_new_tokens=48, ignore_eos=True)
    s_hi = SamplingParams(max_new_tokens=10, ignore_eos=True)
    low_prompts = [f"low class resident stream {i} body" for i in range(2)]
    hi_prompt = "high class latecomer"
    base_low = _refs(pair, low_prompts, s_low)
    (base_hi,) = _refs(pair, [hi_prompt], s_hi)
    b = make_batcher(pair[1], max_batch=2)
    r_low, r_hi = _run_contended(b, low_prompts, hi_prompt, s_low, s_hi)
    assert b.snapshot()["preemptions"] >= 1, b.snapshot()
    assert r_hi.token_ids == base_hi and not r_hi.preempted
    for i, r in enumerate(r_low):
        assert r.token_ids == base_low[i], f"victim stream {i} diverged"
        assert r.finish_reason == "length"
    assert any(r.preempted for r in r_low)
    # The victim's text covers its whole generation across the resume.
    victim = next(r for r in r_low if r.preempted)
    assert victim.text == pair[1].tokenizer.decode(victim.token_ids)


def test_preempt_resume_across_compaction(make_batcher):
    """A small max_seq forces a window slide while a preempted stream,
    resumed beside the other resident, is still decoding: tokens still
    exact. (At the JAX file's 96 slots and 60 tokens the port's resume
    waits for an idle pool, so the frontier resets and never compacts;
    128 slots and 90 tokens let it resume beside the resident and cross.)"""
    pair = _pair(max_seq=128)
    s_low = SamplingParams(max_new_tokens=90, ignore_eos=True)
    s_hi = SamplingParams(max_new_tokens=12, ignore_eos=True)
    low_prompts = ["compact lane one", "compact lane two longer prompt"]
    hi_prompt = "compact high latecomer"
    base_low = _refs(pair, low_prompts, s_low)
    (base_hi,) = _refs(pair, [hi_prompt], s_hi)
    b = make_batcher(pair[1], max_batch=2)
    r_low, r_hi = _run_contended(b, low_prompts, hi_prompt, s_low, s_hi)
    snap = b.snapshot()
    assert snap["preemptions"] >= 1 and snap["compactions"] >= 1, snap
    assert r_hi.token_ids == base_hi
    for i, r in enumerate(r_low):
        assert r.token_ids == base_low[i], f"victim {i}"


def test_no_preemption_within_one_class(pair, make_batcher):
    """Equal classes never preempt each other: a NORMAL latecomer waits for a
    slot like the FIFO pool."""
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    b = make_batcher(pair[1], max_batch=2)
    futs = [b.submit(f"same class stream {i}", s) for i in range(3)]
    for f in futs:
        f.result(timeout=WAIT)
    assert b.snapshot()["preemptions"] == 0


def test_preempt_disabled_never_preempts(pair, make_batcher):
    """``preempt=False`` (LLMC_PRESSURE_PREEMPT=0): a HIGH latecomer waits."""
    s_low = SamplingParams(max_new_tokens=24, ignore_eos=True)
    b = make_batcher(pair[1], max_batch=1, preempt=False)
    low = b.submit("low resident", s_low, priority=PRIORITY_LOW)
    while not (b._slots[0] is not None and b._slots[0].out_ids):
        time.sleep(0.002)
    hi = b.submit("high waits", SamplingParams(max_new_tokens=4, ignore_eos=True),
                  priority=PRIORITY_HIGH)
    hi.result(timeout=WAIT)
    assert low.result(timeout=WAIT).token_ids == pair[1].generate("low resident", s_low).token_ids
    assert b.snapshot()["preemptions"] == 0


def test_priority_orders_batcher_queue(pair, make_batcher):
    """With the one slot occupied, a queued HIGH overtakes queued LOWs
    (stable within a class)."""
    s = SamplingParams(max_new_tokens=24, ignore_eos=True)
    s_q = SamplingParams(max_new_tokens=4, ignore_eos=True)
    # Preemption off isolates the dequeue-ordering contract.
    b = make_batcher(pair[1], max_batch=1, preempt=False)
    first = b.submit("resident stream", s, priority=PRIORITY_HIGH)
    time.sleep(0.3)  # resident decoding; queue the rest
    done: list[str] = []

    def track(tag, fut):
        fut.result(timeout=WAIT)
        done.append(tag)

    futs = [("low", b.submit("queued low", s_q, priority=PRIORITY_LOW)),
            ("low2", b.submit("queued low two", s_q, priority=PRIORITY_LOW)),
            ("high", b.submit("queued high", s_q, priority=PRIORITY_HIGH))]
    ts = [threading.Thread(target=track, args=tf) for tf in futs]
    for t in ts:
        t.start()
    first.result(timeout=WAIT)
    for t in ts:
        t.join(timeout=WAIT)
    assert done == ["high", "low", "low2"], done


def test_preempt_nudge_and_replay_ids(pair, make_batcher):
    """``preempt()`` alone (no blocked higher class) preempts nothing, and
    ``submit_ids(replay_ids=...)`` resumes a stream decoded elsewhere:
    the replayed tokens count against max_new and the rest is exact."""
    te = pair[1]
    s = SamplingParams(max_new_tokens=20, ignore_eos=True)
    ref = te.generate("replayed stream", s)
    b = make_batcher(te, max_batch=2)
    b.preempt(2)
    ids = te.tokenizer.encode("replayed stream")
    chunks: list[str] = []
    r = b.submit_ids(ids, s, replay_ids=ref.token_ids[:7], on_text=chunks.append).result(
        timeout=WAIT)
    assert r.token_ids == ref.token_ids and r.text == ref.text == "".join(chunks)
    assert b.snapshot()["preemptions"] == 0
    # Replayed tokens that already reach max_new resolve at once.
    done = b.submit_ids(ids, s, replay_ids=ref.token_ids).result(timeout=WAIT)
    assert done.token_ids == ref.token_ids and done.finish_reason == "length"


# -- pool health ---------------------------------------------------------------


def test_abandon_fails_every_future_and_drops_late_tokens(pair, make_batcher):
    te = pair[1]
    b = make_batcher(te, max_batch=1)
    live = b.submit("abandoned while decoding", SamplingParams(max_new_tokens=200,
                                                               ignore_eos=True))
    while not (b._slots[0] is not None and b._slots[0].out_ids):
        time.sleep(0.002)
    stream = b._slots[0]
    queued = b.submit("abandoned while queued", SamplingParams(max_new_tokens=8))
    boom = RuntimeError("scheduler wedged")
    b.abandon(boom)
    assert b.failed_exc is boom
    with pytest.raises(RuntimeError, match="scheduler wedged"):
        live.result(timeout=WAIT)
    with pytest.raises(CancelledError):  # a queued future is cancelled, as in JAX
        queued.result(timeout=WAIT)
    n = len(stream.out_ids)
    time.sleep(0.3)  # chunks in flight arrive: their owner checks drop them
    assert len(stream.out_ids) == n and all(st is None for st in b._slots)
    b.abandon(RuntimeError("second"))  # idempotent: the first evidence stays
    assert b.failed_exc is boom
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("too late", SamplingParams(max_new_tokens=4))
    deadline = time.monotonic() + WAIT
    while b.busy():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_busy_heartbeat_and_pressure_snapshot(pair, make_batcher):
    b = make_batcher(pair[1], max_batch=2)
    assert not b.busy()
    assert b.pressure_snapshot() == {"live": 0, "cap": 2, "queued": 0, "preemptions": 0}
    time.sleep(0.2)
    assert b.heartbeat_age() >= 0.2  # an idle pool makes no progress
    fut = b.submit("heartbeat probe", SamplingParams(max_new_tokens=120, ignore_eos=True))
    seen_busy = False
    while not fut.done():
        if b.busy():
            seen_busy = True
            assert b.heartbeat_age() < 30
            snap = b.pressure_snapshot()
            assert snap["cap"] == 2 and snap["live"] + snap["queued"] <= 1
        time.sleep(0.01)
    fut.result(timeout=WAIT)
    assert seen_busy
    deadline = time.monotonic() + WAIT
    while b.busy():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    b.set_brownout(True)  # a classic pool ignores it
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    assert b.submit("brownout", s).result(timeout=WAIT).token_ids == pair[1].generate(
        "brownout", s).token_ids
