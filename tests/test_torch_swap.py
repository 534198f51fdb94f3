"""The port's live weight hot-swap (``Engine.swap_weights``, its pins and
double buffer, the batcher's pins and admission gate, the provider's
``swap_weights``) against the JAX engine's, on tiny-llama in float32 (the
swap cases of tests/test_flywheel.py and the provider's digest refusal of
tests/test_integrity.py).

Both engines start from the same JAX parameter tree and receive the same
second tree (numpy arrays, another seed); every version decision, every
stat, and the greedy tokens before, across and after each flip must agree.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import ContinuousBatcher as JaxBatcher
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.faults import FaultPlan as JaxFaultPlan
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.faults import FaultPlan
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.providers.gpu import GPUProvider

WAIT = 300
PROMPT = "the judge weighs every panel answer before the verdict"


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
    for knob in ("LLMC_FAULTS", "LLMC_INTEGRITY", "LLMC_KV_POOL", "LLMC_PREFIX_CACHE"):
        monkeypatch.delenv(knob, raising=False)
    faults.reset()
    integrity.reset()
    obs.reset_planes()
    yield
    faults.reset()
    integrity.reset()
    obs.reset_planes()


def _jax_tree(seed: int):
    return jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(seed), dtype=jnp.float32)


def _port_tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), get_config("tiny-llama"),
                             torch.device("cpu"), torch.float32)


@pytest.fixture(scope="module")
def trees():
    """Seed 0 (resident) and seed 3 (the swap) in both layouts."""
    j0, j3 = _jax_tree(0), _jax_tree(3)
    return {"jax": (j0, j3), "torch": (_port_tree(j0), _port_tree(j3))}


def _engines(trees, **kw):
    je = JaxEngine(jax_config("tiny-llama"), params=trees["jax"][0], dtype=jnp.float32,
                   max_seq=128, **kw)
    te = Engine(get_config("tiny-llama"), params=trees["torch"][0], dtype=torch.float32,
                max_seq=128, device="cpu", **kw)
    return je, te


def _stats(eng) -> dict:
    st = eng.swap_stats()
    return {k: v for k, v in st.items() if k not in ("last_vacate_ms", "last_prep_ms")}


def test_swap_versions_are_monotone(trees):
    out = []
    for eng, (_t0, t3) in zip(_engines(trees), (trees["jax"], trees["torch"])):
        seq = [eng.swap_weights(0, t3), eng.swap_weights(3, t3), eng.weight_version,
               eng.swap_weights(3, t3), eng.swap_weights(2, t3)]
        out.append((seq, _stats(eng)))
    assert out[0] == out[1]
    assert out[1][0] == [False, True, 3, False, False]
    assert out[1][1]["swaps"] == 1 and out[1][1]["swap_rejects"] == 3


def test_swap_parks_under_pin_applies_on_last_unpin(trees):
    out = []
    for eng, (t0, t3) in zip(_engines(trees), (trees["jax"], trees["torch"])):
        resident = eng.params
        seq = [eng.pin_weights()]
        eng.pin_weights()
        seq.append(eng.swap_weights(1, t3, meta={"corpus": "abc"}))
        seq += [eng.weight_version, eng.params is resident, eng.swap_pending()]
        eng.unpin_weights()
        seq += [eng.weight_version, eng.swap_pending()]
        eng.unpin_weights()
        seq += [eng.weight_version, eng.params is resident, eng.swap_pending(), eng.weight_meta]
        eng.unpin_weights()  # an extra unpin is ignored
        out.append((seq, _stats(eng)))
    assert out[0] == out[1]
    assert out[1][0] == [0, True, 0, True, True, 0, True, 1, False, False, {"corpus": "abc"}]
    assert out[1][1]["swap_queued"] == 1


def test_rollback_restores_previous_buffer_under_new_version(trees):
    out = []
    for eng, (_t0, t3) in zip(_engines(trees), (trees["jax"], trees["torch"])):
        resident = eng.params
        none_first = eng.rollback_weights()
        assert eng.swap_weights(1, t3) is True
        rb = eng.rollback_weights({"reason": "canary"})
        out.append((none_first, rb, eng.weight_version, eng.params is resident,
                    eng.weight_meta, _stats(eng)))
    assert out[0] == out[1]
    assert out[1][:4] == (None, 2, 2, True)
    assert out[1][4] == {"reason": "canary", "rolled_back_to": 0, "rolled_back_from": 1}


def test_swap_mid_stream_injection_fires_at_apply(trees):
    je, te = _engines(trees)
    out = []
    for eng, plan, t3 in ((je, JaxFaultPlan("swap_mid_stream@s=0.01@times=-1"), trees["jax"][1]),
                          (te, FaultPlan("swap_mid_stream@s=0.01@times=-1"),
                           trees["torch"][1])):
        eng._faults = plan
        t0 = time.monotonic()
        assert eng.swap_weights(1, t3) is True
        assert time.monotonic() - t0 >= 0.01
        out.append((eng.weight_version, [t for t in plan.trace if "swap_mid_stream" in t]))
    assert out[0] == out[1] and out[1][1]


def test_greedy_tokens_after_the_flip_equal_jax_on_the_new_weights(trees):
    je, te = _engines(trees)
    js = JaxSampling(max_new_tokens=24, ignore_eos=True)
    ts = SamplingParams(max_new_tokens=24, ignore_eos=True)
    before = (je.generate(PROMPT, js).token_ids, te.generate(PROMPT, ts).token_ids)
    assert before[0] == before[1]
    assert je.swap_weights(1, trees["jax"][1]) and te.swap_weights(1, trees["torch"][1])
    after = (je.generate(PROMPT, js).token_ids, te.generate(PROMPT, ts).token_ids)
    assert after[0] == after[1] and after[1] != before[1]
    fresh = Engine(get_config("tiny-llama"), params=trees["torch"][1], dtype=torch.float32,
                   max_seq=128, device="cpu")
    assert fresh.generate(PROMPT, ts).token_ids == after[1]
    assert te.rollback_weights() == 2 and je.rollback_weights() == 2
    back = (je.generate(PROMPT, js).token_ids, te.generate(PROMPT, ts).token_ids)
    assert back[0] == back[1] == before[1]


def test_pinned_stream_bytes_identical_across_swap(trees):
    """A stream admitted before the swap decodes to its last byte on the
    weights it started with; the flip lands when the pins drain, in both
    batchers."""
    out = []
    for eng, sampling, bcls, t3 in (
            (_engines(trees)[0], JaxSampling(max_new_tokens=48, ignore_eos=True), JaxBatcher,
             trees["jax"][1]),
            (_engines(trees)[1], SamplingParams(max_new_tokens=48, ignore_eos=True),
             ContinuousBatcher, trees["torch"][1])):
        ref = eng.generate(PROMPT, sampling)
        b = bcls(eng, max_batch=2)
        try:
            fut = b.submit(PROMPT, sampling)
            deadline = time.time() + WAIT
            while time.time() < deadline and eng.swap_stats()["pins"] == 0:
                time.sleep(0.002)
            assert eng.swap_stats()["pins"] > 0, "stream never pinned"
            assert eng.swap_weights(1, t3) is True
            r = fut.result(timeout=WAIT)
            assert r.token_ids == ref.token_ids and r.text == ref.text
            deadline = time.time() + WAIT
            while time.time() < deadline and eng.weight_version < 1:
                time.sleep(0.005)
            assert eng.weight_version == 1
            # The next stream runs on the new weights.
            nxt = b.submit(PROMPT, sampling).result(timeout=WAIT)
            out.append((r.token_ids, nxt.token_ids, eng.swap_stats()["pins"]))
        finally:
            b.close()
    assert out[0] == out[1]
    assert out[1][0] != out[1][1] and out[1][2] == 0


def test_swap_pending_holds_admission_until_the_resident_set_vacates(trees):
    """The port's gate: a stream submitted while a swap is parked waits at
    the queue head, then runs on the new weights, while the resident
    stream finishes on the old ones. The resident's first decode dispatch
    waits on a gate until the swap is parked and the later stream queued,
    so it is still resident with most of its tokens to go when the
    scheduler next plans admission."""
    cfg = get_config("tiny-llama")
    te = Engine(cfg, params=trees["torch"][0], dtype=torch.float32, max_seq=512, device="cpu")
    fresh = Engine(cfg, params=trees["torch"][1], dtype=torch.float32, max_seq=512,
                   device="cpu")
    long = SamplingParams(max_new_tokens=64, ignore_eos=True)
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    want = fresh.generate("a later question", s).token_ids
    ref = te.generate(PROMPT, long).token_ids
    b = ContinuousBatcher(te, max_batch=2)
    gate, held = threading.Event(), threading.Event()

    def gated_dispatch(*a, **k):
        held.set()
        gate.wait(timeout=WAIT)
        return ContinuousBatcher._dispatch(b, *a, **k)

    b._dispatch = gated_dispatch
    try:
        first = b.submit(PROMPT, long)
        assert held.wait(timeout=WAIT)  # admitted, its first decode chunk held
        time.sleep(0.3)  # past the admission pass's burst absorption
        assert te.swap_stats()["pins"] == 1 and not first.done()
        assert te.swap_weights(1, trees["torch"][1]) is True
        assert te.swap_pending()
        later = b.submit("a later question", s)
        time.sleep(0.05)
        gate.set()
        assert later.result(timeout=WAIT).token_ids == want
        assert first.result(timeout=WAIT).token_ids == ref
        assert te.weight_version == 1 and te.swap_stats()["pins"] == 0
    finally:
        gate.set()
        b.close()


PREAMBLE = ("a shared consensus prompt prefix that every stream of the wave "
            "carries verbatim before its own question suffix begins")


def _prefix_engines(trees, **kw):
    """The resident engine (seed 0, ``kw``) and a fresh one on seed 3."""
    cfg = get_config("tiny-llama")
    te = Engine(cfg, params=trees["torch"][0], dtype=torch.float32, max_seq=512, device="cpu",
                **kw)
    fresh = Engine(cfg, params=trees["torch"][1], dtype=torch.float32, max_seq=512,
                   device="cpu")
    return te, fresh


@pytest.mark.parametrize("kv_pool", [False, True])
def test_swap_during_prefix_establishment_drops_the_old_prefix(trees, kv_pool):
    """A swap arriving while the batcher prefills a wave's shared prefix
    parks under the establishment's pin and flips at its unpin: the old
    weights' prefix (and its pool blocks) is dropped, and the wave runs on
    the new weights."""
    kw = {"prefill_chunk": 16, "kv_pool": True, "kv_pool_block": 16} if kv_pool else {}
    te, fresh = _prefix_engines(trees, **kw)
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    prompts = [f"{PREAMBLE} question {i}" for i in range(2)]
    want = [fresh.generate(p, s).token_ids for p in prompts]
    real, parked = te._prefill_ids, []

    def prefill_then_swap(*a, **k):
        out = real(*a, **k)  # the establishment's prefill, the first call
        if not parked:
            parked.extend([te.swap_weights(1, trees["torch"][1]), te.swap_pending()])
        return out

    te._prefill_ids = prefill_then_swap
    b = ContinuousBatcher(te, max_batch=4, pool_prefix_min=64)
    try:
        got = [f.result(timeout=WAIT).token_ids for f in [b.submit(p, s) for p in prompts]]
    finally:
        b.close()
    assert parked == [True, True]
    assert te.weight_version == 1 and te.swap_stats()["pins"] == 0
    assert got == want
    # No old-weights KV stayed in the pool for a later hit.
    assert te.generate(prompts[0], s).token_ids == want[0]


def test_swap_before_a_wave_joins_the_prefix_requeues_the_wave(trees):
    """A flip on an idle pool between the established prefix's version
    check and the joining wave's pins: the wave goes back to the queue and
    re-plans on the new weights instead of attending the old prefix."""
    te, fresh = _prefix_engines(trees)
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    late = [f"{PREAMBLE} late {i}" for i in range(2)]
    b = ContinuousBatcher(te, max_batch=4, pool_prefix_min=64)
    try:
        for f in [b.submit(f"{PREAMBLE} early {i}", s) for i in range(2)]:
            f.result(timeout=WAIT)
        assert b._prefix_cache is not None and b._prefix_weight_version == 0
        real, flips = b._admit_batch, []

        def swap_then_admit(batch, prefix_p=0):
            if prefix_p and not flips:
                flips.append(te.swap_weights(1, trees["torch"][1]))  # no pins: flips now
            return real(batch, prefix_p)

        b._admit_batch = swap_then_admit
        got = [f.result(timeout=WAIT).token_ids for f in [b.submit(p, s) for p in late]]
    finally:
        b.close()
    assert flips == [True] and te.weight_version == 1
    assert got == [fresh.generate(p, s).token_ids for p in late]
    assert b._prefix_weight_version in (-1, 1)


def test_canary_regress_fires_on_swapped_decode(trees):
    out = []
    for eng, plan, bcls, sampling, t3 in (
            (_engines(trees)[0], JaxFaultPlan("canary_regress@s=0@times=-1"), JaxBatcher,
             JaxSampling(max_new_tokens=4, ignore_eos=True), trees["jax"][1]),
            (_engines(trees)[1], FaultPlan("canary_regress@s=0@times=-1"), ContinuousBatcher,
             SamplingParams(max_new_tokens=4, ignore_eos=True), trees["torch"][1])):
        eng._faults = plan
        b = bcls(eng, max_batch=2)
        try:
            b.submit("probe", sampling).result(timeout=WAIT)
            unswapped = [t for t in plan.trace if "canary_regress" in t]
            assert eng.swap_weights(1, t3) is True
            b.submit("probe", sampling).result(timeout=WAIT)
            eng.generate("probe", sampling)  # the single-stream loop fires too
            fired = [t for t in plan.trace if "canary_regress" in t]
            out.append((unswapped, len(fired) >= 2))
        finally:
            eng._faults = None
            b.close()
    assert out[0][0] == out[1][0] == [] and out[1][1] and out[0][1]


def test_flip_drops_the_prefix_snapshot_and_the_pools_cold_blocks(trees):
    _, te = _engines(trees)
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    te.generate(PROMPT, s)
    assert te._prefix_ids is not None
    assert te.swap_weights(1, trees["torch"][1]) is True
    assert te._prefix_ids is None and te._prefix_cache is None
    pooled = Engine(get_config("tiny-llama"), params=trees["torch"][0], dtype=torch.float32,
                    max_seq=128, device="cpu", prefill_chunk=16, kv_pool=True,
                    kv_pool_block=16)
    pooled.generate(PROMPT, s)
    assert pooled._kv_pool.stats()["blocks_used"] > 0
    assert pooled.swap_weights(1, trees["torch"][1]) is True
    assert pooled._kv_pool.stats()["blocks_used"] == 0
    # Reuse after the flip prefills afresh and matches a fresh engine.
    fresh = Engine(get_config("tiny-llama"), params=trees["torch"][1], dtype=torch.float32,
                   max_seq=128, device="cpu", prefill_chunk=16)
    assert pooled.generate(PROMPT, s).token_ids == fresh.generate(PROMPT, s).token_ids


def test_prefill_session_re_prefills_after_a_swap(trees):
    """An overlap session whose chunks were prefilled before a swap
    re-prefills under the new weights at generate: its tokens equal a
    fresh engine's on the new weights."""
    te = Engine(get_config("tiny-llama"), params=trees["torch"][0], dtype=torch.float32,
                max_seq=128, device="cpu", prefill_chunk=16)
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    sess = te.prefill_session()
    sess.append_text(PROMPT + " and the panel answers")
    assert sess.prefilled > 0
    assert te.swap_weights(1, trees["torch"][1]) is True
    got = sess.generate(s).token_ids
    fresh = Engine(get_config("tiny-llama"), params=trees["torch"][1], dtype=torch.float32,
                   max_seq=128, device="cpu", prefill_chunk=16)
    assert got == fresh.generate(PROMPT + " and the panel answers", s).token_ids
    assert te.swap_stats()["pins"] == 0


def test_provider_swap_from_a_checkpoint_and_its_digest_refusal(trees, tmp_path):
    """The provider loads an HF safetensors directory into the engine's
    mode; with the integrity plane on, a stamped digest is verified first
    and ``bit_flip@surface=ckpt`` is refused as ``params_digest_mismatch``
    with nothing installed; the clean retry installs."""
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from tests.test_hf_golden import _make_hf_checkpoint

    ckpt = str(tmp_path / "tiny-llama")
    _make_hf_checkpoint(jax_config("tiny-llama"), ckpt, seed=7)
    prov = GPUProvider(device="cpu", max_seq=128, ignore_eos=True)
    try:
        eng = prov._engine_for("gpu:tiny-llama")
        s = SamplingParams(max_new_tokens=12, ignore_eos=True)
        out = prov.swap_weights("gpu:tiny-llama", ckpt)
        assert out["accepted"] and out["weight_version"] == 1
        assert eng.weight_meta["checkpoint"] == ckpt
        loaded = Engine(get_config("tiny-llama"), params=try_load_params(
            get_config("tiny-llama"), ckpt, device=torch.device("cpu")), max_seq=128,
            device="cpu")
        assert eng.generate(PROMPT, s).token_ids == loaded.generate(PROMPT, s).token_ids
        assert prov.rollback_weights("gpu:tiny-llama") == 2
        with pytest.raises(FileNotFoundError):
            prov.swap_weights("gpu:tiny-llama", str(tmp_path / "missing"))
        plane = integrity.IntegrityPlane()
        integrity.install(plane)
        faults.install(FaultPlan("bit_flip@surface=ckpt", seed=4))
        meta = {"params_digest": integrity.digest_tree(trees["torch"][1])}
        out = prov.swap_weights("gpu:tiny-llama", trees["torch"][1], 3, meta=meta)
        assert out["accepted"] is False and out["rejected"] == "params_digest_mismatch"
        assert eng.weight_version == 2
        out = prov.swap_weights("gpu:tiny-llama", trees["torch"][1], 3, meta=meta)
        assert out["accepted"] is True and eng.weight_version == 3
        assert plane.stats()["checks"]["ckpt"] == 2 and plane.stats()["failures"]["ckpt"] == 1
        assert prov.weight_version() == 3
        assert set(prov.swap_stats()["tiny-llama"]) >= {"swaps", "rollbacks", "pins",
                                                        "swap_pending", "weight_version"}
    finally:
        prov.release()


def test_no_admission_reads_old_weight_kv_between_a_flip_and_its_hygiene(trees):
    """A flip drops the old weights' cached KV (prefix snapshot, KV pool)
    after it installs the new tree. A stream the batcher admits in that
    window would gather old-weight blocks and decode over them: the
    admission gate holds until the hygiene is done, so the stream prefills
    on the new weights and equals a fresh engine's tokens."""
    cfg = get_config("tiny-llama")
    te = Engine(cfg, params=trees["torch"][0], dtype=torch.float32, max_seq=512, device="cpu",
                prefill_chunk=16, kv_pool=True, kv_pool_block=16)
    fresh = Engine(cfg, params=trees["torch"][1], dtype=torch.float32, max_seq=512,
                   device="cpu")
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    prompt = f"{PREAMBLE} and its question"
    want = fresh.generate(prompt, s).token_ids
    b = ContinuousBatcher(te, max_batch=2)
    entered, gate = threading.Event(), threading.Event()
    try:
        b.submit(prompt, s).result(timeout=WAIT)  # the old weights' blocks, published
        assert te._kv_pool.match_len(te.tokenizer.encode(prompt)) >= 16
        real = te._post_flip

        def held_hygiene():
            entered.set()
            gate.wait(timeout=WAIT)
            real()

        te._post_flip = held_hygiene
        swapper = threading.Thread(target=te.swap_weights, args=(1, trees["torch"][1]))
        swapper.start()
        assert entered.wait(timeout=WAIT) and te.weight_version == 1
        later = b.submit(prompt, s)
        time.sleep(0.3)  # the scheduler's admission passes run in the window
        gate.set()
        swapper.join(WAIT)
        assert later.result(timeout=WAIT).token_ids == want
    finally:
        gate.set()
        b.close()


def test_a_failed_flip_hygiene_still_opens_the_admission_gate(trees):
    """The flip's cache hygiene raising reaches the swap's caller, and the
    admission gate opens all the same: a later stream is admitted and runs
    on the new weights instead of waiting on ``swap_pending`` for good."""
    cfg = get_config("tiny-llama")
    te = Engine(cfg, params=trees["torch"][0], dtype=torch.float32, max_seq=512, device="cpu",
                prefill_chunk=16, kv_pool=True, kv_pool_block=16)
    fresh = Engine(cfg, params=trees["torch"][1], dtype=torch.float32, max_seq=512,
                   device="cpu")
    s = SamplingParams(max_new_tokens=6, ignore_eos=True)
    prompt = f"{PREAMBLE} and its question"
    b = ContinuousBatcher(te, max_batch=2)
    try:
        b.submit(prompt, s).result(timeout=WAIT)

        def broken_evict(_ttl):
            raise RuntimeError("eviction failed")

        te._kv_pool.evict_cold = broken_evict
        with pytest.raises(RuntimeError, match="eviction failed"):
            te.swap_weights(1, trees["torch"][1])
        assert te.weight_version == 1 and not te.swap_pending()
        fresh_prompt = "An unrelated request that shares no block with the first one"
        later = b.submit(fresh_prompt, s).result(timeout=WAIT)
        assert later.token_ids == fresh.generate(fresh_prompt, s).token_ids
    finally:
        b.close()
