"""The port's cross-request paged KV pool (llm_consensus_tpu_torch/kv/)
against the JAX package's (mirrors tests/test_kv.py, the KV cases of
tests/test_integrity.py and tests/test_pressure.py, and the pool's HBM
sentinel case of tests/test_attrib.py).

  * **Radix**: each structural test runs against both ``RadixIndex``
    classes, and seeded random insert, match, cover, drop and evict
    sequences give equal matches, covered lengths and eviction order.
  * **Pool**: tiny-llama in float32, ``max_seq`` 256, ``prefill_chunk``
    16, block 16 (the JAX file's settings). Greedy tokens are identical
    with the pool on and off and equal to the JAX engine's with its pool
    on, for the float32 and int8 caches, and ``KVPool.stats()`` equals the
    JAX pool's key for key after the same request sequence.
  * **Faults and integrity**: ``pool_exhausted``, ``evict_storm``,
    ``hbm_squeeze@phase=publish`` and ``bit_flip@surface=kv`` fire at the
    JAX sites with the JAX counters, and never change a token.
  * **The port's own choices**: the ids published stop at the last KV the
    decode loop wrote; a pool hit restores by masking the gathered cache in
    place; the batcher's radix consult; the CLI's ``kv`` blocks against the
    JAX CLI's files.
"""

import io
import itertools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import integrity as jax_integrity
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.kv.radix import RadixIndex as JaxRadix
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.obs import attrib as jax_attrib
from llm_consensus_tpu.obs import blackbox as jax_blackbox
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine import engine as engine_mod
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.faults import FaultPlan
from llm_consensus_tpu_torch.kv import KVPool, RadixIndex, pool_for
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.obs.attrib import ChipTimeLedger
from llm_consensus_tpu_torch.obs.blackbox import FlightRecorder
from llm_consensus_tpu_torch.providers.gpu import GPUProvider

WAIT = 300
BLOCK = 16
RADIXES = pytest.mark.parametrize("Radix", [JaxRadix, RadixIndex], ids=["jax", "port"])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """No fault plan, integrity plane, recorder or ledger leaks between
    tests, in either package; the JAX engines read the pool knobs at
    construction, so each test sets its own."""
    for knob in ("LLMC_INTEGRITY", "LLMC_FAULTS", "LLMC_KV_POOL", "LLMC_KV_POOL_MB",
                 "LLMC_KV_POOL_BLOCK", "LLMC_INTEGRITY_SAMPLE", "LLMC_PREFIX_CACHE"):
        monkeypatch.delenv(knob, raising=False)
    mods = (faults, integrity, jax_faults, jax_integrity, jax_attrib, jax_blackbox)
    for mod in mods:
        mod.reset()
    obs.reset_planes()
    yield
    for mod in mods:
        mod.reset()
    obs.reset_planes()


# -- radix: insert / match / split (tests/test_kv.py, both classes) -----------------------


def _insert(idx, ids, slot_gen):
    """Plan + attach as the pool does (slots from a counter)."""
    node, _base, writes = idx.plan_insert(list(ids))
    slots = [next(slot_gen) for _ in writes]
    return idx.attach(node, writes, slots)


@RADIXES
def test_radix_insert_match_roundtrip(Radix):
    idx = Radix(4)
    slots = itertools.count()
    attached = _insert(idx, list(range(10)), slots)
    assert [len(b.tokens) for b in attached] == [4, 4, 2]
    n, chain = idx.match(list(range(10)))
    assert n == 10 and [b.slot for b in chain] == [b.slot for b in attached]
    assert idx.match(list(range(12)))[0] == 10
    assert idx.match(list(range(3)))[0] == 3
    assert idx.match([99, 98])[0] == 0


@RADIXES
def test_radix_split_on_block_divergence(Radix):
    idx = Radix(4)
    slots = itertools.count()
    a = [0, 1, 2, 3, 4, 5, 6, 7]
    b = [0, 1, 2, 3, 9, 9, 9, 9]
    got_a = _insert(idx, a, slots)
    got_b = _insert(idx, b, slots)
    assert len(got_a) == 2
    assert len(got_b) == 1  # only the divergent block writes
    assert idx.match(a)[0] == 8 and idx.match(b)[0] == 8
    assert len(idx.root.children) == 1  # one shared head block
    assert {x.slot for x in got_a}.isdisjoint({x.slot for x in got_b})


@RADIXES
def test_radix_mid_block_partial_match(Radix):
    idx = Radix(4)
    _insert(idx, [0, 1, 2, 3, 4, 5, 6, 7], itertools.count())
    n, chain = idx.match([0, 1, 2, 3, 4, 5, 99, 99])
    assert n == 6
    assert len(chain) == 2  # head block + partially matched tail block


@RADIXES
def test_radix_partial_tail_copy_on_write(Radix):
    idx = Radix(4)
    slots = itertools.count()
    short = _insert(idx, [0, 1, 2, 3, 4, 5], slots)      # full + partial tail
    longer = _insert(idx, [0, 1, 2, 3, 4, 5, 6, 7], slots)
    assert [len(b.tokens) for b in short] == [4, 2]
    assert [len(b.tokens) for b in longer] == [4]         # fresh (4,5,6,7)
    assert longer[0].slot not in {b.slot for b in short}  # COW, no rewrite
    assert idx.match([0, 1, 2, 3, 4, 5, 6, 7])[0] == 8
    assert idx.match([0, 1, 2, 3, 4, 5])[0] == 6


@RADIXES
def test_radix_covered_and_noop_insert(Radix):
    idx = Radix(4)
    _insert(idx, list(range(10)), itertools.count())
    assert idx.covered(list(range(10))) == 10
    assert idx.covered(list(range(8))) == 8
    assert idx.covered(list(range(12))) == 10
    assert idx.covered([5, 6]) == 0
    assert idx.plan_insert(list(range(10)))[2] == []
    assert idx.plan_insert(list(range(9)))[2] == []


@RADIXES
def test_radix_concurrent_attach_dedups(Radix):
    idx = Radix(4)
    ids = list(range(10))
    node1, _, writes1 = idx.plan_insert(ids)
    node2, _, writes2 = idx.plan_insert(ids)
    assert writes1 == writes2
    got1 = idx.attach(node1, writes1, [0, 1, 2])
    got2 = idx.attach(node2, writes2, [3, 4, 5])
    assert len(got1) == 3
    assert [len(b.tokens) for b in got2] == [2]  # only the partial tail
    assert got2[0].slot == 5  # slots 3, 4 unconsumed (the pool refunds them)


@RADIXES
def test_radix_evict_lru_leaves_skip_leased_and_interior(Radix):
    idx = Radix(4)
    slots = itertools.count()
    a = _insert(idx, list(range(12)), slots)            # 3-block chain
    b = _insert(idx, [0, 1, 2, 3, 7, 7, 7, 7], slots)   # branches off a[0]
    b[-1].refs += 1  # lease the divergent tail mid-gather
    assert idx.evict(100) == [a[2].slot, a[1].slot]
    b[-1].refs -= 1
    assert set(idx.evict(100)) == {b[-1].slot, a[0].slot}
    assert idx.entries == 0


@RADIXES
def test_radix_evict_order_is_lru(Radix):
    idx = Radix(4)
    slots = itertools.count()
    old = _insert(idx, [1, 1, 1, 1], slots)
    new = _insert(idx, [2, 2, 2, 2], slots)
    idx.match([1, 1, 1, 1])  # touch: the old chain becomes the most recent
    assert idx.evict(1) == [new[0].slot]
    assert idx.evict(1) == [old[0].slot]


def _find(idx, slot):
    stack = [idx.root]
    while stack:
        for child in stack.pop().children:
            if child.block.slot == slot:
                return child.block
            stack.append(child)
    return None


@pytest.mark.parametrize("seed", range(8))
def test_radix_random_sequences_equal_the_jax_index(seed):
    """Seeded random inserts, matches, covers, leases, drops and evictions
    on both indexes: every result, the eviction order included, is equal."""
    rng = np.random.default_rng(seed)
    bs = int(rng.integers(2, 6))
    jx, pt = JaxRadix(bs), RadixIndex(bs)
    next_slot = itertools.count()
    roots = [list(rng.integers(0, 5, size=int(rng.integers(1, 30)))) for _ in range(4)]
    leased: list = []

    def query():
        base = roots[int(rng.integers(len(roots)))]
        cut = int(rng.integers(0, len(base) + 1))
        return [int(t) for t in base[:cut]] + [
            int(t) for t in rng.integers(0, 5, size=int(rng.integers(0, 12)))]

    for _ in range(120):
        op = rng.choice(["insert", "match", "covered", "lease", "drop", "evict"],
                        p=[0.35, 0.25, 0.1, 0.1, 0.05, 0.15])
        if op == "insert":
            ids = query()
            (jn, jb, jw), (pn, pb, pw) = jx.plan_insert(ids), pt.plan_insert(ids)
            assert (jb, jw) == (pb, pw)
            slots = [next(next_slot) for _ in jw]
            ja, pa = jx.attach(jn, jw, slots), pt.attach(pn, pw, slots)
            assert [(b.slot, b.tokens) for b in ja] == [(b.slot, b.tokens) for b in pa]
            if rng.random() < 0.3:
                roots.append(ids)
        elif op == "match":
            ids = query()
            (jn_, jc), (pn_, pc) = jx.match(ids), pt.match(ids)
            assert (jn_, [b.slot for b in jc]) == (pn_, [b.slot for b in pc])
        elif op == "covered":
            ids = query()
            assert jx.covered(ids) == pt.covered(ids)
        elif op == "lease":
            ids = query()
            _, jc = jx.match(ids)
            _, pc = pt.match(ids)
            if jc:
                jc[-1].refs += 1
                pc[-1].refs += 1
                leased.append((jc[-1], pc[-1]))
            elif leased:
                jb_, pb_ = leased.pop(0)
                jb_.refs -= 1
                pb_.refs -= 1
        elif op == "drop":
            slot = int(rng.integers(0, max(1, next(next_slot))))
            jb_, pb_ = _find(jx, slot), _find(pt, slot)
            assert (jb_ is None) == (pb_ is None)
            if jb_ is not None:
                assert sorted(jx.drop(jb_)) == sorted(pt.drop(pb_))
        else:
            need = int(rng.integers(1, 6))
            assert jx.evict(need) == pt.evict(need)
        assert jx.entries == pt.entries
    assert jx.evict(10 ** 6) == pt.evict(10 ** 6)


# -- pool: real engines on the CPU (tests/test_kv.py) -----------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llama"),
                           torch.device("cpu"), torch.float32)
    return jp, tp


def _port(weights, pool: bool, **kw):
    kw.setdefault("prefill_chunk", 16)
    return Engine(get_config("tiny-llama"), params=weights[1], dtype=torch.float32,
                  max_seq=256, device="cpu", kv_pool=pool, kv_pool_block=BLOCK, **kw)


def _jax(weights, monkeypatch, pool: bool, mb: str = "", **kw):
    monkeypatch.setenv("LLMC_KV_POOL", "1" if pool else "0")
    monkeypatch.setenv("LLMC_KV_POOL_BLOCK", str(BLOCK))
    if mb:
        monkeypatch.setenv("LLMC_KV_POOL_MB", mb)
    kw.setdefault("prefill_chunk", 16)
    return JaxEngine(jax_config("tiny-llama"), params=weights[0], dtype=jnp.float32,
                     max_seq=256, **kw)


def _gen(eng, prompt, n):
    if isinstance(eng, JaxEngine):
        return eng.generate(prompt, JaxSampling(max_new_tokens=n, ignore_eos=True)).token_ids
    return eng.generate(prompt, SamplingParams(max_new_tokens=n, ignore_eos=True)).token_ids


def _walk(radix):
    out, stack = [], [radix.root]
    while stack:
        node = stack.pop()
        for child in node.children:
            out.append(child.block)
            stack.append(child)
    return out


SHARED = "system: answer as a careful consensus panel member. " * 2
MIXED = [
    SHARED + "first user question",
    SHARED + "second, rather different user question",
    SHARED + "first user question",       # exact repeat
    "unrelated prompt with no common prefix at all " * 2,
    SHARED + "third question arrives after the divergent one",
]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_pool_greedy_identity_on_off_and_jax(weights, monkeypatch, kv_quant):
    """Shared-prefix, repeat and divergent traffic: identical greedy tokens
    with the pool on and off and on the JAX engine with its pool on; the
    port's pool rode the radix, released every lease, and its stats equal
    the JAX pool's key for key."""
    off = _port(weights, False, kv_quant=kv_quant)
    on = _port(weights, True, kv_quant=kv_quant)
    je = _jax(weights, monkeypatch, True, kv_quant=kv_quant)
    assert on._kv_pool is not None and je._kv_pool is not None
    for p in MIXED:
        want = _gen(off, p, 10)
        assert _gen(on, p, 10) == want == _gen(je, p, 10), p
    stats = on._kv_pool.stats()
    assert stats["hit_tokens"] > 0 and stats["hits"] >= 3
    assert all(b.refs == 0 for b in _walk(on._kv_pool._radix))
    assert stats == je._kv_pool.stats()


def test_pool_cross_round_judge_reuse(weights, monkeypatch):
    header = "judge: weigh the panel answers and synthesize. "
    round1 = header + "answer A says yes; answer B says no. "
    round2 = round1 + "critique: A ignored the edge case; revise. "
    on, je = _port(weights, True), _jax(weights, monkeypatch, True)
    _gen(on, round1, 8), _gen(je, round1, 8)
    before = on._kv_pool.stats()["hit_tokens"]
    got = _gen(on, round2, 8)
    gained = on._kv_pool.stats()["hit_tokens"] - before
    assert gained >= len(round1) - BLOCK  # the whole-block floor
    off = _port(weights, False)
    _gen(off, round1, 8)
    assert got == _gen(off, round2, 8) == _gen(je, round2, 8)
    assert on._kv_pool.stats() == je._kv_pool.stats()


def test_pool_cow_divergence_keeps_shared_bytes(weights, monkeypatch):
    shared = "x" * 48
    on, je = _port(weights, True), _jax(weights, monkeypatch, True)
    for eng in (on, je):
        _gen(eng, shared + " branch one tail", 8)
        _gen(eng, shared + " branch TWO goes elsewhere", 8)
    probe = shared + " branch one tail, extended further still"
    got = _gen(on, probe, 8)
    assert on._kv_pool.stats()["hits"] >= 2
    assert got == _gen(_port(weights, False), probe, 8) == _gen(je, probe, 8)
    assert on._kv_pool.stats() == je._kv_pool.stats()


def test_pool_eviction_under_pressure(weights, monkeypatch):
    """A 4-block arena under many distinct prompts evicts (LRU), keeps every
    greedy output, and counts what the JAX pool counts."""
    on = Engine(get_config("tiny-llama"), params=weights[1], dtype=torch.float32, max_seq=256,
                device="cpu", prefill_chunk=16, kv_pool=True, kv_pool_block=BLOCK,
                kv_pool_mb=0.08)
    je = _jax(weights, monkeypatch, True, mb="0.08")
    assert on._kv_pool.n_blocks == je._kv_pool.n_blocks == 4
    off = _port(weights, False)
    for i in range(4):
        p = f"distinct prompt number {i} with its own words "
        assert _gen(on, p, 6) == _gen(off, p, 6) == _gen(je, p, 6)
    stats = on._kv_pool.stats()
    assert stats["evicted_blocks"] > 0
    assert stats["blocks_used"] <= stats["blocks_total"] == 4
    assert stats == je._kv_pool.stats()


@pytest.mark.parametrize("spec", ["pool_exhausted@step=1", "evict_storm@step=2"])
def test_pool_kv_fault_site_like_jax(weights, monkeypatch, spec):
    """The ``kv`` fault site: ``pool_exhausted`` drops a publish's blocks,
    ``evict_storm`` empties the arena before one; tokens never change and
    both pools count alike."""
    prompt = "a prompt whose publish the fault plan will reject " * 2
    faults.install(FaultPlan(spec, seed=3))
    jax_faults.install(jax_faults.FaultPlan(spec, seed=3))
    on, je = _port(weights, True), _jax(weights, monkeypatch, True)
    first = _gen(on, prompt, 6)
    assert first == _gen(je, prompt, 6)
    if spec.startswith("pool_exhausted"):
        stats = on._kv_pool.stats()
        assert stats["exhausted"] == 1 and stats["published_blocks"] == 0
    assert _gen(on, prompt, 6) == first == _gen(je, prompt, 6)
    assert on._kv_pool.stats()["published_blocks"] > 0
    if spec.startswith("evict_storm"):
        assert on._kv_pool.stats()["evicted_blocks"] > 0
    assert on._kv_pool.stats() == je._kv_pool.stats()
    assert faults.plan().trace_bytes() == jax_faults.plan().trace_bytes()


def test_pool_off_by_default_and_gated_like_prefix_reuse(weights, monkeypatch):
    cfg = get_config("tiny-llama")
    kw = dict(params=weights[1], dtype=torch.float32, max_seq=256, device="cpu")
    assert Engine(cfg, prefill_chunk=16, **kw)._kv_pool is None
    assert _jax(weights, monkeypatch, False)._kv_pool is None
    # Chunking off and the prefix cache off disable the pool, as they
    # disable the snapshot it replaces.
    assert Engine(cfg, prefill_chunk=0, kv_pool=True, **kw)._kv_pool is None
    assert _jax(weights, monkeypatch, True, prefill_chunk=0)._kv_pool is None
    assert Engine(cfg, prefill_chunk=16, kv_pool=True, prefix_cache=False,
                  **kw)._kv_pool is None
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")
    assert _jax(weights, monkeypatch, True)._kv_pool is None
    # The arena's budget replaces the snapshot's byte cap.
    capped = Engine(cfg, prefill_chunk=16, prefix_cache_max_mb=0.001, **kw)
    assert not capped.prefix_cache_enabled
    pooled = Engine(cfg, prefill_chunk=16, prefix_cache_max_mb=0.001, kv_pool=True, **kw)
    assert pooled._kv_pool is not None and pool_for(pooled) is not None


def test_pool_int8_kv_cache_identity(weights, monkeypatch):
    """Blocks carry the int8 codes and the sequence-minor scales: quantized
    caches share through the pool exactly too."""
    shared = "quantized cache shared prefix for every stream " * 2
    on = _port(weights, True, kv_quant="int8")
    off = _port(weights, False, kv_quant="int8")
    je = _jax(weights, monkeypatch, True, kv_quant="int8")
    for tail in ("alpha", "beta continues differently"):
        p = shared + tail
        assert _gen(on, p, 8) == _gen(off, p, 8) == _gen(je, p, 8)
    assert on._kv_pool.stats()["hit_tokens"] > 0
    assert on._kv_pool.stats() == je._kv_pool.stats()


def test_arena_sizing_equals_the_jax_pool(weights, monkeypatch):
    for kv_quant in (None, "int8"):
        for mb in ("256", "1", "0.01"):
            on = Engine(get_config("tiny-llama"), params=weights[1], dtype=torch.float32,
                        max_seq=256, device="cpu", prefill_chunk=16, kv_pool=True,
                        kv_pool_block=BLOCK, kv_pool_mb=float(mb), kv_quant=kv_quant)
            je = _jax(weights, monkeypatch, True, mb=mb, kv_quant=kv_quant)
            pool = on._kv_pool
            assert (pool.n_blocks, pool.bytes_per_token) == (
                je._kv_pool.n_blocks, je._kv_pool.bytes_per_token)
            # The arena as allocated is the modeled size, codes and scales.
            assert pool.arena_bytes == pool.n_blocks * BLOCK * pool.bytes_per_token


# -- the block copies --------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_gather_after_publish_is_byte_equal_and_scatter_leaves_other_blocks(kv_quant):
    """A publish copies each block of a cache to its slot and nothing else;
    a gather of the chain brings back the same bytes at [0, k x bs)."""
    from llm_consensus_tpu_torch.kv import pool as pool_mod
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    cfg = get_config("tiny-llama")
    pool = KVPool(cfg, dtype=torch.float32, kv_quant=kv_quant, device=torch.device("cpu"),
                  max_seq=100, block_size=8, budget_bytes=1.0,  # the 4-block floor
                  new_cache=lambda n: init_kv_cache(cfg, 1, n, device=torch.device("cpu"),
                                                    dtype=torch.float32, quant=kv_quant))
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():  # the arena is an inference tensor, as every cache
        for leaf in pool_mod._leaves(pool._arena):
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype))
    before = [leaf.clone() for leaf in pool_mod._leaves(pool._arena)]
    src = init_kv_cache(cfg, 1, 100, device=torch.device("cpu"), dtype=torch.float32,
                        quant=kv_quant)
    for leaf in pool_mod._leaves(src):
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype))
    ids = list(range(20))  # 2 full blocks and a 4-token tail
    wrote, truncated = pool.publish(ids, src)
    assert (wrote, truncated) == (3, False)
    slots = [b.slot for b in pool._radix.match(ids)[1]]
    for leaf, old, s in zip(pool_mod._leaves(pool._arena), before, pool_mod._leaves(src)):
        ax = pool_mod.kv_seq_axis(leaf)
        for slot in range(pool.n_blocks):
            got = leaf.narrow(ax, slot * 8, 8)
            if slot in slots:
                i = slots.index(slot)
                assert torch.equal(got, s.narrow(ax, i * 8, 8))
            else:
                assert torch.equal(got, old.narrow(ax, slot * 8, 8))
    n, cache = pool.lookup(ids, min_tokens=1)
    assert n == 19
    for g, s in zip(pool_mod._leaves(cache), pool_mod._leaves(src)):
        ax = pool_mod.kv_seq_axis(g)
        assert g.shape[ax] == 100
        assert torch.equal(g.narrow(ax, 0, 24), s.narrow(ax, 0, 24))


# -- integrity: sampled gather verification (tests/test_integrity.py) -------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_kv_sampled_gather_verify_identity(weights, monkeypatch, kv_quant):
    """The plane on, every gather verified: pooled greedy output stays equal
    to pool-off and the JAX pool's, and the verifications ran."""
    shared = "integrity plane shared system prefix " * 2
    prompts = [shared + "first question", shared + "first question",
               shared + "second, different question"]
    off = _port(weights, False, kv_quant=kv_quant)
    want = [_gen(off, p, 10) for p in prompts]
    plane = integrity.IntegrityPlane(sample=1.0)
    integrity.install(plane)
    monkeypatch.setenv("LLMC_INTEGRITY", "1")
    monkeypatch.setenv("LLMC_INTEGRITY_SAMPLE", "1.0")
    jax_integrity.reset()
    on = _port(weights, True, kv_quant=kv_quant)
    je = _jax(weights, monkeypatch, True, kv_quant=kv_quant)
    assert [_gen(on, p, 10) for p in prompts] == want == [_gen(je, p, 10) for p in prompts]
    stats = on._kv_pool.stats()
    assert stats["verified_blocks"] > 0 and stats["corrupt_blocks"] == 0
    assert plane.stats()["checks"].get("kv", 0) > 0
    assert not plane.stats()["failures"]
    assert stats == je._kv_pool.stats()
    assert plane.stats()["checks"] == jax_integrity.plane().stats()["checks"]


def test_kv_gather_corruption_drops_chain_and_recomputes(weights, monkeypatch):
    """An injected ``bit_flip`` on a verified gather books the corruption,
    drops the chain and prefills again: tokens stay equal, and the next
    request reuses the republished clean bytes."""
    prompt = "kv corruption containment probe prompt " * 2
    want = _gen(_port(weights, False), prompt, 10)
    plane = integrity.IntegrityPlane(sample=1.0)
    integrity.install(plane)
    faults.install(FaultPlan("bit_flip@surface=kv", seed=2))
    on = _port(weights, True)
    assert _gen(on, prompt, 10) == want  # publishes
    assert _gen(on, prompt, 10) == want  # corrupt gather
    stats = on._kv_pool.stats()
    assert stats["corrupt_blocks"] == 1, stats
    assert plane.stats()["failures"].get("kv", 0) == 1
    before = stats["verified_blocks"]
    assert _gen(on, prompt, 10) == want
    stats = on._kv_pool.stats()
    assert stats["verified_blocks"] > before and stats["corrupt_blocks"] == 1
    # The JAX pool under the same plan counts the same.
    monkeypatch.setenv("LLMC_INTEGRITY", "1")
    monkeypatch.setenv("LLMC_INTEGRITY_SAMPLE", "1.0")
    jax_integrity.reset()
    jax_faults.install(jax_faults.FaultPlan("bit_flip@surface=kv", seed=2))
    je = _jax(weights, monkeypatch, True)
    assert [_gen(je, prompt, 10) for _ in range(3)] == [want] * 3
    assert je._kv_pool.stats() == stats


def test_integrity_sampling_is_every_nth():
    plane = integrity.IntegrityPlane(sample=0.25)
    assert [plane.sample_hit() for _ in range(8)] == [False, False, False, True] * 2
    assert not any(integrity.IntegrityPlane(sample=0.0).sample_hit() for _ in range(5))
    assert integrity.IntegrityPlane().sample == 0.05
    jplane = jax_integrity.IntegrityPlane(sample=0.25)
    assert [jplane.sample_hit() for _ in range(8)] == [False, False, False, True] * 2


# -- pressure: kv_truncated and hbm_squeeze (tests/test_pressure.py) ---------------------------


def test_kv_truncated_surfaces_per_response(weights):
    faults.install(FaultPlan("pool_exhausted@step=1", seed=3))
    eng = _port(weights, True, stream_interval=8)
    s = SamplingParams(max_new_tokens=6, ignore_eos=True)
    r = eng.generate("a publish the injected fault truncates " * 2, s)
    assert r.kv_truncated is True
    r2 = eng.generate("a second prompt whose publish proceeds " * 2, s)
    assert r2.kv_truncated is False


def test_hbm_squeeze_fault_truncates_via_pressure_site(weights, monkeypatch):
    """``hbm_squeeze@frac=0`` (site ``pressure``, phase=publish) shrinks the
    arena to nothing for one publish: the exhaustion path, the counter
    moves, the tokens do not."""
    prompt = "a squeezed publish loses its tail blocks " * 2
    base = _gen(_port(weights, False, stream_interval=8), prompt, 6)
    spec = "hbm_squeeze@phase=publish@frac=0@step=1"
    faults.install(FaultPlan(spec, seed=5))
    eng = _port(weights, True, stream_interval=8)
    r = eng.generate(prompt, SamplingParams(max_new_tokens=6, ignore_eos=True))
    assert r.token_ids == base and r.kv_truncated is True
    stats = eng._kv_pool.stats()
    assert stats["exhausted"] == 1 and stats["published_blocks"] == 0
    r2 = eng.generate(prompt, SamplingParams(max_new_tokens=6, ignore_eos=True))
    assert r2.token_ids == base and r2.kv_truncated is False
    assert eng._kv_pool.stats()["published_blocks"] > 0
    jax_faults.install(jax_faults.FaultPlan(spec, seed=5))
    je = _jax(weights, monkeypatch, True, stream_interval=8)
    jr = [je.generate(prompt, JaxSampling(max_new_tokens=6, ignore_eos=True))
          for _ in range(2)]
    assert [x.kv_truncated for x in jr] == [True, False]
    assert je._kv_pool.stats() == eng._kv_pool.stats()
    assert faults.plan().trace_bytes() == jax_faults.plan().trace_bytes()


# -- attribution: the HBM sentinel and the arena component (tests/test_attrib.py) --------------


def test_kv_pool_exhaustion_fires_hbm_sentinel(weights, tmp_path, monkeypatch):
    rec = obs.Recorder()
    obs.install(rec)
    led = ChipTimeLedger()
    obs.attrib.install(led)
    fr = FlightRecorder(capacity=64, out_dir=str(tmp_path), min_interval_s=0.0)
    obs.blackbox.install(fr)
    faults.install(FaultPlan("pool_exhausted@times=-1", seed=1))
    eng = _port(weights, True, stream_interval=8)
    eng.generate("exhaustion probe prompt body text",
                 SamplingParams(max_new_tokens=24, ignore_eos=True))
    snap = led.snapshot()
    assert snap["hbm"]["events"] >= 1
    assert fr.last_reason == "hbm_high_water"
    assert any(e.name == "hbm_high_water" and e.args.get("source") == "kv_pool:tiny-llama"
               for e in rec.events())
    assert any(e.name == "kv_pool_exhausted" for e in rec.events())
    assert snap["hbm"]["components"]["kv_arena:tiny-llama"] == eng._kv_pool.arena_bytes
    # The gather and publish copies book their device time by family.
    faults.reset()
    eng2 = _port(weights, True, stream_interval=8)
    for _ in range(2):
        eng2.generate("exhaustion probe prompt body text",
                      SamplingParams(max_new_tokens=24, ignore_eos=True))
    eng2._kv_pool.stats()  # books the finished copies' intervals
    disp = led.snapshot()["dispatches"]
    assert disp.get("kv_publish", 0) >= 1 and disp.get("kv_gather", 0) >= 1
    # The JAX pool's sentinel on the same traffic.
    jled = jax_attrib.ChipTimeLedger()
    jax_attrib.install(jled)
    jax_blackbox.install(jax_blackbox.FlightRecorder(
        capacity=64, out_dir=str(tmp_path / "jax"), min_interval_s=0.0))
    jax_faults.install(jax_faults.FaultPlan("pool_exhausted@times=-1", seed=1))
    je = _jax(weights, monkeypatch, True, stream_interval=8)
    je.generate("exhaustion probe prompt body text",
                JaxSampling(max_new_tokens=24, ignore_eos=True))
    assert jled.snapshot()["hbm"]["events"] == snap["hbm"]["events"]
    assert jled.snapshot()["hbm"]["components"]["kv_arena:tiny-llama"] == \
        snap["hbm"]["components"]["kv_arena:tiny-llama"]


# -- the port's own choices ---------------------------------------------------------------------


def test_publish_stops_at_the_last_kv_written(weights):
    """``max_new`` 17 at ``stream_interval`` 16: the 17th token is emitted
    but never fed back, so its KV is never written. The pool publishes the
    ids the loop wrote; a follow-up holding the whole answer matches a fresh
    engine's first-step logits and greedy tokens."""
    eng = _port(weights, True)
    fresh = _port(weights, False, prefix_cache=False)
    s = SamplingParams(max_new_tokens=17, ignore_eos=True)
    ids0 = eng.tokenizer.encode("tell me a story " * 3)
    first = eng.generate_ids(ids0, s)
    assert len(first.token_ids) == 17
    follow = ids0 + first.token_ids + list(b" continue it.")
    assert eng._kv_pool.match_len(follow) == len(ids0) + 16
    with torch.inference_mode():
        got, _ = eng._prefill_ids(follow)
        want, _ = fresh._prefill_ids(follow)
    assert eng._kv_pool.stats()["hits"] == 1
    assert (got - want).abs().max().item() <= 1e-5
    assert eng.generate_ids(follow, s).token_ids == fresh.generate_ids(follow, s).token_ids


class _FullCaches(TorchDispatchMode):
    """Counts the fresh tensors of ``shape`` that factory ops return."""

    FACTORIES = ("empty.memory_format", "zeros.default", "empty_like.default",
                 "zeros_like.default", "clone.default", "new_zeros.default",
                 "new_empty.default", "empty_strided.default")

    def __init__(self, shape):
        super().__init__()
        self.shape, self.count = tuple(shape), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        if any(str(func).endswith(f) for f in self.FACTORIES) or name in self.FACTORIES:
            if isinstance(out, torch.Tensor) and tuple(out.shape) == self.shape:
                self.count += 1
        return out


def test_pool_hit_restores_in_place(weights, monkeypatch):
    """A pool hit holds ONE [1, max_seq] cache: the restore masks the
    gathered cache in place (zero from the matched length on) and hands it
    to the tail prefill, where the snapshot path copies."""
    eng = _port(weights, True)
    eng.generate(SHARED, SamplingParams(max_new_tokens=4, ignore_eos=True))
    gathered = []
    real = eng._kv_pool.lookup
    monkeypatch.setattr(eng._kv_pool, "lookup",
                        lambda *a, **k: gathered.append(real(*a, **k)) or gathered[-1])
    prompt = eng.tokenizer.encode(SHARED + " and a question")
    full = (eng.cfg.n_layers, 1, eng.max_seq, eng.cfg.n_kv_heads, eng.cfg.head_dim)
    with torch.inference_mode(), _FullCaches(full) as mode:
        _, cache = eng._prefill_ids(prompt)
    n, dst = gathered[-1]
    assert n >= 16 and dst is not None
    assert cache["k"] is dst["k"] and cache["v"] is dst["v"]
    assert mode.count == 2  # the gathered k and v: no second cache
    snap = _port(weights, False)
    snap.generate(SHARED, SamplingParams(max_new_tokens=4, ignore_eos=True))
    with torch.inference_mode():
        saved = snap._prefix_cache
        _, restored = snap._prefill_ids(prompt)
    assert restored["k"] is not saved["k"]  # the snapshot is copied, kept
    # The in-place form zeroes exactly the positions past n.
    src = {"k": torch.ones(2, 1, 40, 2, 4), "v": torch.ones(2, 1, 40, 2, 4)}
    out = engine_mod._restore_prefix_owned(src, 13)
    assert out["k"] is src["k"]
    assert out["k"][:, :, :13].eq(1).all() and not out["k"][:, :, 13:].any()


def _gated(eng, **kw):
    """A batcher whose scheduler waits on a gate: submissions queued before
    the gate opens form one admission wave."""
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


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_batcher_radix_consult_establishes_a_lone_request(weights, kv_quant):
    """A lone request whose prefix the pool holds establishes a shared
    prefix by radix consult (a gather, not a prefill), admits as a suffix
    and decodes single-stream's greedy tokens; without a pool the same
    request establishes nothing."""
    long_prompt = "a long system prompt that one earlier request published " * 2
    question = long_prompt + "and now the lone question"
    s = SamplingParams(max_new_tokens=12, ignore_eos=True)
    want = _port(weights, False, kv_quant=kv_quant, stream_interval=8).generate(
        question, s).token_ids
    for pool in (True, False):
        eng = _port(weights, pool, kv_quant=kv_quant, stream_interval=8)
        eng.generate(long_prompt, SamplingParams(max_new_tokens=4, ignore_eos=True))
        b, gate = _gated(eng, max_batch=2, pool_prefix_min=64)
        try:
            fut = b.submit(question, s)
            gate.set()
            assert fut.result(timeout=WAIT).token_ids == want
            snap = b.snapshot()
        finally:
            b.close()
        if pool:
            held = eng._kv_pool.match_len(eng.tokenizer.encode(long_prompt))
            assert snap["establish_tokens"] > 0 and snap["prefix_len"] > 0, snap
            assert snap["prefix_len"] <= held
            assert eng._kv_pool.stats()["hits"] >= 1
        else:
            assert snap["establish_tokens"] == 0 and snap["prefix_len"] == 0, snap


@pytest.mark.parametrize("method, exc", [
    ("publish", RuntimeError("arena write failed")),
    ("lookup", RuntimeError("CUDA error: an illegal memory access was encountered")),
], ids=["publish", "gather_device_error"])
def test_batcher_pool_errors_reach_the_future(weights, monkeypatch, method, exc):
    """A KV-pool publish that fails while the batcher establishes a prefix,
    or a gather that fails with a device error, fails the request: no
    warning, no silent fallback to a prefill."""
    import warnings

    long_prompt = "a long system prompt that one earlier request published " * 2
    eng = _port(weights, True, stream_interval=8)
    eng.generate(long_prompt, SamplingParams(max_new_tokens=4, ignore_eos=True))

    def fail(*args, **kwargs):
        raise exc

    monkeypatch.setattr(eng._kv_pool, method, fail)
    b, gate = _gated(eng, max_batch=2, pool_prefix_min=64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            fut = b.submit(long_prompt + "and now the lone question",
                           SamplingParams(max_new_tokens=12, ignore_eos=True))
            gate.set()
            with pytest.raises(RuntimeError) as info:
                fut.result(timeout=WAIT)
        finally:
            b.close()
    assert info.value is exc
    assert b.failed_exc is exc
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]


# -- the provider and the CLI -------------------------------------------------------------------


def test_provider_kv_surface(weights):
    prov = GPUProvider(device="cpu", kv_pool=True, kv_pool_block=BLOCK, kv_pool_mb=1.0,
                       max_seq=256)
    try:
        from llm_consensus_tpu_torch.providers.base import Request
        from llm_consensus_tpu_torch.utils.context import Context

        assert prov.kv_stats() == {}
        req = Request(model="gpu:tiny-llama", prompt=SHARED, max_tokens=4)
        prov.query(Context.background(), req)
        stats = prov.kv_stats()
        assert list(stats) == ["tiny-llama"]
        assert stats["tiny-llama"]["published_blocks"] > 0
        used = stats["tiny-llama"]["blocks_used"]
        assert prov.kv_evict_cold(0.0) == used
        assert prov.kv_stats()["tiny-llama"]["blocks_used"] == 0
        # A pooled run never shares a snapshot provider.
        a = GPUProvider.shared("cpu", kv_pool=True)
        assert a is not GPUProvider.shared("cpu") and a is GPUProvider.shared("cpu",
                                                                               kv_pool=True)
    finally:
        prov.release()
        for key in [k for k, v in GPUProvider._shared.items() if v.kv["kv_pool"]]:
            GPUProvider._shared.pop(key).release()


def test_recovered_engine_gets_a_fresh_pool():
    """``_recover_batcher`` rebuilds the engine with a fresh, empty pool, and
    the dead engine's arena becomes collectible with it."""
    import gc
    import time
    import weakref

    prov = GPUProvider(device="cpu", batch_streams=2, kv_pool=True, kv_pool_block=BLOCK,
                       kv_pool_mb=1.0, max_seq=256)
    try:
        engine = prov._engine_for("gpu:tiny-llama")
        engine.generate(SHARED, SamplingParams(max_new_tokens=4, ignore_eos=True))
        assert engine._kv_pool.stats()["blocks_used"] > 0
        batcher = prov._batcher_for("tiny-llama", engine)
        fresh = prov._recover_batcher("tiny-llama", batcher)
        assert fresh.engine is not engine and fresh.engine._kv_pool is not engine._kv_pool
        assert fresh.engine._kv_pool.stats()["blocks_used"] == 0
        assert fresh.engine._kv_pool.n_blocks == engine._kv_pool.n_blocks
        arena = weakref.ref(engine._kv_pool._arena["k"])
        del engine, batcher
        deadline = time.monotonic() + 30
        while arena() is not None and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.05)
        assert arena() is None
        assert list(prov.kv_stats()) == ["tiny-llama"]
    finally:
        prov.release()


def test_kv_knobs_parse_like_jax(monkeypatch):
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    assert knobs.kv_pool_settings() == {"kv_pool": False, "kv_pool_block": 64,
                                        "kv_pool_mb": 256.0}
    assert knobs.integrity_sample() == jax_knobs.get_float("LLMC_INTEGRITY_SAMPLE") == 0.05
    for name, value in (("LLMC_KV_POOL", "1"), ("LLMC_KV_POOL_BLOCK", "32"),
                        ("LLMC_KV_POOL_MB", "4096"), ("LLMC_INTEGRITY_SAMPLE", "0.5")):
        monkeypatch.setenv(name, value)
    assert knobs.kv_pool_settings() == {
        "kv_pool": jax_knobs.get_bool("LLMC_KV_POOL"),
        "kv_pool_block": jax_knobs.get_int("LLMC_KV_POOL_BLOCK"),
        "kv_pool_mb": jax_knobs.get_float("LLMC_KV_POOL_MB")}
    assert knobs.integrity_sample() == jax_knobs.get_float("LLMC_INTEGRITY_SAMPLE") == 0.5


def _run_port(argv):
    from llm_consensus_tpu_torch.cli.main import main

    stdout, stderr = io.StringIO(), io.StringIO()
    rc = main(argv, device="cpu", stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
              install_signal_handlers=False)
    return rc, stdout.getvalue(), stderr.getvalue()


def _run_jax_cli(argv):
    from llm_consensus_tpu.cli.main import main as jax_main
    from llm_consensus_tpu.providers.tpu import TPUProvider

    saved = TPUProvider._shared
    TPUProvider._shared = None
    try:
        stdout, stderr = io.StringIO(), io.StringIO()
        rc = jax_main(argv, stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                      install_signal_handlers=False)
    finally:
        TPUProvider._shared = saved
    return rc, stdout.getvalue(), stderr.getvalue()


@pytest.fixture
def pooled_cli(tmp_path, monkeypatch):
    """Both CLIs with ``LLMC_KV_POOL=1`` on one synthetic tiny-llama
    checkpoint; the port's shared providers of the test are released."""
    from tests.test_hf_golden import _make_hf_checkpoint

    _make_hf_checkpoint(jax_config("tiny-llama"), str(tmp_path / "ckpt" / "tiny-llama"))
    monkeypatch.setenv("LLMC_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("LLMC_KV_POOL", "1")
    before = dict(GPUProvider._shared)
    yield monkeypatch
    for key, provider in list(GPUProvider._shared.items()):
        if key not in before:
            provider.release()
            del GPUProvider._shared[key]


@pytest.mark.parametrize("spec", ["", "pool_exhausted@step=1"], ids=["clean", "exhausted"])
def test_cli_kv_blocks_equal_the_jax_clis(tmp_path, pooled_cli, spec):
    """One tiny-llama answer through both CLIs with the pool on and the
    recorder (``--events``, which carries the providers' blocks): the
    ``metrics.json`` ``kv`` block and ``result.json``'s per-response ``kv``
    (``{"truncated": true}`` under ``pool_exhausted``) are the JAX CLI's."""
    if spec:
        pooled_cli.setenv("LLMC_FAULTS", spec)
    docs = {}
    for scheme, runner in (("tpu", _run_jax_cli), ("gpu", _run_port)):
        data = tmp_path / scheme
        rc, _out, err = runner(["--models", f"{scheme}:tiny-llama", "--judge",
                                f"{scheme}:tiny-llama", "--max-tokens", "8", "--events",
                                "--data-dir", str(data), "what is consensus?"])
        assert rc == 0, err
        (run_dir,) = list(data.iterdir())
        docs[scheme] = (json.loads((run_dir / "result.json").read_text()),
                        json.loads((run_dir / "metrics.json").read_text()))
        faults.reset()
        jax_faults.reset()
    (ours, our_metrics), (theirs, their_metrics) = docs["gpu"], docs["tpu"]
    assert our_metrics["kv"] == their_metrics["kv"]
    assert our_metrics["kv"]["tiny-llama"]["lookups"] == 1
    want = {"truncated": True} if spec else None
    assert [r.get("kv") for r in ours["responses"]] == [
        r.get("kv") for r in theirs["responses"]] == [want]
    assert list(ours["responses"][0]) == list(theirs["responses"][0])


def test_cli_without_the_pool_writes_no_kv_block(tmp_path, pooled_cli):
    """The pool off: no ``kv`` block and no per-response ``kv``, as in the
    JAX CLI."""
    pooled_cli.setenv("LLMC_KV_POOL", "0")
    rc, _out, err = _run_port(["--models", "gpu:tiny-llama", "--judge", "gpu:tiny-llama",
                               "--max-tokens", "4", "--events", "--data-dir",
                               str(tmp_path / "runs"),
                               "what is consensus?"])
    assert rc == 0, err
    (run_dir,) = list((tmp_path / "runs").iterdir())
    assert "kv" not in json.loads((run_dir / "metrics.json").read_text())
    assert "kv" not in json.loads((run_dir / "result.json").read_text())["responses"][0]
