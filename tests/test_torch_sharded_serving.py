"""Serving over a tensor-parallel engine: the port's batcher, shared prefix,
KV pool, prefix snapshot, weight swap, lookup speculation and handoff over
``Engine(mesh=)`` of tp 2, held to the JAX package's tp tests case by case
(``tests/test_continuous_batching.py``, ``tests/test_pool_prefix.py``,
``tests/test_disagg.py``, ``tests/test_integrity.py``) on tiny-llama in
float32 on the CPU.

The JAX side runs on two of the eight virtual CPU devices its conftest
provides, the port on ``virtual_devices(2, "cpu")``; both take the same
numpy weights (``params_from_numpy``). Greedy tokens are held exactly: the
sharded batcher against the same sharded engine single-stream and against
the JAX sharded engine, the sharded forward's batched forms against the
unsharded forward and the JAX forward over its mesh (logits within 1e-4:
the partial sums over shards add in another order), handed-off and pooled
KV bitwise.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import integrity as jax_integrity
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import PromptLookupDrafter as JaxLookup
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.engine import SpeculativeEngine as JaxSpec
from llm_consensus_tpu.models import forward as jax_forward
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llm_consensus_tpu.parallel.sharding import make_shard_fn as jax_shard_fn
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import (
    Engine, PromptLookupDrafter, SamplingParams, SpeculativeEngine)
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.engine.handoff import KVHandoff
from llm_consensus_tpu_torch.engine.speculative import SpecConfig
from llm_consensus_tpu_torch.faults import FaultPlan
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, forward, forward_sharded, params_from_numpy)
from llm_consensus_tpu_torch.ops.quant import kv_seq_axis
from llm_consensus_tpu_torch.parallel import make_mesh, param_specs, shard_pytree
from llm_consensus_tpu_torch.parallel.mesh import Device
from llm_consensus_tpu_torch.providers.base import Request
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.utils.context import Context

PRESET = "tiny-llama"
CPU = torch.device("cpu")
WAIT = 300
BLOCK = 16
LOGIT_TOL = 1e-4  # float32 logits: partial sums over shards in another order
PREFIX = (
    "a shared consensus prompt prefix that every stream of the wave "
    "carries verbatim before its own question suffix begins"
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread beside other xdist
    workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    for knob in ("LLMC_FAULTS", "LLMC_INTEGRITY", "LLMC_KV_POOL", "LLMC_POOL_PREFIX_MIN"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()
    yield
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()


def _trees(seed: int):
    jp = jax_init(jax_config(PRESET), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(PRESET), CPU,
                                 torch.float32)


@pytest.fixture(scope="module")
def weights():
    """Seed 0 (served) and seed 1 (a swap's), in both layouts."""
    return {0: _trees(0), 1: _trees(1)}


def _devs(n=2):
    return [Device(i, 0, CPU) for i in range(n)]


def _tp2():
    return make_mesh({"dp": 1, "tp": 2}, _devs(2))


def _jax_tp2():
    return jax_make_mesh({"dp": 1, "tp": 2}, jax.devices()[:2])


def _port(tree, **kw):
    """A tp 2 port engine over ``tree`` (float32, the JAX files' settings)."""
    kw.setdefault("max_seq", 256)
    kw.setdefault("stream_interval", 8)
    return Engine(get_config(PRESET), tree, dtype=torch.float32, mesh=_tp2(), **kw)


def _jax(tree, **kw):
    kw.setdefault("max_seq", 256)
    kw.setdefault("stream_interval", 8)
    return JaxEngine(jax_config(PRESET), params=tree, dtype=jnp.float32, mesh=_jax_tp2(), **kw)


def _s(n):
    return SamplingParams(max_new_tokens=n, ignore_eos=True)


def _js(n):
    return JaxSampling(max_new_tokens=n, ignore_eos=True)


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


def _leaves(cache):
    for name in sorted(cache):
        node = cache[name]
        yield from (_leaves(node) if isinstance(node, dict) else [node])


# -- forward_sharded: the batched forms ----------------------------------------------------


def _rand_cache(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


def _form_inputs(cfg, form):
    """(tokens [B, T], start_pos, numpy cache, forward kwargs as numpy) of
    one batched form: ``row_start`` (a decode step and a 4-token chunk over
    right-aligned rows), ``prefix`` (the shared-prefix merge at a decode
    step, one row outside the prefix) and ``kv_mask`` (a speculative verify
    of k + 1 = 3 positions over a bitmap with holes)."""
    rng = np.random.default_rng(11)
    s = 64
    rs = np.array([0, 10, 25], dtype=np.int32)
    if form == "row_start":
        return rng.integers(1, 120, (3, 4)), 40, _rand_cache(cfg, 3, s, 1), {"row_start": rs}
    if form == "prefix":
        pre = _rand_cache(cfg, 1, 32, 2)
        return rng.integers(1, 120, (3, 1)), 40, _rand_cache(cfg, 3, s, 3), {
            "row_start": rs, "prefix": pre, "prefix_len": 20,
            "prefix_rows": np.array([True, False, True])}
    valid = np.zeros((3, s), dtype=bool)
    for r, start in enumerate(rs):
        valid[r, start:40] = True
    valid[1, 30:33] = False  # rejected slots behind the frontier: holes
    valid[:, 40:43] = True   # this round's write window
    return rng.integers(1, 120, (3, 3)), 40, _rand_cache(cfg, 3, s, 4), {
        "row_start": rs, "kv_mask": valid}


@pytest.mark.parametrize("form", ["row_start", "prefix", "kv_mask"])
@pytest.mark.parametrize("attn_impl", ["flash", "torch"])
def test_forward_sharded_batched_forms_match_forward_and_jax(weights, form, attn_impl):
    """Each batched form through ``forward_sharded`` on a tp 2 group (each
    shard on its head slice: on the CPU the kernels' plain versions) against
    the unsharded ``forward`` and the JAX ``forward`` over its tp 2 mesh:
    logits within 1e-4, and the written caches joined across the shards
    equal to the unsharded ones within 1e-5."""
    jp, tree = weights[0]
    cfg = get_config(PRESET)
    tokens, start, cache_np, kw_np = _form_inputs(cfg, form)
    if form == "row_start" and attn_impl == "flash":
        tokens = tokens[:, :1]  # a decode step: the decode kernel's route
    t_tokens = torch.from_numpy(tokens).long()

    def t(v):
        if isinstance(v, dict):
            return {k: t(x) for k, x in v.items()}
        return torch.from_numpy(v) if isinstance(v, np.ndarray) else v

    kw = {k: t(v) for k, v in kw_np.items()}
    ref_cache = t(cache_np)
    ref_cache = {k: v.clone() for k, v in ref_cache.items()}
    ref, _ = forward(tree, cfg, t_tokens, ref_cache, start, attn_impl=attn_impl, **kw)

    mesh = _tp2()
    specs = param_specs(cfg, mesh)
    group = ShardGroup(cfg, mesh, shard_pytree(tree, specs, mesh), specs)
    assert group.heads and group.kernels
    caches = group.split_cache(t(cache_np))
    skw = dict(kw)
    if "prefix" in skw:
        skw["prefix"] = group.split_cache(skw["prefix"])
    got = forward_sharded(group, t_tokens, caches, start, attn_impl=attn_impl, **skw)
    torch.testing.assert_close(got, ref, atol=LOGIT_TOL, rtol=0)
    joined = ShardGroup.join_cache(caches, CPU)
    for a, b in zip(_leaves(joined), _leaves(ref_cache), strict=True):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)

    jmesh = _jax_tp2()
    shard = jax_shard_fn(jax_config(PRESET), jmesh)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw_np.items()}
    if "prefix" in jkw:
        jkw["prefix"] = shard({k: jnp.asarray(v) for k, v in kw_np["prefix"].items()})
    if "prefix_len" in jkw:
        jkw["prefix_len"] = jnp.int32(jkw["prefix_len"])
    jlogits, _ = jax_forward(shard(jp), jax_config(PRESET), jnp.asarray(tokens[:, :t_tokens.shape[1]],
                                                                        dtype=jnp.int32),
                             shard({k: jnp.asarray(v) for k, v in cache_np.items()}), start,
                             attn_impl="xla", mesh=jmesh, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)


# -- the batcher over tp 2 -----------------------------------------------------------------


def test_tp_sharded_batcher_token_exact(weights):
    """The JAX test's case: six staggered streams (~24 prompt + 24 new
    tokens each) through two slots of a 96-slot cache over tp 2, token-exact
    against the same sharded engine single-stream and against the JAX
    sharded engine."""
    jp, tree = weights[0]
    eng = _port(tree, max_seq=96, stream_interval=4)
    je = _jax(jp, max_seq=96, stream_interval=4)
    b = ContinuousBatcher(eng, max_batch=2)
    try:
        s = _s(24)
        prompts = [f"tp sharded wave stream {i}" for i in range(6)]
        futs = [b.submit(p, s, Context.background()) for p in prompts]
        for p, f in zip(prompts, futs):
            ref = eng.generate(p, s).token_ids
            assert f.result(timeout=WAIT).token_ids == ref, p
            assert je.generate(p, _js(24)).token_ids == ref, p
    finally:
        b.close()


def test_tp_sharded_batcher_compacts_and_stays_exact(weights):
    """The waterline roll and the row moves on every shard in lockstep: 4
    streams through 2 slots of a 256-slot tp 2 cache cross capacity (one
    gated wave of 90 and 180 new tokens, then 180 each, as the unsharded
    compaction test), every stream equal to the sharded engine's and the
    last to the JAX sharded engine's."""
    jp, tree = weights[0]
    eng = _port(tree)
    b, gate = _gated(eng, max_batch=2)
    try:
        news = [90] + [180] * 3
        prompts = [f"compaction wave stream {i}" for i in range(len(news))]
        futs = [b.submit(p, _s(n)) for p, n in zip(prompts, news)]
        gate.set()
        for p, n, f in zip(prompts, news, futs):
            assert f.result(timeout=WAIT).token_ids == eng.generate(p, _s(n)).token_ids, p
        assert futs[-1].result().token_ids == _jax(jp).generate(prompts[-1], _js(180)).token_ids
        assert b.snapshot()["compactions"] >= 1
    finally:
        b.close()


def test_provider_batching_engages_on_tp_placement(weights):
    """A planned tp 2 placement routes through the batcher (the JAX test),
    and its batched answer equals the sharded engine's single-stream one."""
    prov = GPUProvider(devices=_devs(2), ignore_eos=True, stream_interval=4, batch_streams=2)
    try:
        prov.prepare([f"gpu:{PRESET}"], None)
        mesh = prov.placement(f"gpu:{PRESET}")
        assert mesh is not None and mesh.size == 2
        resp = prov.query(Context.background(),
                          Request(model=f"gpu:{PRESET}", prompt="tp batched", max_tokens=4))
        assert PRESET in prov._batchers
        eng = prov.engines()[PRESET]
        assert eng.sharded and eng.mesh.size == 2
        assert resp.tokens == 4
        assert resp.content == eng.generate("tp batched", _s(4)).text
    finally:
        prov.release()


def test_tp_sharded_pool_shares_prefix(weights):
    """The JAX test: tp 2, three streams sharing PREFIX in one wave establish
    the shared prefix (each shard holds its heads' prefix KV and merges with
    the decode kernel's state form), greedy outputs exact against the
    sharded engine and the JAX sharded engine."""
    jp, tree = weights[0]
    eng = _port(tree)
    je = _jax(jp)
    b, gate = _gated(eng, max_batch=3, pool_prefix_min=64)
    try:
        prompts = [f"{PREFIX} tp stream {i}" for i in range(3)]
        futs = [b.submit(p, _s(12)) for p in prompts]
        gate.set()
        results = [f.result(timeout=WAIT) for f in futs]
        assert isinstance(b._prefix_cache, list) and len(b._prefix_cache) == 2
        assert b.snapshot()["prefix_len"] > 0
        for p, r in zip(prompts, results):
            ref = eng.generate(p, _s(12)).token_ids
            assert r.token_ids == ref, p
            assert je.generate(p, _js(12)).token_ids == ref, p
    finally:
        b.close()


def test_lookup_speculation_over_tp2_matches_jax(weights):
    """A buffer drafter rides a tp 2 target (the JAX rule): prompt lookup's
    greedy tokens, rounds and acceptance equal the JAX SpeculativeEngine's
    over its tp 2 engine, the tokens equal the plain sharded engine's, and
    the batcher's speculative rounds over the tp 2 pool (the kv_mask form)
    give the same tokens."""
    jp, tree = weights[0]
    eng, je = _port(tree), _jax(jp)
    prompt = "the judge quotes the panel: the judge quotes the panel again"
    ref = eng.generate(prompt, _s(33)).token_ids
    spec = SpeculativeEngine(eng, PromptLookupDrafter(2), k=3, adaptive=False, governor=False)
    jspec = JaxSpec(je, JaxLookup(2), k=3, adaptive=False, governor=False)
    assert spec.generate(prompt, _s(33)).token_ids == ref
    assert jspec.generate(prompt, _js(33)).token_ids == ref
    assert spec.stats["rounds"] == jspec.stats["rounds"] > 0
    assert spec.stats["accepted"] == jspec.stats["accepted"]
    b = ContinuousBatcher(eng, max_batch=2, spec=SpecConfig(kind="lookup", k=3, ngram=2))
    try:
        prompts = [prompt, "a second stream repeats: a second stream repeats"]
        futs = [b.submit(p, _s(33)) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=WAIT).token_ids == eng.generate(p, _s(33)).token_ids, p
        assert b.spec_snapshot()["rounds"] > 0
    finally:
        b.close()


# -- the prefix snapshot, the KV pool and the swap over tp 2 -------------------------------


def test_snapshot_reuse_over_tp2_matches_jax(weights):
    """The prefix snapshot on a sharded engine: a second prompt sharing a
    chunk with the first restores each shard's cache and prefills only its
    tail, tokens equal to a fresh tp 2 engine without the snapshot and to the
    JAX sharded engine with its snapshot on."""
    jp, tree = weights[0]
    eng = _port(tree, prefill_chunk=16, stream_interval=4)
    fresh = _port(tree, prefill_chunk=16, stream_interval=4, prefix_cache=False)
    je = _jax(jp, prefill_chunk=16, stream_interval=4)
    assert eng.prefix_cache_enabled
    first = "shared prefix snapshot probe prompt, long enough for two chunks"
    second = first + " and then a different tail"
    restores = []
    real = eng._reusable_prefix
    eng._reusable_prefix = lambda ids: restores.append(real(ids)[0]) or real(ids)
    for p in (first, second):
        got = eng.generate(p, _s(12)).token_ids
        assert got == fresh.generate(p, _s(12)).token_ids, p
        assert got == je.generate(p, _js(12)).token_ids, p
    assert restores[-1] >= 16  # the second prompt reused at least one chunk
    assert isinstance(eng._prefix_cache, list) and len(eng._prefix_cache) == 2


def test_kv_pool_hit_over_tp2_and_a_flipped_bit_in_the_second_shard(weights):
    """One arena per shard, one radix: a repeated prompt hits the pool
    (tokens equal to the miss, to a pool-less tp 2 engine's and to the JAX
    sharded engine's with its pool); ``stats()`` sums the shards' bytes; a
    bit flipped in the SECOND shard's arena is caught by the sampled digest
    (the chain dropped, a miss), and the next request recomputes the same
    tokens."""
    jp, tree = weights[0]
    plane = integrity.IntegrityPlane(sample=1.0)
    integrity.install(plane)
    eng = _port(tree, prefill_chunk=16, stream_interval=4, kv_pool=True, kv_pool_block=BLOCK)
    pool = eng._kv_pool
    assert pool is not None and isinstance(pool._arena, list) and len(pool._arena) == 2
    assert pool.arena_bytes == pool.n_blocks * BLOCK * pool.bytes_per_token
    prompt = "kv pool over tensor parallel shards, the probe prompt " * 2
    miss = eng.generate(prompt, _s(10)).token_ids
    assert miss == _port(tree, prefill_chunk=16, stream_interval=4,
                         prefix_cache=False).generate(prompt, _s(10)).token_ids
    hits = pool.stats()["hits"]
    assert eng.generate(prompt, _s(10)).token_ids == miss
    assert pool.stats()["hits"] == hits + 1 and pool.stats()["verified_blocks"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_KV_POOL", "1")
        mp.setenv("LLMC_KV_POOL_BLOCK", str(BLOCK))
        mp.setenv("LLMC_PREFILL_CHUNK", "16")
        je = _jax(jp, stream_interval=4, prefill_chunk=16)
        assert je._kv_pool is not None
        assert [je.generate(prompt, _js(10)).token_ids for _ in range(2)] == [miss, miss]
    # Corrupt the second shard's copy of the first published block.
    leaf = pool._arena[1]["k"]
    slot = min(b.slot for b in pool._radix.match(list(eng.tokenizer.encode(prompt)))[1])
    with torch.inference_mode():
        leaf.narrow(kv_seq_axis(leaf), slot * BLOCK, 1).add_(1.0)
    corrupt = pool.stats()["corrupt_blocks"]
    n, cache = pool.lookup(eng.tokenizer.encode(prompt), min_tokens=16)
    assert (n, cache) == (0, None)
    assert pool.stats()["corrupt_blocks"] == corrupt + 1
    assert plane.stats()["failures"].get("kv", 0) == 1
    assert eng.generate(prompt, _s(10)).token_ids == miss


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_weight_swap_over_tp2_matches_fresh_engine_and_jax(weights, quant):
    """The swap shards the incoming tree as the constructor does (quantized
    whole first when the engine quantizes) and flips every group's shards:
    the swapped tp 2 engine's tokens equal a fresh tp 2 engine's on the new
    weights (and, in float32, the JAX sharded engine's after its own swap);
    a rollback restores the first weights' tokens; a swap parked behind a
    pin flips at the last unpin."""
    (jp0, tree0), (jp1, tree1) = weights[0], weights[1]
    eng = _port(tree0, quant=quant)
    prompt = "a weight swap over two shards"
    before = eng.generate(prompt, _s(12)).token_ids
    want = _port(tree1, quant=quant).generate(prompt, _s(12)).token_ids
    assert want != before
    assert eng.swap_weights(1, tree1)
    assert eng.weight_version == 1 and eng.params is None
    assert eng.generate(prompt, _s(12)).token_ids == want
    if quant is None:
        je = _jax(jp0)
        assert je.swap_weights(1, jp1)
        assert je.generate(prompt, _js(12)).token_ids == want
    assert eng.rollback_weights() == 2
    assert eng.generate(prompt, _s(12)).token_ids == before
    eng.pin_weights()
    assert eng.swap_weights(3, tree1) and eng.swap_pending() and eng.weight_version == 2
    eng.unpin_weights()
    assert not eng.swap_pending() and eng.weight_version == 3
    assert eng.generate(prompt, _s(12)).token_ids == want


# -- the handoff into a tp 2 pool ------------------------------------------------------------


def _roles(tree, kv_quant=None):
    """A tp 1 prefill engine (no pool) and a tp 2 decode engine with the
    pool, the JAX tests' settings (block 16, chunk 16)."""
    cfg = get_config(PRESET)
    pe = Engine(cfg, tree, dtype=torch.float32, max_seq=256, prefill_chunk=16, device="cpu",
                kv_quant=kv_quant, prefix_cache=False)
    de = _port(tree, prefill_chunk=16, kv_quant=kv_quant, kv_pool=True, kv_pool_block=BLOCK)
    assert de._kv_pool is not None
    return pe, de


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_cross_mesh_publish_bitwise_equals_prefill(weights, kv_quant):
    """The JAX transport contract at tp 1 → tp 2 (a reshard by heads): KV
    handed off into the tp 2 pool gathers back, its shards joined,
    bitwise-equal to the bytes the tp 1 prefill computed, the int8 cache's
    codes and scales included; each shard's arena holds its own heads."""
    pe, de = _roles(weights[0][1], kv_quant)
    ids = [(7 * i + 3) % 120 + 1 for i in range(100)]
    _lg, ref_cache, _w = pe.admission_session([list(ids)]).run()
    h = KVHandoff(pe, de, name="test")
    try:
        ok, truncated = h.run(list(ids), priority=0)
        assert ok and not truncated, h.snapshot()
        span = (len(ids) // BLOCK) * BLOCK
        n, gathered = de._kv_pool.lookup(list(ids) + [121], min_tokens=1)
        assert n == span, (n, span)
        assert isinstance(gathered, list) and len(gathered) == 2
        joined = ShardGroup.join_cache(gathered, CPU)
        for ref, got in zip(_leaves(ref_cache), _leaves(joined), strict=True):
            ax = kv_seq_axis(ref)
            assert torch.equal(got.narrow(ax, 0, span), ref.narrow(ax, 0, span))
        snap = h.snapshot()
        assert (snap["prefill_devices"], snap["decode_devices"]) == (1, 2)
        assert de._kv_pool.stats()["handoff_blocks"] == span // BLOCK
    finally:
        h.close()


def test_handoff_digest_mismatch_fails_wave_then_clean_retry(weights):
    """The JAX test over a tp 2 decode engine with the pool on: a bit flip on
    the staged (resharded) bytes fails the wave's digest, nothing publishes,
    the caller falls back; the spent fault leaves a clean retry that
    transfers and verifies."""
    plane = integrity.IntegrityPlane(sample=1.0)
    integrity.install(plane)
    faults.install(FaultPlan("bit_flip@surface=handoff", seed=3))
    pe, de = _roles(weights[0][1])
    ids = [(7 * i + 3) % 120 + 1 for i in range(40)]
    h = KVHandoff(pe, de, name="test")
    try:
        assert h.run(list(ids), priority=0) == (False, False)
        assert h.snapshot()["fallbacks"] == 1
        assert plane.stats()["failures"].get("handoff", 0) >= 1
        n, _cache = de._kv_pool.lookup(list(ids) + [121], min_tokens=1)
        assert n == 0
        ok, truncated = h.run(list(ids), priority=0)
        assert ok and not truncated, h.snapshot()
        assert plane.stats()["failures"].get("handoff", 0) == 1
    finally:
        h.close()


def test_handoff_into_tp2_pool_serves_the_batcher_exactly(weights):
    """End to end: a prompt handed off from the tp 1 prefill engine into the
    tp 2 pool is gathered by the tp 2 batcher's admission (a pool hit) and
    decodes the sharded engine's tokens; after a swap of the decode engine
    the handoff runs its waves on the new weights (its own copy, cut to the
    prefill role) and the served tokens follow the new weights."""
    (_jp0, tree0), (_jp1, tree1) = weights[0], weights[1]
    pe, de = _roles(tree0)
    plain = _port(tree0, prefill_chunk=16)
    prompt_ids = [(5 * i + 2) % 120 + 1 for i in range(70)]
    h = KVHandoff(pe, de, name="test")
    b = ContinuousBatcher(de, max_batch=2)
    try:
        assert h.run(list(prompt_ids), priority=0) == (True, False)
        hits = de._kv_pool.stats()["hits"]
        got = b.submit_ids(list(prompt_ids), _s(10)).result(timeout=WAIT).token_ids
        assert de._kv_pool.stats()["hits"] > hits
        assert got == plain.generate_ids(list(prompt_ids), _s(10)).token_ids
        assert de.swap_weights(1, tree1)
        other = [(3 * i + 1) % 120 + 1 for i in range(70)]
        assert h.run(list(other), priority=0) == (True, False)
        assert h._tree[0] == 1, h.snapshot()
        want = _port(tree1, prefill_chunk=16).generate_ids(list(other), _s(10)).token_ids
        assert b.submit_ids(list(other), _s(10)).result(timeout=WAIT).token_ids == want
    finally:
        b.close()
        h.close()


def test_provider_disagg_over_tp_roles():
    """The provider's disaggregation with each role on its planned tp 2 mesh
    (4 positions): the prefill engine is sharded over its own mesh, each
    batched request's prompt is handed off (a reshard between two sharded
    layouts) into the sharded decode engine's pool, and the answers equal
    the decode engine's single-stream tokens."""
    prov = GPUProvider(devices=_devs(4), disagg=True, batch_streams=2, kv_pool=True,
                       kv_pool_block=BLOCK, prefill_chunk=16, pool_prefix_min=65536,
                       ignore_eos=True, stream_interval=4)
    try:
        prov.prepare([f"gpu:{PRESET}"], None)
        prompts = ["disaggregated tensor parallel request body " * 2 + str(i) for i in range(2)]
        results = [None, None]

        def one(i):
            results[i] = prov.query(Context.background(), Request(
                model=f"gpu:{PRESET}", prompt=prompts[i], max_tokens=8))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        eng = prov.engines()[PRESET]
        handoff = prov._handoffs[PRESET][1]
        assert eng.sharded and handoff is not None and handoff._pe.sharded
        snap = prov.disagg_stats()[PRESET]
        assert snap["completed"] > 0 and (snap["prefill_devices"], snap["decode_devices"]) == (2, 2)
        assert eng._kv_pool.stats()["handoff_blocks"] > 0
        for p, r in zip(prompts, results):
            assert r.content == eng.generate(p, _s(8)).text, p
    finally:
        prov.release()


def test_a_swap_while_the_prefill_role_is_built_never_tags_old_weights(weights, monkeypatch):
    """A swap of the tp 2 decode engine that lands while the provider copies
    its tree for the tp 2 prefill role parks under the build's pin and flips
    after it: the copy keeps the version it was taken from, so the next wave
    recopies the new weights and publishes their KV (within 2e-2 of the
    decode engine's own prefill on them, bf16; the old weights' KV differs
    by more), never the old weights' KV under the new version."""
    from llm_consensus_tpu_torch.providers.gpu import _cast_tree

    prov = GPUProvider(devices=_devs(4), disagg=True, batch_streams=2, kv_pool=True,
                       kv_pool_block=BLOCK, prefill_chunk=16, pool_prefix_min=65536,
                       ignore_eos=True, stream_interval=4)
    try:
        prov.prepare([f"gpu:{PRESET}"], None)
        eng = prov._engine_for(f"gpu:{PRESET}")
        assert eng.sharded and eng._kv_pool is not None
        ids = [(7 * i + 3) % 120 + 1 for i in range(48)]
        span = (len(ids) // BLOCK) * BLOCK

        def prefill_kv():
            _lg, cache, _w = eng.admission_session([list(ids)]).run()
            return ShardGroup.join_cache(cache, CPU)

        old_kv = prefill_kv()
        real, seen = prov._build_prefill_engine, []

        def build_then_swap(preset, engine):
            pe = real(preset, engine)
            seen.append(prov.swap_weights(f"gpu:{PRESET}", _cast_tree(weights[1][1], eng.dtype)))
            seen.append(engine.swap_pending())
            return pe

        monkeypatch.setattr(prov, "_build_prefill_engine", build_then_swap)
        h = prov._handoff_for(PRESET, eng)
        assert h is not None and h._pe.sharded
        assert seen[0]["accepted"] and seen[1] is True  # parked under the build's pin
        assert eng.weight_version == 1 and eng.swap_stats()["pins"] == 0
        assert h._tree[0] == 0  # the copy is tagged with the version it was taken from
        assert eng._kv_pool.lookup(list(ids) + [121], min_tokens=1)[0] == 0  # evicted
        assert h.run(list(ids), priority=0) == (True, False), h.snapshot()
        assert h._tree[0] == 1 and h.snapshot()["completed"] == 1
        n, gathered = eng._kv_pool.lookup(list(ids) + [121], min_tokens=1)
        assert n == span
        joined = ShardGroup.join_cache(gathered, CPU)
        new_kv = prefill_kv()
        for new, old, got in zip(_leaves(new_kv), _leaves(old_kv), _leaves(joined), strict=True):
            ax = kv_seq_axis(new)
            new, old, got = (t.narrow(ax, 0, span).float() for t in (new, old, got))
            assert torch.allclose(got, new, atol=2e-2, rtol=0)
            assert (got - old).abs().max() > 0.1
    finally:
        prov.release()
