"""The port's disaggregated prefill → decode (``engine/handoff.py``, the role
split ``parallel/mesh.py`` ``split_roles``, the provider's ``disagg`` path)
held to ``tests/test_disagg.py`` case by case, on tiny-llama in float32 on
the CPU.

The JAX side runs as its own tests run it: its provider on two of the
eight virtual CPU devices (the role split needs two), its engines built in
float32 from the same parameter tree (its ``_build_engine`` is swapped for
one that does so; nothing of the JAX package changes). The port runs both
roles on one device (its departure: a one-device slice gives both roles
that device). Greedy tokens are held exactly: disagg on against off in the
port, and against the JAX disagg path.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import integrity as jax_integrity
from llm_consensus_tpu import obs as jax_obs
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine.handoff import KVHandoff as JaxHandoff
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.parallel.mesh import split_roles as jax_split_roles
from llm_consensus_tpu.providers.base import Request as JaxRequest
from llm_consensus_tpu.providers.tpu import TPUProvider
from llm_consensus_tpu.utils.context import Context as JaxContext
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.handoff import KVHandoff
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.obs.attrib import ChipTimeLedger
from llm_consensus_tpu_torch.ops.quant import kv_seq_axis
from llm_consensus_tpu_torch.parallel.mesh import best_tp, split_roles
from llm_consensus_tpu_torch.pressure.priority import PRIORITY_HIGH, PRIORITY_LOW
from llm_consensus_tpu_torch.providers.base import Request
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.utils.context import Context

PRESET = "tiny-llama"
BLOCK = 16
WAIT = 300
PROMPTS = ["shared fleet system prompt " * 4 + f"user {i}" for i in range(2)]


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
    for knob in ("LLMC_FAULTS", "LLMC_DISAGG", "LLMC_INTEGRITY", "LLMC_KV_POOL"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()
    jax_obs.reset()
    yield
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()
    jax_obs.reset()


def _trees(seed: int):
    jp = jax_init(jax_config(PRESET), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(PRESET),
                                 torch.device("cpu"), torch.float32)


@pytest.fixture(scope="module")
def weights():
    """Seed 0 (served) and seed 3 (a swap's) in both layouts."""
    return {0: _trees(0), 3: _trees(3)}


def _engine(tree, *, pool: bool, **kw):
    kw.setdefault("stream_interval", 4)
    kw.setdefault("prefill_chunk", 16)
    return Engine(get_config(PRESET), params=tree, dtype=torch.float32, max_seq=256,
                  device="cpu", kv_pool=pool, kv_pool_block=BLOCK, **kw)


def _provider(tree, *, disagg: bool, pool: bool = True, stream_interval: int = 4, **kw):
    """A batched port provider serving tiny-llama from a float32 engine of
    ``tree`` (placed in its engine table, as a checkpoint would be)."""
    prov = GPUProvider(device="cpu", ignore_eos=True, stream_interval=stream_interval,
                       batch_streams=2, pool_prefix_min=65536, prefill_chunk=16, kv_pool=pool,
                       kv_pool_block=BLOCK, disagg=disagg, **kw)
    prov._engines[PRESET] = _engine(tree, pool=pool, stream_interval=stream_interval)
    prov.prepare([f"gpu:{PRESET}"], None)
    return prov


def _fire_all(prov, prompts, max_tokens=10, jax_side=False):
    """Every prompt at once on its own thread (the JAX test's ``_fire_all``)."""
    results = [None] * len(prompts)
    req, ctx = (JaxRequest, JaxContext) if jax_side else (Request, Context)
    model = f"{'tpu' if jax_side else 'gpu'}:{PRESET}"

    def one(i):
        results[i] = prov.query_stream(ctx.background(), req(
            model=model, prompt=prompts[i], max_tokens=max_tokens), lambda _t: None)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r is not None for r in results)
    return results


def _jax_provider(monkeypatch, tree, *, disagg: bool, pool: bool, devices: int, **kw):
    """The JAX provider as tests/test_disagg.py runs it, its engines float32
    from ``tree``."""
    for knob, value in (("LLMC_PREFILL_CHUNK", "16"), ("LLMC_KV_POOL_BLOCK", str(BLOCK)),
                        ("LLMC_POOL_PREFIX_MIN", "65536"), ("LLMC_KV_POOL", "1" if pool else "0"),
                        ("LLMC_PREFIX_CACHE", "1")):
        monkeypatch.setenv(knob, value)

    def build(self, preset, mesh=None, kv_pool=True):
        return JaxEngine(jax_config(preset), params=tree, dtype=jnp.float32, max_seq=256,
                         mesh=mesh, stream_interval=4, kv_pool=kv_pool)

    monkeypatch.setattr(TPUProvider, "_build_engine", build)
    prov = TPUProvider(ignore_eos=True, stream_interval=4, batch_streams=2, disagg=disagg, **kw)
    prov.prepare([f"tpu:{PRESET}"], None, devices=jax.devices()[:devices])
    return prov


@pytest.fixture(scope="module")
def jax_disagg(weights):
    """The JAX disagg path's greedy texts for PROMPTS, computed once."""
    with pytest.MonkeyPatch.context() as mp:
        prov = _jax_provider(mp, weights[0][0], disagg=True, pool=True, devices=2)
        try:
            texts = [r.content for r in _fire_all(prov, PROMPTS, jax_side=True)]
            snap = prov.disagg_stats()[PRESET]
        finally:
            prov.release()
    assert snap["completed"] + snap["covered"] > 0, snap
    return texts


# -- role carving -------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [0.25, 0.5, 0.75])
def test_split_roles_matches_jax(fraction):
    """Two or more devices: the JAX carving, device for device (disjoint,
    power-of-two slices, the decode role leading, tp-valid by
    construction)."""
    jcfg, cfg = jax_config(PRESET), get_config(PRESET)
    devs = [torch.device("cuda", i) for i in range(8)]
    for n in (2, 3, 4, 5, 8):
        pmesh, dmesh = jax_split_roles(jcfg, jax.devices()[:n], fraction)
        pdevs, ddevs = split_roles(cfg, devs[:n], fraction)
        assert [d.index for d in pdevs] == [d.id for d in pmesh.devices.flat], (n, fraction)
        assert [d.index for d in ddevs] == [d.id for d in dmesh.devices.flat], (n, fraction)
        assert not {d.index for d in pdevs} & {d.index for d in ddevs}
        for role in (pdevs, ddevs):
            size = len(role)
            assert size & (size - 1) == 0 and size == best_tp(cfg, size)


def test_split_roles_one_device_gives_both_roles_the_device():
    """The departure: JAX gives a one-device slice no prefill role; the port
    gives both roles that device (the handoff runs on a stream of its own)."""
    pmesh, dmesh = jax_split_roles(jax_config(PRESET), jax.devices()[:1], 0.5)
    assert pmesh is None and dmesh.devices.size == 1
    dev = torch.device("cuda", 0)
    assert split_roles(get_config(PRESET), [dev], 0.5) == ([dev], [dev])
    with pytest.raises(ValueError):
        split_roles(get_config(PRESET), [], 0.5)


# -- the handed-off bytes ---------------------------------------------------------------------


def _leaves(cache):
    for name in sorted(cache):
        node = cache[name]
        yield from (_leaves(node) if isinstance(node, dict) else [node])


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32kv", "int8kv"])
def test_published_bytes_equal_the_prefill_sides(weights, kv_quant):
    """The transport contract: KV handed off into the decode pool gathers
    back bitwise-equal to the bytes the prefill role computed, the int8
    cache's codes and scales included."""
    de = _engine(weights[0][1], pool=True, kv_quant=kv_quant)
    pe = Engine(get_config(PRESET), de.params, dtype=torch.float32, max_seq=256,
                prefill_chunk=16, device="cpu", kv_quant=kv_quant, prefix_cache=False)
    ids = [(7 * i + 3) % 120 + 1 for i in range(100)]
    _lg, ref_cache, _w = pe.admission_session([list(ids)]).run()
    h = KVHandoff(pe, de, name="test")
    try:
        ok, truncated = h.run(list(ids), priority=0)
        assert ok and not truncated, h.snapshot()
        span = (len(ids) // BLOCK) * BLOCK
        n, gathered = de._kv_pool.lookup(list(ids) + [121], min_tokens=1)
        assert n == span, (n, span)
        for ref, got in zip(_leaves(ref_cache), _leaves(gathered), strict=True):
            ax = kv_seq_axis(ref)
            assert torch.equal(got.narrow(ax, 0, span), ref.narrow(ax, 0, span))
        assert de._kv_pool.stats()["handoff_blocks"] == span // BLOCK
    finally:
        h.close()


# -- the bounded, priority-ordered queue ------------------------------------------------------


def _queue_order(handoff_cls, pe, de, monkeypatch):
    order: list = []
    first_in = threading.Event()
    done = threading.Event()

    def fake_wave(self, batch, wave_n):
        if not order:
            first_in.set()
            done.wait(10)  # the first wave blocks until the rest queued
        for t in batch:
            order.append(tuple(t.ids[:2]))
            t.resolve(True)

    monkeypatch.setattr(handoff_cls, "_wave", fake_wave)
    h = handoff_cls(pe, de, depth=8, wave_rows=1, name="test")
    try:
        first = h.submit([9, 9] + list(range(30)), priority=1)
        assert first is not None and first_in.wait(10)
        tickets = [first,
                   h.submit([2, 2] + list(range(30)), priority=2),
                   h.submit([1, 1] + list(range(31)), priority=1),
                   h.submit([0, 0] + list(range(32)), priority=0),
                   h.submit([1, 3] + list(range(33)), priority=1)]
        done.set()
        for t in tickets:
            assert t is not None and t.wait(10)
    finally:
        h.close()
    return order


def _jax_pair(weights, monkeypatch):
    monkeypatch.setenv("LLMC_KV_POOL_BLOCK", str(BLOCK))
    monkeypatch.setenv("LLMC_KV_POOL", "1")
    jp = weights[0][0]
    de = JaxEngine(jax_config(PRESET), params=jp, dtype=jnp.float32, max_seq=256,
                   prefill_chunk=16)
    pe = JaxEngine(jax_config(PRESET), params=jp, dtype=jnp.float32, max_seq=256,
                   prefill_chunk=16)
    return pe, de


def test_queue_pops_in_priority_order(weights, monkeypatch):
    """After the blocked first wave: HIGH, then the NORMALs in arrival
    order, then LOW; the same order from the JAX handoff."""
    de = _engine(weights[0][1], pool=True)
    got = _queue_order(KVHandoff, de, de, monkeypatch)
    assert got == [(9, 9), (0, 0), (1, 1), (1, 3), (2, 2)]
    assert got == _queue_order(JaxHandoff, *_jax_pair(weights, monkeypatch), monkeypatch)


def _depth_rejects(handoff_cls, pe, de, monkeypatch):
    gate = threading.Event()

    def fake_wave(self, batch, wave_n):
        gate.wait(10)
        for t in batch:
            t.resolve(True)

    monkeypatch.setattr(handoff_cls, "_wave", fake_wave)
    h = handoff_cls(pe, de, depth=2, wave_rows=1, name="test")
    try:
        first = h.submit(list(range(20)), priority=1)
        deadline = time.monotonic() + 10
        while h.queued() and time.monotonic() < deadline:
            time.sleep(0.002)  # the worker popped it: one in flight
        rest = [h.submit([i] + list(range(20 + i)), priority=1) for i in range(1, 5)]
        rejected = sum(1 for t in rest if t is None)
        snap = h.snapshot()
        sat = h.saturation()
        gate.set()
        for t in [first] + rest:
            if t is not None:
                assert t.wait(10)
    finally:
        gate.set()
        h.close()
    return rejected, snap["rejected"], sat


def test_queue_rejects_beyond_its_depth(weights, monkeypatch):
    """One wave in flight, two queued, the rest rejected (backpressure, not
    stacked latency), as the JAX handoff does."""
    de = _engine(weights[0][1], pool=True)
    got = _depth_rejects(KVHandoff, de, de, monkeypatch)
    assert got == (2, 2, 1.0)
    assert got == _depth_rejects(JaxHandoff, *_jax_pair(weights, monkeypatch), monkeypatch)


def test_queue_counts_hold_under_concurrent_submitters(weights, monkeypatch):
    """Stress: 32 submitter threads (more than cores) against a small
    queue, the switch interval shortened: every ticket handed out is
    resolved exactly once, and the counters add up (submitted = rejected +
    queued work, none lost)."""
    import sys

    resolved: list = []
    lock = threading.Lock()

    def fake_wave(self, batch, wave_n):
        time.sleep(0.001)
        for t in batch:
            with lock:
                resolved.append(t.seq)
            t.resolve(True)

    monkeypatch.setattr(KVHandoff, "_wave", fake_wave)
    de = _engine(weights[0][1], pool=True)
    h = KVHandoff(de, de, depth=4, wave_rows=2, name="stress")
    got: list = [None] * 32
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def one(i):
            got[i] = [h.submit([i % 7 + 1] + list(range(40 + j)), priority=i % 3)
                      for j in range(5)]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        tickets = [t for row in got for t in row if t is not None]
        assert all(t.wait(30) and t.ok for t in tickets)
    finally:
        sys.setswitchinterval(old)
        h.close()
    snap = h.snapshot()
    assert snap["submitted"] == 32 * 5
    assert snap["submitted"] == snap["rejected"] + len(tickets)
    assert sorted(resolved) == sorted(t.seq for t in tickets)  # each exactly once


# -- the provider: identity, fallback, telemetry ------------------------------------------------


def test_greedy_identity_on_off_and_against_the_jax_disagg_path(weights, jax_disagg):
    """Disagg on equals disagg off (the classic batched path without the
    pool) equals the JAX provider's disagg path, token for token; the
    handoffs completed with no fallback and published blocks."""
    off = _provider(weights[0][1], disagg=False, pool=False)
    try:
        base = [r.content for r in _fire_all(off, PROMPTS)]
    finally:
        off.release()
    on = _provider(weights[0][1], disagg=True)
    try:
        got = [r.content for r in _fire_all(on, PROMPTS)]
        snap = on.disagg_stats()[PRESET]
        kv = on.kv_stats()[PRESET]
    finally:
        on.release()
    assert got == base == jax_disagg
    assert snap["completed"] == len(PROMPTS) and snap["fallbacks"] == 0, snap
    assert snap["shared_device"] and kv["handoff_blocks"] > 0, kv


def test_a_prompt_under_one_prefill_chunk_takes_no_handoff_on_one_device(weights):
    """Both roles on one device: the decode side reuses a pool match only
    from one prefill chunk on, so a shorter prompt's handoff would prefill
    it twice on the same device. ``submit`` refuses it (the caller admits
    classically; a departure from the JAX worker, which hands off every
    prompt of one block) and the provider serves it unchanged."""
    de = _engine(weights[0][1], pool=True, prefill_chunk=48)
    h = KVHandoff(de, de, name="test")
    try:
        assert h.min_tokens == 48
        assert h.submit(list(range(20))) is None and h.submit(list(range(47))) is None
        assert h.snapshot()["submitted"] == 0
        t = h.submit(list(range(48)))
        assert t is not None and t.wait(WAIT) and t.ok
    finally:
        h.close()
    short, long_ = "a question of a few words?", PROMPTS[0]
    off = _provider(weights[0][1], disagg=False, pool=False)
    try:
        base = [r.content for r in _fire_all(off, [short, long_])]
    finally:
        off.release()
    prov = _provider(weights[0][1], disagg=True)
    prov._engines[PRESET] = _engine(weights[0][1], pool=True, prefill_chunk=48)
    try:
        n_short = len(prov._engines[PRESET].tokenizer.encode(short))
        assert BLOCK <= n_short < 48
        (got,) = _fire_all(prov, [short])
        snap = prov.disagg_stats()[PRESET]
        assert got.content == base[0] and snap["submitted"] == 0, snap
        (got_long,) = _fire_all(prov, [long_])
        snap = prov.disagg_stats()[PRESET]
        assert got_long.content == base[1] and snap["completed"] == 1, snap
    finally:
        prov.release()


def test_fallback_on_crash_keeps_bytes_and_the_worker(weights, jax_disagg):
    """``prefill_worker_crash@wave=1`` fails that wave to the classic path
    (the same greedy bytes) and the worker survives to complete the next."""
    faults.install(faults.FaultPlan("prefill_worker_crash@wave=1", seed=3))
    prov = _provider(weights[0][1], disagg=True)
    try:
        got = [r.content for r in _fire_all(prov, PROMPTS)]
        snap = prov.disagg_stats()[PRESET]
        assert got == jax_disagg
        assert snap["fallbacks"] >= 1, snap
        got2 = [r.content for r in _fire_all(prov, PROMPTS)]
        snap2 = prov.disagg_stats()[PRESET]
    finally:
        prov.release()
    assert got2 == jax_disagg
    assert snap2["completed"] + snap2["covered"] > 0, snap2
    assert any(t.endswith("->prefill_worker_crash") for t in faults.plan().trace)


def test_handoff_stall_times_out_to_the_classic_path(weights):
    """A ``handoff_stall`` longer than the submitter's wait times the
    submitter out (classic path), while the stalled worker survives: the
    wave completes behind the timeout and repeat traffic is covered."""
    faults.install(faults.FaultPlan("handoff_stall@s=0.4", seed=11))
    de = _engine(weights[0][1], pool=True)
    pe = Engine(get_config(PRESET), de.params, dtype=torch.float32, max_seq=256,
                prefill_chunk=16, device="cpu", prefix_cache=False)
    ids = [(3 * i + 5) % 120 + 1 for i in range(64)]
    h = KVHandoff(pe, de, wait_s=0.05, name="test")
    try:
        assert h.run(list(ids), priority=1) == (False, False)
        assert h.snapshot()["timeouts"] >= 1
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and h.snapshot()["completed"] < 1:
            time.sleep(0.02)
        assert h.snapshot()["completed"] >= 1, h.snapshot()
        t = h.submit(list(ids), priority=1)
        assert t is not None and t.wait(10) and t.ok
        assert h.snapshot()["covered"] >= 1
    finally:
        h.close()


def test_overlapped_wait_abandons_on_cancel_and_matches_run(weights, monkeypatch):
    """The polled wait returns within a slice of a cancel (not the 30 s
    bound), the abandoned wave still completes behind it, and with a live
    worker it returns what ``run`` would; the knob's default is on in both
    packages."""
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    monkeypatch.delenv("LLMC_DISAGG_OVERLAP", raising=False)
    assert knobs.disagg_settings()["disagg_overlap"] is jax_knobs.get_bool(
        "LLMC_DISAGG_OVERLAP") is True
    gate, resolved = threading.Event(), threading.Event()

    def fake_wave(self, batch, wave_n):
        gate.wait(10)
        for t in batch:
            t.resolve(True)
        resolved.set()

    monkeypatch.setattr(KVHandoff, "_wave", fake_wave)
    de = _engine(weights[0][1], pool=True)
    h = KVHandoff(de, de, depth=2, wave_rows=1, wait_s=30.0, name="test")
    try:
        ctx = Context.background().with_cancel()
        threading.Timer(0.2, ctx.cancel).start()
        t0 = time.monotonic()
        assert h.run_overlapped(list(range(24)), priority=1, ctx=ctx, poll_s=0.05) == (False,
                                                                                       False)
        assert time.monotonic() - t0 < 5.0
        snap = h.snapshot()
        assert snap["overlap_abandons"] == 1 and snap["overlap_polls"] >= 1, snap
        gate.set()
        assert resolved.wait(10)
        assert h.run_overlapped(list(range(30)), priority=1, poll_s=0.02) == (True, False)
        assert h.snapshot()["overlap_abandons"] == 1
    finally:
        gate.set()
        h.close()


def test_disagg_off_leaves_no_handoff_state(weights):
    prov = _provider(weights[0][1], disagg=False)
    try:
        _fire_all(prov, ["plain request body " * 4])
        assert prov._handoffs == {}
        assert prov.disagg_stats() == {}
        assert "handoff_queued" not in prov.pressure_stats()[PRESET]
        assert not any(k.endswith(":prefill") for k in prov.utilization_stats())
    finally:
        prov.release()


def test_telemetry_and_the_pressure_signal(weights):
    """``disagg_stats`` carries the handoff counters, ``utilization_stats``
    a per-role prefill entry, ``pressure_stats`` the handoff queue; the KV
    pool counts the handoff's blocks."""
    prov = _provider(weights[0][1], disagg=True)
    try:
        _fire_all(prov, ["telemetry stream body words " * 4 + str(i) for i in range(2)])
        snap = prov.disagg_stats()[PRESET]
        assert snap["completed"] > 0 and snap["handoff_bytes"] > 0, snap
        assert snap["prefill_devices"] == snap["decode_devices"] == 1
        util = prov.utilization_stats()
        assert util[f"{PRESET}:prefill"]["role"] == "prefill", util
        assert "handoff_queued" not in prov.pressure_stats()[PRESET]  # an empty queue
        handoff = prov._handoffs[PRESET][1]
        handoff.queued = lambda: 1  # one ticket waiting for the prefill role
        ps = prov.pressure_stats()[PRESET]
        assert ps["handoff_queued"] == 1 and ps["queued"] >= 1, ps
        assert prov.kv_stats()[PRESET]["handoff_blocks"] > 0
    finally:
        prov.release()


def test_truncated_publish_surfaces_kv_truncated(weights):
    """Pool exhaustion on the HANDOFF path marks the response's ``kv``
    block truncated as the local path does; the staging component and the
    ``kv_handoff`` family were booked."""
    led = ChipTimeLedger(warmup_s=3600.0)
    obs.attrib.install(led)
    faults.install(faults.FaultPlan("pool_exhausted@times=-1", seed=7))
    prov = _provider(weights[0][1], disagg=True)
    try:
        (resp,) = _fire_all(prov, ["exhaustion-bound prompt body " * 4])
        snap = prov.disagg_stats()[PRESET]
    finally:
        prov.release()
    assert resp.kv == {"truncated": True}, resp.kv
    assert snap["truncated"] >= 1, snap
    ledger = led.snapshot()
    assert f"handoff_staging:{PRESET}" in ledger["hbm"]["components"]
    assert ledger["device_s"].get("kv_handoff", 0) > 0


def test_preempt_resume_rides_the_handoff_kv(weights):
    """A HIGH latecomer preempts a LOW resident of a full disaggregated
    pool: every stream emits the uncontended greedy tokens, and the
    victim's resume gathers the handoff-published blocks."""
    low_prompts = [f"low class resident stream {i} body words " * 3 for i in range(2)]
    hi_prompt = "high class latecomer body"
    ref = _engine(weights[0][1], pool=False, stream_interval=8)
    base_low = [ref.generate(p, SamplingParams(max_new_tokens=24, ignore_eos=True)).text
                for p in low_prompts]
    base_hi = ref.generate(hi_prompt, SamplingParams(max_new_tokens=8, ignore_eos=True)).text
    prov = _provider(weights[0][1], disagg=True, stream_interval=8)
    try:
        for i, p in enumerate(low_prompts):  # warm: the prompts publish
            r = prov.query_stream(Context.background(), Request(
                model=f"gpu:{PRESET}", prompt=p, max_tokens=24, priority=PRIORITY_LOW), None)
            assert r.content == base_low[i]
        batcher = None
        for _attempt in range(3):
            results: dict = {}

            def one(key, prompt, max_tokens, priority):
                results[key] = prov.query_stream(Context.background(), Request(
                    model=f"gpu:{PRESET}", prompt=prompt, max_tokens=max_tokens,
                    priority=priority), None)

            threads = [threading.Thread(target=one, args=(i, p, 24, PRIORITY_LOW))
                       for i, p in enumerate(low_prompts)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                batcher = prov._batchers.get(PRESET)
                if batcher is not None and sum(s is not None for s in batcher._slots) == 2:
                    break
                time.sleep(0.005)
            t_hi = threading.Thread(target=one, args=("hi", hi_prompt, 8, PRIORITY_HIGH))
            t_hi.start()
            for t in threads + [t_hi]:
                t.join()
            if batcher.snapshot()["preemptions"] >= 1:
                break
        assert batcher is not None and batcher.snapshot()["preemptions"] >= 1
        assert results["hi"].content == base_hi
        for i in range(2):
            assert results[i].content == base_low[i], f"victim {i}"
        stats = prov._engines[PRESET]._kv_pool.stats()
    finally:
        prov.release()
    assert stats["hit_tokens"] > 0 and stats["handoff_blocks"] > 0, stats


# -- a weight swap never publishes old-weight KV ----------------------------------------------


SWAP_PROMPT = "after the swap a fresh question arrives with its own words " * 2


def _fresh_text(tree_torch, prompt, n=10):
    return _engine(tree_torch, pool=False).generate(
        prompt, SamplingParams(max_new_tokens=n, ignore_eos=True)).text


def test_a_swap_never_publishes_old_weight_kv(weights, monkeypatch):
    """(1) A swap that arrives while a wave prefills parks under the wave's
    pin; the wave publishes, the flip evicts what it published, and the
    request runs on the new weights. (2) A wave after the swap prefills on
    the new tree. Either way the text equals a fresh engine's on the new
    weights. The JAX provider, run through (2), publishes its prefill
    engine's old-weight KV into the swapped decode engine's pool (a
    reference defect the port does not share)."""
    new_text = _fresh_text(weights[3][1], SWAP_PROMPT)
    old_text = _fresh_text(weights[0][1], SWAP_PROMPT)
    assert new_text != old_text
    prov = _provider(weights[0][1], disagg=True)
    try:
        _fire_all(prov, PROMPTS)  # builds the handoff
        pe = prov._handoffs[PRESET][1]._pe
        real, seen = pe.admission_session, []

        def swap_mid_wave(rows, *a, **k):
            if not seen:
                seen.append(prov.swap_weights(f"gpu:{PRESET}", weights[3][1]))
                seen.append(prov._engines[PRESET].swap_pending())
            return real(rows, *a, **k)

        pe.admission_session = swap_mid_wave
        (r1,) = _fire_all(prov, [SWAP_PROMPT])
        de = prov._engines[PRESET]
        assert seen[0]["accepted"] and seen[1] is True  # parked under the wave's pin
        assert de.weight_version == 1 and de.swap_stats()["pins"] == 0
        assert r1.content == new_text
        assert prov.disagg_stats()[PRESET]["completed"] >= len(PROMPTS) + 1
        # (2): a later wave on another prompt runs on the new tree.
        later = SWAP_PROMPT + "and one more line"
        (r2,) = _fire_all(prov, [later])
        assert r2.content == _fresh_text(weights[3][1], later)
    finally:
        prov.release()
    # The JAX provider through (2): swap first, then a fresh prompt.
    jprov = _jax_provider(monkeypatch, weights[0][0], disagg=True, pool=True, devices=2)
    try:
        _fire_all(jprov, PROMPTS, jax_side=True)
        out = jprov.swap_weights(f"tpu:{PRESET}", weights[3][0], wait=True)
        assert out["accepted"]
        (jr,) = _fire_all(jprov, [SWAP_PROMPT], jax_side=True)
        jsnap = jprov.disagg_stats()[PRESET]
    finally:
        jprov.release()
    assert jsnap["completed"] >= len(PROMPTS) + 1  # the handoff published after the swap
    assert jr.content != new_text  # decoded over the old weights' prompt KV
