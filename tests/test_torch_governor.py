"""The port's pressure governor and admission controller against the JAX
package's (the ladder, admission and storm cases of tests/test_pressure.py
and its eviction case at :712), and the governor over the port's real tiny
engines: its evict, preempt and brownout rungs reach the KV pool and the
continuous batcher.

The same scripted pressure samples go through both ``PressureGovernor``s
and the test compares the rung after every sample, the counters, and what
each governor did to its fake providers.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import llm_consensus_tpu.faults as jax_faults
from llm_consensus_tpu.pressure import PressureGovernor as JaxGovernor
from llm_consensus_tpu.serve.admission import AdmissionController as JaxAdmission
from llm_consensus_tpu.serve.admission import QueueFull as JaxQueueFull
from llm_consensus_tpu_torch import faults, obs
from llm_consensus_tpu_torch.engine import SamplingParams
from llm_consensus_tpu_torch.pressure import (
    PRIORITY_HIGH, PRIORITY_LOW, PRIORITY_NORMAL, PressureGovernor, parse_judge_fallback)
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.serve.admission import AdmissionController, QueueFull

WAIT = 30.0
PAIRS = ((JaxGovernor, JaxAdmission, JaxQueueFull, jax_faults),
         (PressureGovernor, AdmissionController, QueueFull, faults))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("LLMC_FAULTS", "LLMC_PRESSURE_JUDGE_FALLBACK"):
        monkeypatch.delenv(knob, raising=False)
    faults.reset()
    jax_faults.reset()
    obs.reset_planes()
    yield
    faults.reset()
    jax_faults.reset()
    obs.reset_planes()


def _gov(cls, **kw):
    kw.setdefault("high_water", 0.75)
    kw.setdefault("low_water", 0.35)
    kw.setdefault("up_patience", 2)
    kw.setdefault("down_patience", 3)
    return cls(**kw)


class _Recorder:
    """A fake provider logging what a governor asks of it."""

    def __init__(self, kv=None, pools=None):
        self.log: list = []
        self.kv = kv or {}
        self.pools = pools or {}

    def set_brownout(self, on):
        self.log.append(("brownout", on))

    def request_preempt(self, n):
        self.log.append(("preempt", n))

    def kv_evict_cold(self, target):
        self.log.append(("evict", target))
        return 2

    def kv_stats(self):
        return self.kv

    def pressure_stats(self):
        return self.pools


SEQUENCES = {
    "patience": [0.9, 0.9, 0.9, 0.9],
    "climb": [1.0] * 6,
    "mid_band": [0.9, 0.5, 0.9, 0.9, 0.5, 0.5],
    "relax": [1.0, 1.0, 1.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.2, 0.1, 0.1],
    "flap": [1.0, 0.1, 1.0, 0.1, 1.0, 1.0, 0.34, 0.36, 0.34, 0.34, 0.34],
    "clamped": [5.0, -1.0, 2.0, 0.75, 0.35],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("up,down", [(1, 1), (2, 3), (1, 4)])
def test_same_samples_walk_the_same_rungs(name, up, down):
    runs = []
    for cls, *_ in PAIRS:
        prov = _Recorder()
        g = _gov(cls, up_patience=up, down_patience=down, provider_iter=lambda p=prov: [p])
        rungs = [g.observe(v) for v in SEQUENCES[name]]
        snap = g.snapshot()
        snap.pop("signals", None)
        runs.append((rungs, snap, prov.log, g.brownout))
    assert runs[0] == runs[1]


def test_ladder_escalates_one_rung_per_patience_window():
    for cls, *_ in PAIRS:
        g = _gov(cls, up_patience=2)
        assert [g.observe(0.9) for _ in range(4)] == ["ok", "evict", "evict", "preempt"]
        g2 = _gov(cls, up_patience=1)
        assert [g2.observe(1.0) for _ in range(5)] == [
            "evict", "preempt", "brownout", "shed", "shed"]


def test_should_shed_only_at_shed_rung_and_only_shed_classes():
    out = []
    for cls, *_ in PAIRS:
        g = _gov(cls, up_patience=1, shed_class=PRIORITY_LOW)
        before = g.should_shed(PRIORITY_LOW)
        for _ in range(4):
            g.observe(1.0)
        out.append((before, g.state, [g.should_shed(c) for c in (0, 1, 2)],
                    g.snapshot()["shed"]))
    assert out[0] == out[1] == (False, "shed", [False, False, True], 1)


def test_brownout_judge_fallback_map_and_clamp():
    for cls, *_ in PAIRS:
        g = _gov(cls, judge_fallback={"gpu:big": "gpu:small"}, brownout_max_new=64)
        assert g.brownout_judge("gpu:big") == "gpu:small"
        assert g.brownout_judge("gpu:other") == "gpu:other"
        assert g.brownout_judge("gpu:big", available=["gpu:big"]) == "gpu:big"
        assert [g.clamp_max_tokens(v) for v in (None, 512, 16)] == [64, 64, 16]
    # The knob's grammar (the port's serve parses LLMC_PRESSURE_JUDGE_FALLBACK
    # with it; the JAX governor reads the knob itself).
    assert parse_judge_fallback("gpu:big=gpu:small, gpu:consensus-1b") == {
        "gpu:big": "gpu:small", "*": "gpu:consensus-1b"}
    assert parse_judge_fallback("") == {}


def test_governor_kv_and_batcher_signals_read_deltas():
    out = []
    for cls, *_ in PAIRS:
        prov = _Recorder(kv={"tiny": {"exhausted": 0, "evicted_blocks": 0, "occupancy": 0.2}},
                         pools={"tiny": {"live": 3, "queued": 2, "cap": 4}})
        g = _gov(cls, provider_iter=lambda p=prov: [p])
        seq = [g.pressure_signals()]
        prov.kv["tiny"]["exhausted"] = 3
        seq.append(g.pressure_signals())
        seq.append(g.pressure_signals())
        prov.kv["tiny"]["evicted_blocks"] = 5
        seq.append(g.pressure_signals())
        out.append(seq)
    assert out[0] == out[1]
    assert [s["kv"] for s in out[1]] == [0.1, 1.0, 0.1, 0.7]
    assert out[1][0]["batcher"] == 1.0


def test_sample_applies_the_rung_actions_to_providers():
    out = []
    for cls, *_ in PAIRS:
        prov = _Recorder(pools={"tiny": {"live": 4, "queued": 4, "cap": 4}})
        g = _gov(cls, up_patience=1, down_patience=1, evict_target=0.5,
                 provider_iter=lambda p=prov: [p])
        states = [g.sample() for _ in range(4)]
        snap = g.snapshot()
        out.append((states, prov.log, snap["evicted_blocks"], snap["preempt_nudges"]))
    assert out[0] == out[1]
    states, log, evicted, nudges = out[1]
    assert states == ["evict", "preempt", "brownout", "shed"]
    assert ("evict", 0.5) in log and ("preempt", 1) in log and ("brownout", True) in log
    assert evicted > 0 and nudges == 3


def test_priority_ordered_dequeue_with_fifo_within_class():
    orders = []
    for _gcls, acls, *_ in PAIRS:
        ctl = acls(1, max_queue=8, age_s=1000)
        t0 = ctl.admit()
        order: list = []

        def waiter(pri, tag):
            t = ctl.admit(priority=pri)
            order.append(tag)
            t.release()

        threads = []
        for pri, tag in [(PRIORITY_LOW, "low0"), (PRIORITY_NORMAL, "norm0"),
                         (PRIORITY_LOW, "low1"), (PRIORITY_HIGH, "high0"),
                         (PRIORITY_NORMAL, "norm1")]:
            th = threading.Thread(target=waiter, args=(pri, tag), daemon=True)
            th.start()
            threads.append(th)
            time.sleep(0.05)
        t0.release()
        for th in threads:
            th.join(WAIT)
        orders.append(order)
    assert orders[0] == orders[1] == ["high0", "norm0", "norm1", "low0", "low1"]


def test_aging_bounds_lowest_class_starvation():
    firsts = []
    for _gcls, acls, *_ in PAIRS:
        ctl = acls(1, max_queue=8, age_s=0.05)
        t0 = ctl.admit()
        order: list = []

        def waiter(pri, tag):
            t = ctl.admit(priority=pri)
            order.append(tag)
            t.release()

        a = threading.Thread(target=waiter, args=(PRIORITY_LOW, "low"), daemon=True)
        a.start()
        time.sleep(0.3)
        b = threading.Thread(target=waiter, args=(PRIORITY_HIGH, "high"), daemon=True)
        b.start()
        time.sleep(0.05)
        t0.release()
        a.join(WAIT)
        b.join(WAIT)
        firsts.append(order[0])
    assert firsts == ["low", "low"]


def test_queue_full_bumps_lower_class_instead_of_shedding_higher():
    outs = []
    for _gcls, acls, qf, _f in PAIRS:
        ctl = acls(1, max_queue=1, age_s=1000)
        t0 = ctl.admit()
        outcome: dict = {}

        def low():
            try:
                ctl.admit(priority=PRIORITY_LOW).release()
                outcome["low"] = "admitted"
            except qf as err:
                outcome["low"] = ("bumped", 3.0 <= err.retry_after_s * 2 < 6.0)

        def high():
            ctl.admit(priority=PRIORITY_HIGH).release()
            outcome["high"] = "admitted"

        th_low = threading.Thread(target=low, daemon=True)
        th_low.start()
        time.sleep(0.1)
        th_high = threading.Thread(target=high, daemon=True)
        th_high.start()
        time.sleep(0.1)
        with pytest.raises(qf):
            ctl.admit(priority=PRIORITY_HIGH)  # same class queued: no bump
        t0.release()
        th_low.join(WAIT)
        th_high.join(WAIT)
        snap = ctl.snapshot()
        outs.append((outcome, snap["bumped"], snap["rejected"]))
    assert outs[0] == outs[1]
    assert outs[1][0]["high"] == "admitted" and outs[1][0]["low"][0] == "bumped"


def test_priority_storm_floods_real_admissions():
    """``priority_storm`` pushes synthetic LOW admits through the REAL
    controller, and a HIGH arrival still admits through the storm."""
    out = []
    for gcls, acls, _qf, fmod in PAIRS:
        ctl = acls(2, max_queue=8, age_s=1000)
        fmod.install(fmod.FaultPlan("priority_storm@phase=governor@n=4@s=0.3", seed=9))
        try:
            g = gcls(admission_snapshot=ctl.snapshot, up_patience=1)
            g._storm_admit = lambda c=ctl: c.admit(priority=PRIORITY_LOW)
            g.sample()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                snap = ctl.snapshot()
                if snap["active"] + snap["waiting"] >= 4:
                    break
                time.sleep(0.01)
            snap = ctl.snapshot()
            assert snap["active"] + snap["waiting"] >= 4, snap
            ctl.admit(priority=PRIORITY_HIGH).release()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and g.snapshot()["storm_admits"] < 4:
                time.sleep(0.05)
            out.append((g.snapshot()["storm_admits"], ctl.snapshot()["admitted"]))
        finally:
            fmod.reset()
    assert out[0] == out[1] == (4, 5)


# -- the governor over the port's real engines ---------------------------------


def _provider(**kw):
    kw.setdefault("batch_streams", 4)
    return GPUProvider(device="cpu", max_seq=256, stream_interval=4, ignore_eos=True, **kw)


def test_evict_rung_reaches_the_kv_pool_at_its_target():
    """tests/test_pressure.py:712 through the governor: ``evict`` frees cold
    KV-pool blocks down to the target occupancy, and the freed blocks do
    not read back as eviction pressure."""
    prov = _provider(batch_streams=1, kv_pool=True, kv_pool_block=16)
    try:
        eng = prov._engine_for("gpu:tiny-llama")
        s = SamplingParams(max_new_tokens=4, ignore_eos=True)
        for i in range(3):
            eng.generate(f"distinct prefix number {i} " * 3, s)
        before = eng._kv_pool.stats()["blocks_used"]
        assert before > 0
        g = PressureGovernor(provider_iter=lambda: [prov], up_patience=1, evict_target=0.0)
        assert g.sample() == "ok"  # occupancy alone is not pressure
        assert g.observe(1.0) == "evict"
        g._evict_cold()
        after = eng._kv_pool.stats()["blocks_used"]
        assert after < before and g.snapshot()["evicted_blocks"] == before - after
        assert g.pressure_signals()["kv"] < g.high_water
        assert prov.kv_evict_cold(1.0) == 0  # already under a full target
    finally:
        prov.release()


def test_preempt_and_brownout_rungs_reach_the_batcher():
    """The governor's preempt nudge lands in the batcher (a LOW resident
    yields its slot to a blocked HIGH stream and resumes to the same
    tokens), and its brownout flag reaches the provider and the pool."""
    prov = _provider(batch_streams=1)
    try:
        eng = prov._engine_for("gpu:tiny-llama")
        from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

        batcher = ContinuousBatcher(eng, max_batch=1, pool_bucket=False)
        with prov._lock:
            prov._batchers["tiny-llama"] = batcher
        nudges = []
        real_preempt = batcher.preempt
        batcher.preempt = lambda n=1: (nudges.append(n), real_preempt(n))
        s = SamplingParams(max_new_tokens=24, ignore_eos=True)
        prompt = "the panel deliberates over every answer"
        ref = eng.generate(prompt, s).token_ids
        low = batcher.submit(prompt, s, priority=PRIORITY_LOW)
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and not any(batcher._slots):
            time.sleep(0.005)
        high = batcher.submit("an urgent question", s, priority=PRIORITY_HIGH)
        g = PressureGovernor(provider_iter=lambda: [prov], up_patience=1, down_patience=1)
        for _ in range(3):
            g.observe(1.0)
        assert g.state == "brownout"
        g._nudge_preempt()
        assert nudges == [1] and g.snapshot()["preempt_nudges"] == 1
        assert high.result(WAIT).token_ids
        resumed = low.result(WAIT)
        assert resumed.token_ids == ref
        assert batcher.pressure_snapshot()["preemptions"] >= 1
        assert prov._brownout_active and batcher._brownout
        assert g.observe(0.0) == "preempt"
        assert not prov._brownout_active and not batcher._brownout
    finally:
        prov.release()


def test_provider_pressure_and_utilization_surfaces():
    prov = _provider(batch_streams=2)
    try:
        s = SamplingParams(max_new_tokens=16, ignore_eos=True)
        from llm_consensus_tpu_torch.providers import Request
        from llm_consensus_tpu_torch.utils.context import Context

        prov.query(Context.background(), Request(model="gpu:tiny-llama", prompt="warm up",
                                                 max_tokens=16))
        assert s.max_new_tokens == 16
        pools = prov.pressure_stats()
        assert pools == {"tiny-llama": {"live": 0, "cap": 2, "queued": 0, "preemptions": 0}}
        first = prov.utilization_stats()
        assert first == {"tiny-llama": {"live_streams": 0}}
        assert prov.utilization_stats() == first  # inside the window: a replay
        prov._util_prev["tiny-llama"] = (time.monotonic() - 5.0,
                                         dict(prov._util_prev["tiny-llama"][1],
                                              decode_tokens=0, decode_s=0.0))
        prov.query(Context.background(), Request(model="gpu:tiny-llama", prompt="again",
                                                 max_tokens=16))
        entry = prov.utilization_stats()["tiny-llama"]
        assert "tokens_per_sec" in entry and "mfu" not in entry  # no card, no peak
        assert torch.device(prov.device).type == "cpu"
    finally:
        prov.release()
