"""The port's crash recovery (llm_consensus_tpu_torch/recovery/) against the
JAX package's (mirrors the journal and supervision cases of
tests/test_recovery.py).

An engine death mid-decode costs a pause, not the in-flight streams: the
supervised ``GPUProvider`` rebuilds the pool once and replays every
journaled stream, and each greedy stream ends with the tokens of the
single-stream engine of both packages (float32 weights carried across by
``params_from_numpy``; the JAX reference test's own setup, bf16 random
weights, is held to the port's single-stream engine). A wedged pool is
abandoned by the watchdog and replayed; a preempted stream that then
crashes replays from its reopened entry.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import recovery as jax_recovery
from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.tokenizer import load_tokenizer
from llm_consensus_tpu_torch.faults import FaultPlan, FaultSpec
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.providers import Request
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.recovery import (
    EngineSupervisor, EngineWedged, StreamJournal, device_error, read_wal)
from llm_consensus_tpu_torch.utils.context import Context

MODEL = "gpu:tiny-llama"
# THREE prompts onto a 2-slot pool: the third stream is still QUEUED when
# the crash lands, so recovery must also read the cancelled queued future
# as pool death (not a benign close) and replay it.
PROMPTS = [
    "crash replay probe one",
    "crash replay probe two — longer body",
    "crash replay probe three, queued behind the pool",
]


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    """Every test starts and ends with no fault plan, integrity plane,
    journal or recorder in either package (they are process-wide)."""
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")
    for mod in (faults, integrity, jax_faults, jax_recovery):
        mod.reset()
    obs.reset()
    yield
    for mod in (faults, integrity, jax_faults, jax_recovery):
        mod.reset()
    obs.reset()


# -- journal units ------------------------------------------------------------------------


def test_journal_entry_lifecycle():
    j = StreamJournal()
    e = j.record([1, 2, 3], SamplingParams(max_new_tokens=8))
    assert j.depth() == 1 and e.open
    e.append(7)
    e.append(8)
    assert e.tokens() == [7, 8]
    e.close("eos")
    assert j.depth() == 0 and not e.open
    assert e.finish == "eos"
    e.close("length")  # idempotent: the first close wins
    assert e.finish == "eos"
    assert j.stats() == {"depth": 0, "opened": 1, "closed": 1}


def test_journal_seal_drops_late_appends():
    j = StreamJournal()
    e = j.record([1], SamplingParams())
    e.append(5)
    assert e.seal() == [5]
    e.append(6)  # a wedged worker waking up late
    assert e.tokens() == [5], "sealed entry accepted a late append"
    replay = j.record(e.prompt_ids, e.sampling, tokens=[5], replay_of=e)
    assert replay.replay_of == e.sid and replay.tokens() == [5]


def test_journal_disk_mirror(tmp_path):
    from llm_consensus_tpu_torch import integrity as port_integrity

    j = StreamJournal(path=str(tmp_path / "wal"))
    e = j.record([1, 2], SamplingParams(max_new_tokens=4))
    e.append(9)
    e.close("length")
    (name,) = os.listdir(tmp_path / "wal")
    assert name == f"{os.getpid()}-0.wal"
    lines = (tmp_path / "wal" / name).read_text().splitlines()
    payloads = [port_integrity.parse_wal_line(ln) for ln in lines]
    assert None not in payloads, lines
    assert json.loads(payloads[0])["prompt_ids"] == [1, 2]
    assert payloads[1] == "9" and payloads[-1] == "#finish=length"
    doc = read_wal(str(tmp_path / "wal" / name))
    assert doc["header"]["prompt_ids"] == [1, 2]
    assert (doc["tokens"], doc["finish"], doc["truncated"]) == ([9], "length", False)


# -- the supervised provider: crash replay, wedge detection, stats ----------------------------


@pytest.fixture(scope="module")
def weights():
    """tiny-llama's float32 weights in both packages (the JAX init's,
    carried across)."""
    jcfg, tcfg = jax_config("tiny-llama"), get_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, torch.device("cpu"),
                           torch.float32)
    return jcfg, jp, tcfg, tp


class _F32Provider(GPUProvider):
    """The provider with its engines on the fixed float32 weights (a
    rebuild gets the same weights, as a seeded or checkpointed build
    does)."""

    params = None

    def _build_engine(self, preset):
        if self._faults is not None:
            self._faults.check("build", preset=preset)
        return Engine(get_config(preset), params=self.params, dtype=torch.float32,
                      max_seq=256, stream_interval=self.stream_interval, device="cpu")


def _provider(weights=None, **kw):
    kw.setdefault("ignore_eos", True)
    kw.setdefault("stream_interval", 4)
    kw.setdefault("batch_streams", 2)
    if weights is None:
        return GPUProvider(device="cpu", max_seq=256, **kw)
    prov = _F32Provider(device="cpu", **kw)
    prov.params = weights[3]
    return prov


def _query_all(prov, prompts, max_tokens=16, collect=None, priorities=None):
    results: list = [None] * len(prompts)
    errors: list = [None] * len(prompts)

    def fire(i):
        cb = None
        if collect is not None:
            collect[i] = []
            cb = collect[i].append
        try:
            results[i] = prov.query_stream(
                Context.background(),
                Request(model=MODEL, prompt=prompts[i], max_tokens=max_tokens,
                        priority=priorities[i] if priorities else None), cb)
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors[i] = exc

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert errors == [None] * len(prompts), errors
    return results


def _check_replay(prov, base, got, streamed, max_tokens=16):
    for i, r in enumerate(got):
        assert r.content == base[i], f"stream {i} diverged"
        assert r.tokens == max_tokens
        # Continuity: the chunks the consumer saw concatenate to exactly
        # the final content, nothing dropped or duplicated at the seam.
        assert "".join(streamed[i]) == r.content
    sup = prov._recovery.stats()
    assert sup["restarts"] == 1, sup  # one rebuild served every waiter
    assert sup["replayed_streams"] >= 1, sup
    assert sup["journal"]["depth"] == 0, "journal entries leaked"
    return sup


def test_crash_replay_equals_both_single_stream_engines(weights):
    """crash@chunk=2 with three streams on two slots, float32: every stream
    ends with the JAX and the port single-stream engines' tokens, the text
    it streamed is continuous, one restart, an empty journal."""
    jcfg, jp, tcfg, tp = weights
    s = SamplingParams(max_new_tokens=16, ignore_eos=True)
    port = Engine(tcfg, params=tp, dtype=torch.float32, max_seq=256, stream_interval=4,
                  device="cpu")
    jeng = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=256, stream_interval=4)
    base = [port.generate(p, s).text for p in PROMPTS]
    assert base == [jeng.generate(p, JaxSampling(max_new_tokens=16, ignore_eos=True)).text
                    for p in PROMPTS]

    faults.install(FaultPlan("crash@chunk=2", seed=7))
    prov = _provider(weights, journal=StreamJournal())
    try:
        streamed: dict = {}
        got = _query_all(prov, PROMPTS, collect=streamed)
        _check_replay(prov, base, got, streamed)
        assert "engine#2[model=tiny-llama]->crash" in faults.plan().trace
        assert sum(ln.startswith("build#") for ln in faults.plan().trace) == 2
    finally:
        prov.release()


def test_crash_replay_of_the_jax_reference_setup():
    """The reference test's own setup (random bf16 weights, crash@chunk=2,
    seed 7, three streams on two slots) held to the port's single-stream
    engine for ALL three streams. The JAX package's run of it fails on
    stream 2's last token, in a fault-free batched run as well: a bf16
    near-tie of its batched decode (ROADMAP.md, queue 3), not a replay
    fault."""
    base_prov = _provider(batch_streams=1)
    base = [r.content for r in _query_all(base_prov, PROMPTS)]
    base_prov.release()
    faults.install(FaultPlan("crash@chunk=2", seed=7))
    prov = _provider(journal=StreamJournal())
    try:
        streamed: dict = {}
        got = _query_all(prov, PROMPTS, collect=streamed)
        _check_replay(prov, base, got, streamed)
    finally:
        prov.release()


def test_crash_replay_mirrors_every_incarnation_to_the_wal(weights, tmp_path):
    """With a journal directory every incarnation of every stream leaves a
    WAL that reads back as its prompt and the tokens it journaled."""
    faults.install(FaultPlan("crash@chunk=2", seed=7))
    prov = _provider(weights, journal=StreamJournal(path=str(tmp_path)))
    try:
        got = _query_all(prov, PROMPTS)
    finally:
        prov.release()
    docs = [read_wal(str(p)) for p in sorted(tmp_path.iterdir())]
    assert len(docs) >= 4 and all(not d["truncated"] for d in docs)
    finishes = sorted(d["finish"] for d in docs)
    assert finishes.count("length") == 3 and "recovered" in finishes
    tok = load_tokenizer(None)  # the engines' byte tokenizer
    for d in docs:
        if d["finish"] == "length":
            prompt = tok.decode(d["header"]["prompt_ids"])
            i = next(i for i, p in enumerate(PROMPTS) if prompt.endswith(p))
            assert tok.decode(d["tokens"]) == got[i].content


def test_wedge_detection_fires_on_stalled_heartbeat(weights):
    base = _provider(weights).query(Context.background(), Request(
        model=MODEL, prompt="wedge probe", max_tokens=12))
    faults.install(FaultPlan("wedge@chunk=2@s=30", seed=7))
    prov = _provider(weights, journal=StreamJournal(), engine_heartbeat_s=2.0)
    try:
        t0 = time.monotonic()
        r = prov.query(Context.background(), Request(model=MODEL, prompt="wedge probe",
                                                     max_tokens=12))
        wall = time.monotonic() - t0
        assert r.content == base.content and r.tokens == 12
        # The watchdog abandoned the wedged pool and the stream replayed long
        # before the 30 s stall would have released it.
        assert wall < 25.0, f"wedge was waited out, not detected ({wall:.1f}s)"
        sup = prov._recovery.stats()
        assert sup["restarts"] >= 1 and sup["replayed_streams"] >= 1, sup
        assert sup["heartbeat_s"] == 2.0
    finally:
        prov.release()


def test_preempted_then_crashed_stream_replays_from_its_reopened_entry(weights):
    """A LOW stream preempted by a HIGH one has its entry sealed and a
    replay-seeded one opened; a pool crash after its resume replays the
    whole stream from that entry (single-stream tokens)."""
    from llm_consensus_tpu_torch.pressure import PRIORITY_HIGH, PRIORITY_LOW

    class ArmedCrash(FaultPlan):
        """No spec: ``crash`` fires at the first engine-site dispatch after
        the test arms it."""

        def __init__(self):
            super().__init__("")
            self.armed = threading.Event()
            self.fired = False

        def fire(self, site, **attrs):
            hit = super().fire(site, **attrs)
            if site == "engine" and self.armed.is_set() and not self.fired:
                self.fired = True
                return FaultSpec("crash")
            return hit

    plan = ArmedCrash()
    faults.install(plan)
    prov = _provider(weights, journal=StreamJournal(), stream_interval=2)
    lows = ["low priority resident one", "low priority resident two"]
    high = "the high priority latecomer"
    single = _provider(weights, batch_streams=1)
    want = {p: single.query(Context.background(), Request(model=MODEL, prompt=p,
                                                          max_tokens=n)).content
            for p, n in ((lows[0], 96), (lows[1], 96), (high, 16))}
    single.release()
    results: dict = {}

    def fire(p, n, pri):
        results[p] = prov.query(Context.background(),
                                Request(model=MODEL, prompt=p, max_tokens=n, priority=pri))

    try:
        threads = [threading.Thread(target=fire, args=(p, 96, PRIORITY_LOW)) for p in lows]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while True:
            b = prov._batchers.get("tiny-llama")
            slots = list(b._slots) if b is not None else []
            if sum(1 for st in slots if st is not None and len(st.out_ids) >= 8) == 2:
                break
            assert time.monotonic() < deadline, "residents never decoded"
            time.sleep(0.002)
        threads.append(threading.Thread(target=fire, args=(high, 16, PRIORITY_HIGH)))
        threads[-1].start()
        while not any(st is not None and st.preempted and len(st.out_ids) > 8
                      for st in list(b._slots)):
            assert time.monotonic() < deadline, f"no resumed victim: {b.snapshot()}"
            time.sleep(0.002)
        plan.armed.set()
        for t in threads:
            t.join(timeout=300)
    finally:
        prov.release()
    assert plan.fired and b.snapshot()["preemptions"] >= 1
    assert {p: r.content for p, r in results.items()} == want
    sup = prov._recovery.stats()
    assert sup["restarts"] == 1 and sup["journal"]["depth"] == 0, sup


def test_recovery_stats_shape_without_supervision(weights):
    prov = _provider(weights)
    try:
        prov.query(Context.background(), Request(model=MODEL, prompt="stats probe",
                                                 max_tokens=4))
        stats = prov.recovery_stats()
    finally:
        prov.release()
    assert list(stats) == ["state", "restarts", "replayed_streams", "journal_depth",
                           "heartbeats", "decode_heartbeat_age_s"]
    assert stats["state"] == "ok" and stats["restarts"] == stats["replayed_streams"] == 0
    assert stats["heartbeats"]["tiny-llama"]["age_s"] >= 0.0
    assert stats["heartbeats"]["tiny-llama"]["busy"] is False


def test_recovery_stats_shape_with_supervision_is_the_jax_providers(weights):
    from llm_consensus_tpu.providers import Request as JaxRequest
    from llm_consensus_tpu.providers.tpu import TPUProvider
    from llm_consensus_tpu.utils.context import Context as JaxContext

    jax_recovery.install(jax_recovery.StreamJournal())
    jprov = TPUProvider(ignore_eos=True, stream_interval=4, batch_streams=2)
    prov = _provider(weights, journal=StreamJournal(), engine_heartbeat_s=5.0)
    try:
        prov.query(Context.background(), Request(model=MODEL, prompt="stats", max_tokens=4))
        jprov.query(JaxContext.background(), JaxRequest(model="tpu:tiny-llama", prompt="stats",
                                                        max_tokens=4))
        ours, theirs = prov.recovery_stats(), jprov.recovery_stats()
    finally:
        prov.release()
        jprov.release()
    assert list(ours) == list(theirs)
    assert list(ours["heartbeats"]["tiny-llama"]) == list(theirs["heartbeats"]["tiny-llama"])
    assert (ours["journal_depth"], ours["restarts"], ours["heartbeat_s"]) == (0, 0, 5.0)


def test_device_errors_are_not_replayed():
    """A kernel build or launch failure and a CUDA runtime error fail the
    stream at once; an out-of-memory error is a pool death to replay."""
    from llm_consensus_tpu_torch.ops.kernels.build import KernelBuildError, KernelLaunchError

    assert device_error(KernelBuildError("nvcc failed"))
    assert device_error(KernelLaunchError("launch failed"))
    assert device_error(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not device_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not device_error(RuntimeError("injected engine crash"))
    assert not device_error(None)

    class DeadPool:
        failed_exc = RuntimeError("CUDA error: an illegal memory access was encountered")

    sup = EngineSupervisor(_provider(), StreamJournal())
    assert not sup._recoverable(DeadPool(), DeadPool.failed_exc)
    DeadPool.failed_exc = RuntimeError("injected engine crash")
    assert sup._recoverable(DeadPool(), DeadPool.failed_exc)
    assert sup._recoverable(object(), EngineWedged("stale"))


def test_device_error_fails_the_stream_without_a_rebuild(weights, monkeypatch):
    """A pool that dies of a CUDA error is not rebuilt: every stream fails
    with that error, and the journal closes its entries."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    real = ContinuousBatcher._dispatch

    def dying(self, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ContinuousBatcher, "_dispatch", dying)
    prov = _provider(weights, journal=StreamJournal())
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            prov.query(Context.background(), Request(model=MODEL, prompt="doomed",
                                                     max_tokens=8))
        assert prov._recovery.stats()["restarts"] == 0
        assert prov._recovery.stats()["journal"]["depth"] == 0
    finally:
        monkeypatch.setattr(ContinuousBatcher, "_dispatch", real)
        prov.release()
