"""The port's telemetry planes alone (llm_consensus_tpu_torch/obs/), held to
the JAX package's planes on the same inputs: the recorder, the Chrome
export, the live histograms, the attribution ledger, the roofline ledger
and its dispatch-mode counting, the flight recorder and the profiler
window."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import obs as jobs
from llm_consensus_tpu.obs import attrib as jattrib
from llm_consensus_tpu.obs import export as jexport
from llm_consensus_tpu.obs import live as jlive
from llm_consensus_tpu.obs import roofline as jroofline
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine import engine as engine_mod
from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import forward, init_kv_cache, init_params
from llm_consensus_tpu_torch.obs import attrib, blackbox, export, live, profiler, roofline
from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa


@pytest.fixture(autouse=True)
def _no_planes():
    """Every test starts and ends with no plane installed, in both packages."""
    obs.reset_planes()
    for m in (jobs, jattrib, jlive, jroofline, jobs.blackbox):
        m.reset()
    yield
    obs.reset_planes()
    for m in (jobs, jattrib, jlive, jroofline, jobs.blackbox):
        m.reset()


# -- recorder ------------------------------------------------------------------------


def test_recorder_concurrent_writers_lose_nothing():
    rec = obs.Recorder()
    n_threads, n_events = 8, 200

    def writer(t):
        for i in range(n_events):
            rec.complete(f"span-{t}", rec.now(), tid=f"w{t}", i=i)
            rec.count("total")

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    events = rec.events()
    assert len(events) == n_threads * n_events
    assert rec.counters()["total"] == n_threads * n_events
    for t in range(n_threads):
        assert [e.args["i"] for e in events if e.tid == f"w{t}"] == list(range(n_events))
    assert rec.dropped == 0


def test_recorder_bounds_memory_and_counts_drops_like_jax():
    ours, ref = obs.Recorder(max_events=10), jobs.Recorder(max_events=10)
    for rec in (ours, ref):
        for i in range(25):
            rec.instant("e", tid="t", i=i)
    assert len(ours.events()) == len(ref.events()) == 11  # + one events_dropped instant
    assert [e.name for e in ours.events()] == [e.name for e in ref.events()]
    assert ours.dropped == ref.dropped == 15
    assert ours.counters() == ref.counters() == {"obs.dropped_events": 15.0}
    ours.clear()
    ours.instant("e", tid="t")
    assert ours.dropped == 0 and len(ours.events()) == 1


def test_span_records_on_exception():
    rec = obs.Recorder()
    with pytest.raises(ValueError):
        with rec.span("doomed", tid="t"):
            raise ValueError("boom")
    assert rec.span_names() == {"doomed"}


# -- Chrome export ---------------------------------------------------------------------


def _events(cls):
    return [
        cls(name="prefill", ph="X", ts_ns=1_000_000, tid="engine", dur_ns=2_500_000,
            args={"tokens": 7}),
        cls(name="decode", ph="X", ts_ns=4_000_000, tid="batcher", dur_ns=1_000),
        cls(name="watchdog_abandon", ph="i", ts_ns=5_000_000, tid="runner",
            args={"model": "m"}),
        cls(name="fetch", ph="X", ts_ns=3_999_000, tid="engine", dur_ns=10),
    ]


def test_chrome_export_matches_the_jax_golden():
    ours = export.chrome_events(_events(obs.Event), pid=3)
    ref = jexport.chrome_events(_events(jobs.Event), pid=3)
    assert ours == ref
    doc = json.loads(json.dumps(export.trace_document(ours)))
    assert doc == jexport.trace_document(ref)
    assert export.trace_span_names(doc) == {"prefill", "decode", "fetch"}
    assert min(e["ts"] for e in ours if e["ph"] != "M") == 0.0


def test_load_trace_reads_back_a_local_trace_like_jax(tmp_path):
    """``load_trace``: a trace ``local_trace`` wrote (through
    ``save_run_telemetry``) reads back equal, as the JAX reader reads it; a
    file that is not a trace document raises the same ``ValueError``."""
    rec = obs.Recorder()
    rec.complete("decode", rec.now(), tid="engine", steps=16)
    rec.complete("fetch", rec.now(), tid="engine", tokens=16)
    doc = export.local_trace(rec)
    export.save_run_telemetry(str(tmp_path), doc, {"models": {}})
    path = str(tmp_path / export.TRACE_FILE)
    got = export.load_trace(path)
    assert got == json.loads(json.dumps(doc)) == jexport.load_trace(path)
    assert export.trace_span_names(got) == {"decode", "fetch"}
    for name, body in (("metrics.json", None), ("list.json", "[1, 2]"),
                       ("events.json", '{"traceEvents": {}}')):
        bad = tmp_path / name
        if body is not None:
            bad.write_text(body)
        for reader in (export.load_trace, jexport.load_trace):
            with pytest.raises(ValueError, match=f"{name} is not a trace document"):
                reader(str(bad))


def test_local_trace_carries_the_roofline_counter_tracks():
    rec = obs.Recorder()
    rec.complete("decode", rec.now(), tid="engine")
    led = roofline.RooflineLedger(ridge=32.0)
    roofline.install(led)
    with led.dispatch("decode", ("k",), tokens=4):
        torch.ones(8, 8) @ torch.ones(8, 8)
    doc = export.local_trace(rec)
    counters = {e["name"]: e["args"]["value"] for e in doc["traceEvents"] if e["ph"] == "C"}
    assert set(counters) == {"roofline_flops/decode", "roofline_bytes/decode"}
    assert counters["roofline_flops/decode"] == 1024.0


def _spans(cls):
    return [
        cls(name="decode", ph="X", ts_ns=0, tid="batcher", dur_ns=int(0.5e9)),
        cls(name="fetch", ph="X", ts_ns=int(0.5e9), tid="batcher", dur_ns=int(0.5e9)),
        cls(name="decode", ph="X", ts_ns=int(0.2e9), tid="batcher", dur_ns=int(0.3e9)),
    ]


def test_aggregate_throughput_uses_the_union_window_like_jax():
    for mfu in (False, True):
        got = []
        for mod, ev in ((obs, export), (jobs, jexport)):
            rec = mod.Recorder()
            for e in _spans(mod.Event):
                rec._append(e)
            rec.count("decode_tokens", 100)
            rec.count("decode_s", 3.0)  # summed walls: must NOT be the divisor
            if mfu:
                rec.count("mfu_weighted_tokens", 0.4 * 60)
                rec.count("mfu_tokens", 60)
            got.append(ev.aggregate_throughput(rec))
        assert got[0] == got[1]
        assert got[0]["window_s"] == pytest.approx(1.0)
        assert got[0]["tokens_per_sec"] == pytest.approx(100.0)
        assert got[0].get("mfu") == (pytest.approx(0.4) if mfu else None)


def test_metrics_summary_has_the_jax_keys():
    ours, ref = obs.Recorder(), jobs.Recorder()
    for rec in (ours, ref):
        rec.complete("decode", rec.now(), tid="engine")
        rec.count("decode_tokens", 8)
        rec.count("decode_s", 0.5)
    kw = dict(failed_models=["x"], warnings=["w"], live={"a": []}, attrib={"b": 1},
              roofline={"c": 2}, batcher_stats={"p": {}})
    a = export.metrics_summary(ours, **kw)
    b = jexport.metrics_summary(ref, **kw)
    assert list(a) == list(b)
    assert a["counters"] == b["counters"] and a["events"] == b["events"]


# -- live histograms ---------------------------------------------------------------------


def test_bucket_ladder_equals_jax():
    assert live.BUCKET_EDGES == jlive.BUCKET_EDGES
    for v in (0.0, 1e-4, 1.0001e-4, 0.0512, 1e9):
        assert live.bucket_index(v) == jlive.bucket_index(v)
    assert [live.class_label(p) for p in (0, 1, 2, 7, None)] == [
        jlive.class_label(p) for p in (0, 1, 2, 7, None)]


def test_histogram_quantiles_and_rotation_equal_jax():
    rng = np.random.default_rng(0)
    ours = live.LiveMetrics(window_s=60.0, windows=3)
    ref = jlive.LiveMetrics(window_s=60.0, windows=3)
    for window in range(5):
        for v, cls in zip(rng.lognormal(-4.0, 1.5, size=200), rng.integers(0, 3, size=200)):
            labels = {"class": live.class_label(int(cls)), "outcome": "ok"}
            ours.observe("token_latency", float(v), **labels)
            ref.observe("token_latency", float(v), **labels)
        ours.rotate()
        ref.rotate()
    assert ours.counts() == ref.counts() == 1000
    fams, ref_fams = ours.families(), ref.families()
    assert sorted(str(lab) for lab, _ in fams["token_latency"]) == sorted(
        str(lab) for lab, _ in ref_fams["token_latency"])
    for q in (0.5, 0.9, 0.99):
        for windows in (1, 2, 3):
            for filt in ({}, {"class": "high"}):
                assert ours.quantile_recent("token_latency", q, windows, **filt) == \
                    ref.quantile_recent("token_latency", q, windows, **filt)
    assert export.live_summary(ours) == jexport.live_summary(ref)


# -- attribution ledger --------------------------------------------------------------------


def _drive_ledger(led):
    led.observe_device("decode", 0.5)
    led.observe_device("decode", 0.25)
    led.observe_device("prefill", 1.0)
    led.token_event("useful", 10)
    led.token_event("overshoot", 3)
    led.token_event("useful", 5)
    led.token_event("spec_rejected", 0)
    led.gap(0.1, "admit")
    led.gap(0.2, "admit")
    led.gap(-1.0, "compact")
    led.update_component("weights:m", 1000)
    led.update_component("pool_cache:m", 500)
    led.update_component("pool_cache:m", 200)


def test_goodput_and_gap_books_equal_jax():
    ours = attrib.ChipTimeLedger(warmup_s=3600.0, hbm_high=0.92)
    ref = jattrib.ChipTimeLedger(warmup_s=3600.0, hbm_high=0.92)
    _drive_ledger(ours)
    _drive_ledger(ref)
    a, b = ours.snapshot(), ref.snapshot()
    assert a == b
    assert list(a) == list(b)
    assert a["goodput"] == {"useful": 15, "wasted": 3, "fraction": 0.8333}
    assert a["gap_s"] == {"admit": 0.3} and a["gaps"] == 2
    assert a["hbm"]["peak_modeled_bytes"] == 1500 and "device" not in a["hbm"]
    assert ours.activity() == ref.activity()


def test_family_tag_nests_and_restores():
    assert attrib.current_family() is None
    with attrib.tag("decode"):
        with attrib.tag("prefill"):
            assert attrib.current_family() == "prefill"
        assert attrib.current_family() == "decode"
    assert attrib.current_family() is None


def test_ledger_feeds_the_live_histograms():
    lm = live.LiveMetrics(window_s=60.0)
    live.install(lm)
    led = attrib.ChipTimeLedger(warmup_s=3600.0)
    led.observe_device("decode", 0.01)
    led.gap(0.005, "admit")
    fams = lm.families()
    assert set(fams) == {"device_time", "host_gap"}
    assert fams["device_time"][0][0] == {"family": "decode"}


def test_build_sentinel_books_builds_and_fires_after_warmup(tmp_path):
    rec = obs.Recorder()
    obs.install(rec)
    ring = blackbox.FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0)
    blackbox.install(ring)
    cold = attrib.ChipTimeLedger(warmup_s=3600.0)
    with attrib.tag("prefill"):
        cold.note_build(1.5)
    snap = cold.snapshot()
    assert snap["compiles"] == {"prefill": 1} and snap["compile_s"] == {"prefill": 1.5}
    assert snap["retraces"] == 0 and rec.events() == []
    warm = attrib.ChipTimeLedger(warmup_s=3600.0)
    warm.mark_warm()
    warm.note_build(0.25)  # untagged: "other"
    assert warm.snapshot()["compiles"] == {"other": 1} and warm.snapshot()["retraces"] == 1
    assert [e.name for e in rec.events()] == ["retrace"]
    assert rec.counters() == {"attrib.retraces": 1.0}
    (dump,) = os.listdir(tmp_path)
    doc = json.loads((tmp_path / dump).read_text())
    assert doc["blackbox"]["reason"] == "retrace" and doc["blackbox"]["family"] == "other"


def test_kernel_build_is_booked_once_under_the_ambient_family(monkeypatch):
    from llm_consensus_tpu_torch.ops.kernels import build

    fake = object()
    loads = []

    def load():
        loads.append(1)
        monkeypatch.setattr(build, "_lib", fake)
        return fake, True

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load", load)
    led = attrib.ChipTimeLedger(warmup_s=3600.0)
    attrib.install(led)
    with attrib.tag("decode"):
        assert build.ensure_built() is fake
        assert build.ensure_built() is fake
    assert loads == [1]
    assert led.snapshot()["compiles"] == {"decode": 1}


def test_device_memory_stats_are_none_on_the_cpu():
    assert attrib.ChipTimeLedger(warmup_s=3600.0).hbm_device_stats() is None


# -- roofline ledger ------------------------------------------------------------------


def _jax_matmul():
    @jax.jit
    def f(x):
        return x @ x

    return f, jnp.ones((8, 8), jnp.float32)


_A, _B = torch.ones(8, 8), torch.ones(8, 8)


def _dispatch(led, family="decode", key=("k",), tokens=0, steps=1):
    cap = led.dispatch(family, key, tokens=tokens, steps=steps)
    if cap is not None:
        with cap:
            _A @ _B


def test_dispatch_counts_once_then_bumps_like_jax():
    ours = roofline.RooflineLedger(ridge=32.0)
    ref = jroofline.RooflineLedger(ridge=32.0)
    f, x = _jax_matmul()
    for _ in range(3):
        _dispatch(ours, tokens=4)
        ref.dispatch("decode", ("k",), f, (x,), {}, tokens=4)
    a = ours.snapshot(device_s={"decode": 0.5})["families"]["decode"]
    b = ref.snapshot(device_s={"decode": 0.5})["families"]["decode"]
    for k in ("programs", "dispatches", "tokens", "flops", "wall_s", "achieved_flops_per_s"):
        assert a[k] == b[k], k
    assert a["source"] == "dispatch" and b["source"] == "xla"
    # Two 8x8 fp32 inputs and one output, once per dispatch.
    assert a["bytes"] == pytest.approx(3 * 3 * 256)
    assert ours.captures == 1


def test_steps_ridge_verdicts_and_coverage_like_jax():
    f, x = _jax_matmul()
    for ridge in (1e-6, 1e9):
        ours = roofline.RooflineLedger(ridge=ridge)
        ref = jroofline.RooflineLedger(ridge=ridge)
        _dispatch(ours, steps=5)
        ref.dispatch("decode", ("k",), f, (x,), {}, steps=5)
        walls = {"decode": 1.0, "allgather": 1.0}
        a, b = ours.snapshot(device_s=walls), ref.snapshot(device_s=walls)
        assert a["families"]["decode"]["flops"] == b["families"]["decode"]["flops"] == 5 * 1024
        assert a["families"]["decode"]["verdict"] == b["families"]["decode"]["verdict"] == (
            "compute_bound" if ridge < 1 else "memory_bound")
        assert a["coverage"] == b["coverage"] == {
            "covered_wall_s": 1.0, "attrib_wall_s": 2.0, "fraction": 0.5}
        assert (a["ridge_flops_per_byte"], a["ridge_source"]) == (
            b["ridge_flops_per_byte"], b["ridge_source"])
    default = roofline.RooflineLedger()
    assert default.ridge() == (32.0, "default") == jroofline.RooflineLedger(ridge=0.0).ridge()


@pytest.mark.parametrize("modeled", [256.0, 25600.0, 2.0])
def test_crosscheck_ratio_and_ok_equal_jax(modeled):
    ours = roofline.RooflineLedger(ridge=32.0, tol=4.0)
    ref = jroofline.RooflineLedger(ridge=32.0, tol=4.0)
    f, x = _jax_matmul()
    _dispatch(ours, tokens=4)
    ref.dispatch("decode", ("k",), f, (x,), {}, tokens=4)
    ours.note_modeled("decode", modeled, 1000.0)
    ref.note_modeled("decode", modeled, 1000.0)
    a = ours.snapshot(device_s={})["crosscheck"]["decode"]
    b = ref.snapshot(device_s={})["crosscheck"]["decode"]
    for k in ("flops_per_token_xla", "flops_per_token_modeled", "ratio", "ok",
              "bytes_per_token_modeled"):
        assert a[k] == b[k], k
    assert a["ok"] is (modeled == 256.0)


def test_concurrent_first_dispatches_count_once():
    led = roofline.RooflineLedger(ridge=32.0)
    gate = threading.Event()
    caps = []

    def first():
        cap = led.dispatch("decode", ("k",), tokens=1)
        caps.append(cap)
        with cap:
            gate.wait(30)
            torch.ones(8, 8) @ torch.ones(8, 8)

    t = threading.Thread(target=first)
    t.start()
    while not caps:
        pass
    for _ in range(4):  # land while the capture is in flight: deferred
        assert led.dispatch("decode", ("k",), tokens=1) is None
    gate.set()
    t.join(timeout=30)
    assert not t.is_alive()
    fam = led.snapshot(device_s={})["families"]["decode"]
    assert (fam["programs"], fam["dispatches"], fam["tokens"], fam["flops"]) == (1, 5, 5, 5 * 1024)


def test_work_counter_conventions():
    """Views move nothing; a gather counts indices and twice its output;
    an in-place copy counts its source twice, not the tensor it writes
    into; composite ops count as their pieces."""
    big = torch.zeros(1000, 64)
    idx = torch.tensor([3, 5])
    with roofline.WorkCounter() as m:
        big[10:20].t()
    assert (m.flops, m.bytes) == (0.0, 0.0)
    with roofline.WorkCounter() as m:
        big[idx]
    assert m.bytes == 16 + 2 * 2 * 64 * 4
    with roofline.WorkCounter() as m:
        big[0:2].copy_(torch.ones(2, 64))
    assert m.bytes == 2 * 2 * 64 * 4 + 2 * 64 * 4  # ones() written, then the copy
    with torch.inference_mode(), roofline.WorkCounter() as m:
        torch.ones(3, 4, 8) @ torch.ones(8, 5)
    assert m.flops == 2 * 12 * 8 * 5


@pytest.mark.parametrize("op,operands,out_dtype", [
    (torch.ops.aten.mm.dtype, ((6, 8), (8, 5)), True),
    (torch.ops.aten.bmm.dtype, ((3, 6, 8), (3, 8, 5)), True),
    (torch.ops.aten.mm.default, ((6, 8), (8, 5)), False),
])
def test_matrix_products_count_with_an_out_dtype(op, operands, out_dtype):
    """The ``.dtype`` overloads (bf16 in, fp32 out: the unembed and the
    int4 nibble dot on the card) count like the plain products."""
    a, b = (torch.ones(s, dtype=torch.bfloat16) for s in operands)
    out = torch.ones(*operands[0][:-1], operands[1][-1])
    m = roofline.WorkCounter()
    m._count(op, (a, b, torch.float32) if out_dtype else (a, b), {}, out)
    assert m.flops == 2.0 * out.numel() * a.shape[-1]


def test_kernel_wrappers_book_their_own_work_not_the_plain_version():
    """Under a capture the flash and decode wrappers add the counts
    chip_smoke.py bounds with (valid slots only), and their plain versions,
    the CPU path, are not counted again."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 32, generator=g)
    k = torch.randn(1, 16, 2, 32, generator=g)
    led = roofline.RooflineLedger()
    with led.dispatch("prefill", ("f",), tokens=16):
        fa.flash_attention(q, k, k)
    pairs = 16 * 17 // 2
    fam = led.snapshot(device_s={})["families"]["prefill"]
    assert fam["flops"] == 4.0 * 4 * 32 * pairs
    assert fam["bytes"] == 4 * (2 * 16 * 4 * 32 + 2 * 16 * 2 * 32)

    cache = torch.randn(2, 3, 64, 2, 32, generator=g)  # [L, B, S, Hkv, dh]
    qd = torch.randn(3, 1, 4, 32, generator=g)
    pos, layer = torch.tensor(20, dtype=torch.int32), torch.tensor(1, dtype=torch.int32)
    rs = torch.tensor([0, 5, 21], dtype=torch.int32)
    cap = led.dispatch("decode", ("d",), tokens=3, kv_valid=21 + 16 + 0)
    with cap:
        da.decode_attention(qd, cache, cache, pos, layer, rs, kv_width=64)
    dec = led.snapshot(device_s={})["families"]["decode"]
    assert dec["flops"] == 4.0 * 4 * 32 * 37
    assert dec["bytes"] == 37 * 2 * 2 * 32 * 4 + 2 * 4 * 3 * 4 * 32
    assert roofline.CAPTURING == 0 and roofline.current_capture() is None


def _step(case, cfg, quant):
    """One forward of ``case`` over a fresh cache, as ``run(layer_scope)``."""
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32, quant=quant)
    rows = 2 if case == "decode" else 1
    cache = init_kv_cache(cfg, batch=rows, max_seq=64, device="cpu", dtype=torch.float32,
                          quant=quant)
    if case == "prefill":  # one shot from 0: the flash wrapper
        toks, start, kw = torch.arange(1, 17)[None], 0, {"attn_impl": "flash"}
    elif case == "chunk":  # a chunk at a running start: the plain op
        toks, start, kw = torch.arange(1, 9)[None], 8, {"attn_impl": "torch", "kv_width": 32}
    else:  # two right-aligned rows: the decode wrapper
        toks, start = torch.tensor([[3], [4]]), torch.tensor(20, dtype=torch.int32)
        kw = {"attn_impl": "flash", "kv_width": 32,
              "row_start": torch.tensor([0, 5], dtype=torch.int32)}
    return lambda scope: forward(params, cfg, toks, cache, start, layer_scope=scope, **kw)


@pytest.mark.parametrize("preset,quant,case", [
    ("tiny-llama", None, "prefill"), ("tiny-llama", None, "chunk"),
    ("tiny-llama", None, "decode"), ("tiny-qwen2", "int8", "prefill"),
    ("tiny-mixtral", "int8", "decode"), ("tiny-gemma", None, "chunk"),
])
def test_capture_counts_the_first_layer_for_every_layer(preset, quant, case):
    """A capture that counts the first layer and books it once per layer
    reads exactly what counting every layer reads, the kernel wrappers'
    own work included."""
    cfg = get_config(preset, n_layers=3)
    run = _step(case, cfg, quant)
    counts = []
    for layered in (False, True):
        led = roofline.RooflineLedger()
        cap = led.dispatch("f", ("k",), tokens=1, kv_valid=21 + 16 if case == "decode" else None)
        with torch.inference_mode(), cap:
            run(cap.layer if layered else None)
        rec = led._programs["f", ("k",)]
        counts.append((rec["raw_flops"], rec["raw_bytes"], rec["raw_out_bytes"], cap.n_layers))
    full, layered = counts
    assert full[3] == 0 and layered[3] == 3
    assert full[0] > 0 and full[1] > 0
    assert layered[:3] == pytest.approx(full[:3], rel=1e-12)
    assert roofline.CAPTURING == 0 and roofline.current_capture() is None


# -- flight recorder and profiler ----------------------------------------------------------


def test_flight_recorder_bounds_dumps_and_rate_limits(tmp_path):
    ring = blackbox.FlightRecorder(capacity=16, out_dir=str(tmp_path), min_interval_s=3600.0)
    assert ring.dump("empty") is None  # nothing captured
    for i in range(40):
        ring.complete("decode", ring.now(), tid="batcher", i=i)
    assert ring.depth() == 16
    path = ring.dump("engine_crash", extra={"error": "boom"})
    assert path is not None and ring.dump("engine_crash") is None
    st = ring.stats()
    assert (st["dumps"], st["suppressed"], st["last_reason"]) == (1, 1, "engine_crash")
    doc = json.loads(open(path).read())
    assert doc["blackbox"]["events"] == 16 and doc["blackbox"]["error"] == "boom"
    assert export.trace_span_names(doc) == {"decode"}


def test_profiler_single_flight_rate_limit_and_atomic_dir(tmp_path):
    prof = profiler.DeepProfiler(out_dir=str(tmp_path), max_s=5.0, min_interval_s=3600.0)
    path, status = prof.arm(tag="t e/st")
    assert status == "armed" and not os.path.exists(path)
    assert prof.arm() == (None, "busy")
    torch.ones(4, 4) @ torch.ones(4, 4)
    assert prof.stop_if_expired() is None  # inside its bound
    assert prof.stop_now() == path
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no .partial left
    doc = json.loads(open(os.path.join(path, profiler.TRACE_FILE)).read())
    assert any(e.get("name") == "aten::mm" for e in doc["traceEvents"])
    assert prof.arm() == (None, "rate_limited")
    assert prof.stats()["windows"] == 1 and prof.stats()["suppressed"] == 2


def test_trace_window_writes_a_complete_trace(tmp_path):
    out = tmp_path / "trace"
    with profiler.trace_window(str(out)):
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert os.listdir(out) == [profiler.TRACE_FILE]
    assert json.loads((out / profiler.TRACE_FILE).read_text())["traceEvents"]


# -- consumers: planes bound at construction ---------------------------------------------------


def _engine():
    return Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=128, device="cpu",
                  stream_interval=4)


def _install_all():
    rec = obs.Recorder()
    obs.install(rec)
    led = attrib.ChipTimeLedger(warmup_s=3600.0)
    attrib.install(led)
    rl = roofline.RooflineLedger()
    roofline.install(rl)
    live.install(live.LiveMetrics())
    blackbox.install(blackbox.FlightRecorder())
    return rec, led, rl


def test_engine_hot_loops_consult_only_the_bound_none():
    """An engine built with every plane off binds None once; planes
    installed afterwards see nothing from its loops."""
    engine = _engine()
    assert (engine._obs, engine._attrib, engine._roofline) == (None, None, None)
    rec, led, rl = _install_all()
    out = engine.generate("quiet run", SamplingParams(max_new_tokens=12, ignore_eos=True))
    assert len(out.token_ids) == 12
    assert rec.events() == [] and rec.counters() == {}
    assert led.activity() == 0 and rl.activity() == 0


def test_batcher_binds_the_planes_at_construction():
    batcher = ContinuousBatcher(_engine(), max_batch=2)
    try:
        assert (batcher._obs, batcher._attrib, batcher._bb) == (None, None, None)
        rec, led, rl = _install_all()
        fut = batcher.submit("quiet pool", SamplingParams(max_new_tokens=8, ignore_eos=True))
        assert len(fut.result(timeout=120).token_ids) == 8
        assert rec.events() == [] and led.activity() == 0 and rl.activity() == 0
    finally:
        batcher.close()


def test_engine_attribution_reconciles_with_its_output():
    rec, led, rl = _install_all()
    engine = _engine()
    out = engine.generate("loud run", SamplingParams(max_new_tokens=12, ignore_eos=True))
    assert {"prefill", "decode", "fetch"} <= rec.span_names()
    snap = led.snapshot()
    n_chunks = sum(1 for e in rec.events() if e.name == "decode")
    assert snap["dispatches"] == {"decode": n_chunks, "prefill": 1}
    assert snap["tokens"] == {"useful": len(out.token_ids)}
    assert snap["hbm"]["components"] == {"weights:tiny-llama": snap["hbm"]["modeled_bytes"]}
    fams = rl.snapshot()["families"]
    assert fams["decode"]["tokens"] == 4 * n_chunks and fams["prefill"]["tokens"] == 16
    assert fams["decode"]["dispatches"] == n_chunks and fams["decode"]["programs"] >= 1


def test_captured_dispatch_books_no_more_than_an_uncaptured_one(monkeypatch):
    """A capture's own host time stays out of its dispatch's interval: with
    every counted op made to take a second more on the engine's and the
    capture's clock, the first generate (every key captured) books no more
    device time than the second (no capture) beyond the host's own noise."""
    _, led, rl = _install_all()
    skew = [0.0]

    class Clock:  # the real clocks, pushed on by the slowed counting
        monotonic = staticmethod(lambda: time.monotonic() + skew[0])
        perf_counter = staticmethod(lambda: time.perf_counter() + skew[0])

    count = roofline.WorkCounter._count

    def slow(self, *args):
        skew[0] += 1.0
        count(self, *args)

    monkeypatch.setattr(roofline, "time", Clock)
    monkeypatch.setattr(engine_mod, "time", Clock)
    monkeypatch.setattr(roofline.WorkCounter, "_count", slow)
    engine = _engine()
    sp = SamplingParams(max_new_tokens=12, ignore_eos=True)
    booked, captures = [], []
    for _ in range(2):
        before = led.snapshot()["device_s"]
        engine.generate("the same prompt twice", sp)
        after = led.snapshot()["device_s"]
        booked.append({f: after[f] - before.get(f, 0.0) for f in after})
        captures.append(rl.captures)
    assert captures[0] >= 2 and captures[1] == captures[0]  # keys counted once
    assert rl.capture_s > 20 * captures[0]  # each capture took 20+ clock seconds
    for fam in ("prefill", "decode"):
        assert booked[0][fam] <= booked[1][fam] + 5.0, (fam, booked)


def test_batcher_attribution_and_goodput_reconcile():
    rec, led, rl = _install_all()
    batcher = ContinuousBatcher(_engine(), max_batch=2)
    try:
        futs = [batcher.submit(p, SamplingParams(max_new_tokens=9, ignore_eos=True))
                for p in ("first prompt", "second one")]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    snap = led.snapshot()
    assert snap["tokens"]["useful"] == sum(len(o.token_ids) for o in outs)
    assert set(snap["tokens"]) <= {"useful", "overshoot"}
    assert snap["dispatches"]["prefill"] >= 1 and snap["dispatches"]["decode"] >= 2
    assert any(k.startswith("pool_cache:") for k in snap["hbm"]["components"])
    assert {"admit", "decode", "fetch"} <= rec.span_names()
    # Every decode step of every row; each stream's first token is the
    # prefill's.
    decoded = sum(len(o.token_ids) - 1 for o in outs)
    assert rl.snapshot()["families"]["decode"]["tokens"] >= decoded
