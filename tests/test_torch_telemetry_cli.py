"""Run telemetry through both CLIs end to end on the CPU: the port's
``metrics.json`` and ``trace.json`` against the JAX CLI's own, for a plain
saved run, an ``--events`` run, and a batched ``--events`` run; the
flags' messages; ``--trace`` and ``--profile`` artifacts."""

import gc
import io
import json
import os
from collections import Counter

import pytest

from llm_consensus_tpu import obs as jobs
from llm_consensus_tpu.obs import attrib as jattrib
from llm_consensus_tpu.obs import live as jlive
from llm_consensus_tpu.obs import roofline as jroofline
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.cli.main import main
from llm_consensus_tpu_torch.providers.gpu import GPUProvider

QUESTION = "what is consensus?"
MAX_TOKENS = "4"
# The port's decode FLOPs per token against the JAX package's XLA count on
# the same run. XLA's cost analysis cannot see inside the Pallas decode
# kernel (a custom call), so the JAX count is the matrix products and
# elementwise work alone; the port's is held to it less the decode
# kernel's own work, which the port's wrapper books (obs/roofline.py).
DECODE_FLOPS_TOL = 0.25


def _reset_port():
    for provider in GPUProvider._shared.values():
        provider.release()
    GPUProvider._shared.clear()
    obs.reset_planes()


def _reset_jax():
    for m in (jobs, jattrib, jlive, jroofline, jobs.blackbox):
        m.reset()


def _port(argv):
    stdout, stderr = io.StringIO(), io.StringIO()
    rc = main(argv, device="cpu", stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
              install_signal_handlers=False)
    return rc, stdout.getvalue(), stderr.getvalue()


def _jax(argv, fresh=True):
    """The JAX CLI in this process; ``fresh``: a new shared TPU provider
    (so its engines bind this run's planes), the previous one restored."""
    from llm_consensus_tpu.cli.main import main as jax_main
    from llm_consensus_tpu.providers.tpu import TPUProvider

    saved = TPUProvider._shared
    if fresh:
        TPUProvider._shared = None
    try:
        stdout, stderr = io.StringIO(), io.StringIO()
        rc = jax_main(argv, stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                      install_signal_handlers=False)
    finally:
        TPUProvider._shared = saved
    return rc, stdout.getvalue(), stderr.getvalue()


def _close_left_batchers():
    """Close every continuous batcher, of either package, that an earlier
    test in this worker left running: a batcher still decoding books its
    chunks and host gaps into whichever live plane is installed, so it
    would land in this run's metrics.json (close() lets its streams finish
    first)."""
    from llm_consensus_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    for obj in gc.get_objects():
        if isinstance(obj, (JaxBatcher, ContinuousBatcher)) and obj._thread.is_alive():
            obj.close()


def _argv(scheme, data, panel, *flags):
    return ["--models", ",".join(f"{scheme}:{m}" for m in panel), "--judge",
            f"{scheme}:tiny-llama", "--max-tokens", MAX_TOKENS, "--data-dir", str(data),
            *flags, QUESTION]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each CLI once per mode, with fresh planes and providers and no
    batcher left running by an earlier test, on the same synthetic HF
    checkpoints: {(mode, scheme): run directory}."""
    from llm_consensus_tpu.models import get_config as jax_config
    from tests.test_hf_golden import _make_hf_checkpoint

    _close_left_batchers()
    root = tmp_path_factory.mktemp("telemetry-cli")
    for seed, preset in enumerate(("tiny-llama", "tiny-qwen2")):
        _make_hf_checkpoint(jax_config(preset), str(root / "ckpt" / preset), seed=seed)
    modes = {
        "plain": (("tiny-llama", "tiny-qwen2"), (), {}),
        "events": (("tiny-llama", "tiny-qwen2"), ("--events",), {}),
        "batched": (("tiny-llama",) * 4, ("--events",), {"LLMC_MAX_BATCH": "4"}),
    }
    out = {}
    # (family, key) -> [kernel FLOPs of the counted layer, its capture]: the
    # capture books the first layer's work once for every layer.
    kernel_flops: dict = {}

    def kernel(self, flops, nbytes, out_bytes=0.0, _orig=obs.roofline.Capture.kernel):
        kernel_flops.setdefault(self._pkey, [0.0, self])[0] += flops
        return _orig(self, flops, nbytes, out_bytes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_CHECKPOINT_DIR", str(root / "ckpt"))
        mp.setattr(obs.roofline.Capture, "kernel", kernel)
        for mode, (panel, flags, env) in modes.items():
            for key, value in env.items():
                mp.setenv(key, value)
            for scheme, runner, reset in (("tpu", _jax, _reset_jax), ("gpu", _port, _reset_port)):
                reset()
                data = root / mode / scheme
                rc, stdout, stderr = runner(_argv(scheme, data, panel, *flags))
                assert rc == 0, stderr
                assert stdout == ""
                (out[mode, scheme],) = list(data.iterdir())
                if scheme == "gpu" and mode == "plain":
                    led = obs.roofline.ledger()
                    out["kernel_flops"] = {
                        fam: sum(f * cap.n_layers * rec["steps"]
                                 for (fam2, key), (f, cap) in kernel_flops.items()
                                 if fam2 == fam
                                 for rec in [led._programs[(fam2, key)]])
                        for fam in ("decode", "prefill")}
            for key in env:
                mp.delenv(key)
    yield out
    _reset_port()
    _reset_jax()


def _doc(run_dir, name="metrics.json"):
    return json.loads((run_dir / name).read_text())


def _gpu(doc):
    return json.loads(json.dumps(doc).replace("tpu:", "gpu:"))


def test_plain_run_writes_the_jax_metrics_json(runs):
    gpu, tpu = runs["plain", "gpu"], runs["plain", "tpu"]
    assert sorted(os.listdir(gpu)) == sorted(os.listdir(tpu)) == [
        "consensus.md", "metrics.json", "panel", "prompt.txt", "result.json", "run.json"]
    ours, ref = _doc(gpu), _gpu(_doc(tpu))
    assert list(ours) == list(ref) == ["models", "live", "attrib", "roofline"]
    assert sorted((m["model"], m["tokens"]) for m in ours["models"]) == sorted(
        (m["model"], m["tokens"]) for m in ref["models"])

    def live_rows(doc):
        return {name: sorted((json.dumps(r["labels"], sort_keys=True), r["count"]) for r in rows)
                for name, rows in doc["live"].items()}

    assert live_rows(ours) == live_rows(ref)
    assert set(ours["live"]) == {"device_time", "token_latency"}

    a, b = ours["attrib"], ref["attrib"]
    assert list(a) == list(b)
    assert a["dispatches"] == b["dispatches"] == {"decode": 3, "prefill": 3}
    assert a["tokens"] == b["tokens"] and a["goodput"] == b["goodput"]
    assert list(a["hbm"]["components"]) == list(b["hbm"]["components"])
    assert list(a["compiles"]) == list(a["compile_s"])  # no kernel build on the CPU

    ra, rb = ours["roofline"], ref["roofline"]
    assert list(ra) == list(rb)
    assert list(ra["families"]) == list(rb["families"]) == ["decode", "prefill"]
    for fam in ra["families"]:
        assert ra["families"][fam]["tokens"] == rb["families"][fam]["tokens"], fam
        assert list(ra["families"][fam]) == list(rb["families"][fam])
        assert ra["families"][fam]["source"] == "dispatch"
    for doc in (ra, rb):
        assert doc["crosscheck"] and all(c["ok"] for c in doc["crosscheck"].values())
    dec = ra["families"]["decode"]
    fpt = (dec["flops"] - runs["kernel_flops"]["decode"]) / dec["tokens"]
    ref_fpt = rb["crosscheck"]["decode"]["flops_per_token_xla"]
    print(f"decode flops/token: port {ra['crosscheck']['decode']['flops_per_token_xla']:.6g} "
          f"(less its kernel {fpt:.6g}), jax {ref_fpt:.6g}")
    assert abs(fpt / ref_fpt - 1) <= DECODE_FLOPS_TOL, (fpt, ref_fpt)
    for fam in ("prefill", "decode"):
        for key in ("flops", "bytes"):
            x, y = ra["families"][fam][key], rb["families"][fam][key]
            print(f"{fam} {key}: port {x:.6g} jax {y:.6g} ratio {x / y:.4f}")


def test_events_run_writes_the_jax_trace(runs):
    gpu, tpu = runs["events", "gpu"], runs["events", "tpu"]
    assert sorted(os.listdir(gpu)) == sorted(os.listdir(tpu)) == [
        "consensus.md", "metrics.json", "panel", "prompt.txt", "result.json", "run.json",
        "trace.json"]
    ours, ref = _doc(gpu), _doc(tpu)
    assert list(ours) == list(ref) == ["counters", "events", "models", "live", "attrib",
                                       "roofline"]
    assert sorted(ours["counters"]) == sorted(ref["counters"])

    def phase_names(run_dir):
        return Counter((e["ph"], e["name"]) for e in _doc(run_dir, "trace.json")["traceEvents"])

    got, want = phase_names(gpu), phase_names(tpu)
    assert got == want
    assert {n for ph, n in got if ph == "X"} == {
        "prefill", "decode", "fetch", "engine_stream", "worker"}
    assert {n for ph, n in got if ph == "C"} == {
        "roofline_flops/decode", "roofline_flops/prefill", "roofline_bytes/decode",
        "roofline_bytes/prefill"}


def test_batched_events_run_has_the_jax_batcher_spans(runs):
    gpu, tpu = runs["batched", "gpu"], runs["batched", "tpu"]

    def names(run_dir):
        return {(e["name"], e["tid"]) for e in _doc(run_dir, "trace.json")["traceEvents"]
                if e["ph"] == "X"}

    def rows(run_dir):
        doc = _doc(run_dir, "trace.json")
        tids = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
                if e["name"] == "thread_name"}
        return {(name, tids[tid]) for name, tid in names(run_dir)}

    assert rows(gpu) == rows(tpu)
    assert {"admit", "decode", "fetch"} <= {n for n, t in rows(gpu) if t == "batcher"}
    ours, ref = _doc(gpu), _doc(tpu)
    assert list(ours["batchers"]) == list(ref["batchers"]) == ["tiny-llama"]
    assert ours["attrib"]["tokens"] == ref["attrib"]["tokens"]
    assert "pool_cache:tiny-llama" in ours["attrib"]["hbm"]["components"]


def test_events_without_a_run_directory_warn_like_jax(tmp_path):
    """--events with --json, --output or --no-save: the JAX warning in the
    result's warnings, no telemetry files."""
    _reset_port()
    panel = ("tiny-llama", "tiny-qwen2")
    for flags in (("--json",), ("--no-save", "--json"), ("--output", str(tmp_path / "o.json"))):
        rc, out, err = _port(_argv("gpu", tmp_path / "data", panel, "--events", *flags))
        assert rc == 0, err
        doc = json.loads(out) if out else json.loads((tmp_path / "o.json").read_text())
        assert doc["warnings"] == [
            "run telemetry recorded but not persisted: trace.json/metrics.json ride the "
            "auto-saved run directory, which --output, --json, and --no-save disable"]
        assert not (tmp_path / "data").exists()
    _reset_jax()
    rc, out, err = _jax(_argv("tpu", tmp_path / "jdata", panel, "--events", "--json"))
    assert rc == 0, err
    assert json.loads(out)["warnings"] == doc["warnings"]
    _reset_port()


def test_trace_and_profile_flags(tmp_path, monkeypatch):
    _reset_port()
    monkeypatch.setenv("LLMC_PROFILE_DIR", str(tmp_path / "profiles"))
    panel = ("tiny-llama",)
    rc, _, err = _port(_argv("gpu", tmp_path / "d1", panel, "--trace", str(tmp_path / "tr")))
    assert rc == 0, err
    assert os.listdir(tmp_path / "tr") == ["trace.json"]
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]

    (tmp_path / "file").write_text("x")
    rc, _, err = _port(_argv("gpu", tmp_path / "d2", panel, "--trace", str(tmp_path / "file")))
    assert rc == 1 and err.startswith("error: starting profiler trace: ")

    rc, _, err = _port(_argv("gpu", tmp_path / "d3", panel, "--profile"))
    assert rc == 0, err
    (artifact,) = os.listdir(tmp_path / "profiles")
    assert err.endswith(f"profile artifact: {tmp_path / 'profiles' / artifact}\n")
    assert artifact.startswith("profile-cli-") and not artifact.endswith(".partial")
    assert os.listdir(tmp_path / "profiles" / artifact) == ["trace.json"]
    # A second window inside LLMC_PROFILE_MIN_INTERVAL_S (60 s) is refused.
    rc, _, err = _port(_argv("gpu", tmp_path / "d4", panel, "--profile"))
    assert rc == 0 and "warning: --profile window not armed (rate_limited)\n" in err
    _reset_port()
