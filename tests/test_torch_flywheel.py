"""The port's data flywheel (``flywheel/corpus.py``, ``flywheel/distill.py``,
``flywheel/canary.py``, the ``distill`` subcommand and ``/v1/swap``'s
``out_dir`` form) held to ``tests/test_flywheel.py`` and the JAX package on
the CPU.

The corpus must hold the same examples, corpus hash and train/holdout split
as the JAX scanner on one data directory; distillation's parameters after a
step are held to the JAX step's in ``tests/test_torch_train.py``
(``test_distill_step_follows_the_jax_step``, float32, with its stated
tolerances); versions are monotone and a torn save stays
invisible; the watcher's window rules and the rollback it drives run on a
real engine; ``distill``'s summary has the JAX CLI's shape, and its
checkpoint swaps into a served engine. The hot-swap and router-canary cases
of the JAX file are held elsewhere (``tests/test_torch_swap.py``,
``tests/test_torch_fleet.py``).
"""

from __future__ import annotations

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu import integrity as jax_integrity
from llm_consensus_tpu.flywheel.canary import CanaryWatcher as JaxWatcher
from llm_consensus_tpu.flywheel.corpus import build_corpus as jax_build_corpus
from llm_consensus_tpu.flywheel.corpus import encode_examples as jax_encode
from llm_consensus_tpu.flywheel.distill import latest_checkpoint as jax_latest
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch import faults, integrity, obs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
from llm_consensus_tpu_torch.flywheel.canary import CanaryWatcher
from llm_consensus_tpu_torch.flywheel.corpus import (
    ARTIFACTS_DIRNAME, build_corpus, encode_examples, scan_run_dirs)
from llm_consensus_tpu_torch.flywheel.distill import (
    latest_checkpoint, next_version, run_distill, save_checkpoint)
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy

PRESET = "tiny-llama"
CPU = torch.device("cpu")


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
    for knob in ("LLMC_FAULTS", "LLMC_INTEGRITY", "LLMC_DATA_DIR"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()
    yield
    for mod in (faults, integrity, jax_faults, jax_integrity):
        mod.reset()
    obs.reset_planes()


def _write_run(data_dir, run_id, *, consensus="the verdict text", prompt="what is consensus?",
               n_responses=2, result=True, torn=False, salt=""):
    """The JAX file's run-directory writer."""
    run_dir = os.path.join(str(data_dir), run_id)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "run.json"), "w", encoding="utf-8") as f:
        json.dump({"run_id": run_id}, f)
    if not result:
        return run_dir
    path = os.path.join(run_dir, "result.json")
    if torn:
        with open(path, "w", encoding="utf-8") as f:
            f.write('{"consensus": "half a jso')
        return run_dir
    doc = {"prompt": prompt + salt, "consensus": consensus,
           "responses": [{"model": f"m{i}", "content": f"answer {i}{salt}", "provider": "fake"}
                         for i in range(n_responses)]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return run_dir


def _same_corpus(port, jax_corpus):
    """The same examples (run, prompt, verdict, key) on the same sides, the
    same hash and counts."""
    def side(examples):
        return [(e.run_id, e.prompt, e.verdict, e.key) for e in examples]

    assert side(port.train) == side(jax_corpus.train)
    assert side(port.holdout) == side(jax_corpus.holdout)
    assert port.summary() == jax_corpus.summary()


# -- the corpus ---------------------------------------------------------------------------------


def test_manifest_is_sole_authority(tmp_path):
    _write_run(tmp_path, "r01", salt="1")
    _write_run(tmp_path, "r02", salt="2")
    for pollution in (ARTIFACTS_DIRNAME, "blackbox", "roofline-20260807"):
        os.makedirs(tmp_path / pollution / "nested", exist_ok=True)
        (tmp_path / pollution / "dump.bin").write_bytes(b"\x00\x01")
    (tmp_path / "stray-file.json").write_text("{}")
    runs, skipped = scan_run_dirs(str(tmp_path))
    assert [r[0] for r in runs] == ["r01", "r02"] and skipped == 3
    corpus = build_corpus(str(tmp_path), holdout=0.0)
    assert corpus.runs_scanned == 2 and corpus.runs_skipped == 3
    assert len(corpus.train) == 2 and corpus.runs_corrupt == 0
    _same_corpus(corpus, jax_build_corpus(str(tmp_path), holdout=0.0))


def test_corrupt_and_thin_runs(tmp_path):
    """A torn result counts as corrupt, never fatal; in-flight, one-response
    and empty-verdict runs contribute nothing."""
    _write_run(tmp_path, "r01", salt="ok")
    _write_run(tmp_path, "r02", torn=True)
    _write_run(tmp_path, "r03", result=False)
    _write_run(tmp_path, "r04", n_responses=1)
    _write_run(tmp_path, "r05", consensus="")
    corpus = build_corpus(str(tmp_path), holdout=0.0)
    assert corpus.runs_corrupt == 1 and corpus.corrupt_ids == ["r02"]
    assert len(corpus.train) == 1 and corpus.runs_scanned == 5
    _same_corpus(corpus, jax_build_corpus(str(tmp_path), holdout=0.0))


def test_dedup_stable_split_and_hash_equal_jax(tmp_path):
    """Identical pairs dedup to one; the split and the corpus hash are the
    JAX scanner's, reproducible across rescans, and an example keeps its
    side as unrelated runs accumulate."""
    for i in range(24):
        _write_run(tmp_path, f"r{i:02d}", salt=str(i))
    _write_run(tmp_path, "r90", salt="0")
    corpus = build_corpus(str(tmp_path), holdout=0.25)
    assert corpus.deduped == 1 and len(corpus.train) + len(corpus.holdout) == 24
    assert len(corpus.holdout) > 0
    _same_corpus(corpus, jax_build_corpus(str(tmp_path), holdout=0.25))
    assert build_corpus(str(tmp_path), holdout=0.25).corpus_hash == corpus.corpus_hash
    sides = {ex.key: "h" for ex in corpus.holdout}
    sides.update({ex.key: "t" for ex in corpus.train})
    for i in range(8):
        _write_run(tmp_path, f"s{i:02d}", salt=f"new-{i}")
    grown = build_corpus(str(tmp_path), holdout=0.25)
    assert grown.corpus_hash != corpus.corpus_hash
    assert all(sides.get(ex.key, "h") == "h" for ex in grown.holdout)
    assert all(sides.get(ex.key, "t") == "t" for ex in grown.train)
    _same_corpus(grown, jax_build_corpus(str(tmp_path), holdout=0.25))


def test_corpus_corrupt_injection(tmp_path):
    """``corpus_corrupt@run=r02`` (the ``swap`` site, now with a caller)
    torches one manifested run mid-scan: counted, the build goes on; the
    same plan fires the same way in the JAX scanner."""
    for i in (1, 2, 3):
        _write_run(tmp_path, f"r0{i}", salt=str(i))
    faults.install(faults.FaultPlan("corpus_corrupt@run=r02"))
    jax_faults.install(jax_faults.FaultPlan("corpus_corrupt@run=r02"))
    corpus = build_corpus(str(tmp_path), holdout=0.0)
    assert corpus.runs_corrupt == 1 and {ex.run_id for ex in corpus.train} == {"r01", "r03"}
    _same_corpus(corpus, jax_build_corpus(str(tmp_path), holdout=0.0))
    assert faults.plan().trace_bytes() == jax_faults.plan().trace_bytes()


def test_encoded_batches_equal_jax(tmp_path):
    for i in range(3):
        _write_run(tmp_path, f"r{i}", salt=f"-{i}" * (i * 20))
    examples = build_corpus(str(tmp_path), holdout=0.0).train
    from llm_consensus_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer

    for seq in (16, 64, 512):
        assert encode_examples(ByteTokenizer(), examples, seq) == jax_encode(
            JaxByteTokenizer(), examples, seq)


# -- distillation: versions, torn saves, the loop -----------------------------------------------


def test_versions_are_monotone_and_a_torn_save_stays_invisible(tmp_path):
    """``next_version`` counts up past every version directory; a save torn
    before its ``version.json`` lands is skipped by ``latest_checkpoint``
    (the JAX one returns it: its ``params/`` exists)."""
    from llm_consensus_tpu_torch.models.transformer import init_params

    cfg = get_config(PRESET)
    params = init_params(cfg, 0, device=CPU, dtype=torch.float32)
    out = str(tmp_path)
    assert latest_checkpoint(out) is None and next_version(out) == 1
    save_checkpoint(out, 1, params, {"corpus_hash": "a"}, cfg=cfg)
    save_checkpoint(out, next_version(out), params, {"corpus_hash": "b"}, cfg=cfg)
    latest = latest_checkpoint(out)
    assert latest["version"] == 2 and latest["corpus_hash"] == "b"
    assert latest["params_digest"] == integrity.digest_tree(params)
    torn = tmp_path / "v0003"
    os.makedirs(torn / "params")
    (torn / "params" / "model.safetensors").write_bytes(b"\x00" * 8)
    (torn / "version.json.tmp").write_text('{"version": 3')
    assert latest_checkpoint(out)["version"] == 2
    assert next_version(out) == 4  # a torn version's number is never reused
    assert jax_latest(out)["version"] == 3  # the JAX reader picks the torn save


def _corpus_dir(tmp_path, n=6):
    for i in range(n):
        _write_run(tmp_path, f"r{i:02d}", salt=f" variant {i}",
                   consensus=f"the panel agrees on answer {i % 3}")
    return str(tmp_path)


def test_run_distill_lowers_the_holdout_loss_and_writes_a_version(tmp_path):
    corpus = build_corpus(_corpus_dir(tmp_path / "data"), holdout=0.34)
    assert corpus.train and corpus.holdout
    out = str(tmp_path / "out")
    summary = run_distill(corpus, student=PRESET, out_dir=out, device="cpu", steps=8, lr=1e-2,
                          batch=2, seq=64)
    assert summary["steps"] == 8 and summary["weight_version"] == 1
    assert summary["holdout_loss_after"] < summary["holdout_loss_before"], summary
    latest = latest_checkpoint(out)
    assert latest["version"] == 1 and latest["corpus_hash"] == corpus.corpus_hash
    assert latest["holdout_loss_after"] == summary["holdout_loss_after"]


# -- the canary watcher -------------------------------------------------------------------------


def _feed(watchers, base_s, canary_s, n=10):
    for w in watchers:
        for _ in range(n):
            w.record(0, base_s)
            w.record(1, canary_s)


def _ticks(watchers):
    out = [w.tick() for w in watchers]
    assert len(set(out)) == 1, out
    return out[0]


def test_watcher_requires_consecutive_regressed_windows():
    ws = [CanaryWatcher(tol=1.5, windows=2, min_samples=5),
          JaxWatcher(tol=1.5, windows=2, min_samples=5)]
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is False
    _feed(ws, 0.010, 0.011)
    assert _ticks(ws) is False
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is False
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is True
    assert ws[0].stats() == ws[1].stats() and ws[0].stats()["regressions"] == 1


def test_watcher_ignores_starved_and_uniform_windows():
    ws = [CanaryWatcher(tol=1.5, windows=2, min_samples=5),
          JaxWatcher(tol=1.5, windows=2, min_samples=5)]
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is False
    for w in ws:
        for _ in range(20):
            w.record(0, 0.010)
    assert _ticks(ws) is False
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is True
    _feed(ws, 0.010, 0.050)
    assert _ticks(ws) is False
    _feed(ws, 0.010, 0.050, n=2)
    assert _ticks(ws) is False
    assert ws[0].stats() == ws[1].stats() and ws[0].stats()["streak"] == 0


def test_the_watcher_takes_the_knobs_defaults(monkeypatch):
    """The port's watcher defaults to what the JAX one reads from an empty
    environment (the JAX knobs' defaults)."""
    for name in ("LLMC_CANARY_WINDOWS", "LLMC_CANARY_LATENCY_TOL", "LLMC_CANARY_MIN_SAMPLES"):
        monkeypatch.delenv(name, raising=False)
    ours, theirs = CanaryWatcher(), JaxWatcher()
    assert (ours.tol, ours.windows, ours.min_samples) == (
        theirs.tol, theirs.windows, theirs.min_samples)


def _tree(seed):
    jp = jax_init(jax_config(PRESET), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, jp), get_config(PRESET), CPU,
                             torch.float32)


def test_a_canary_regression_rolls_a_real_engine_back():
    """Watcher verdict → rollback hook → the engine serves its baseline
    weights again (the same greedy tokens) under a new monotone version."""
    eng = Engine(get_config(PRESET), params=_tree(0), dtype=torch.float32, max_seq=128,
                 device="cpu")
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    base = eng.generate("the canary probe", s).token_ids
    assert eng.swap_weights(1, _tree(5)) is True
    assert eng.generate("the canary probe", s).token_ids != base
    fired = []

    def on_regress(info):
        fired.append(info)
        eng.rollback_weights({"reason": "canary_regress", **info})

    w = CanaryWatcher(tol=1.5, windows=2, min_samples=5, on_regress=on_regress)
    for _ in range(3):
        _feed([w], 0.010, 0.080)
        if w.tick():
            break
    assert len(fired) == 1 and fired[0]["canary_version"] == 1 and fired[0]["ratio"] > 1.5
    assert eng.weight_version == 2 and eng.weight_meta["rolled_back_to"] == 0
    assert eng.weight_meta["reason"] == "canary_regress"
    assert eng.generate("the canary probe", s).token_ids == base


# -- the distill subcommand and the swap of its checkpoint ---------------------------------------


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """``distill`` through both CLIs on one data directory and one synthetic
    HF checkpoint (both start from the same weights); the port's summary,
    the JAX one, and the port's output root."""
    from llm_consensus_tpu.cli.main import main as jax_main
    from llm_consensus_tpu_torch.cli.main import main as port_main
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("distill")
    data = _corpus_dir(root / "data")
    _make_hf_checkpoint(jax_config(PRESET), str(root / "ckpt" / PRESET), seed=0)
    argv = ["distill", "--data-dir", data, "--student", PRESET, "--steps", "2", "--batch", "2",
            "--seq", "32", "--checkpoints", str(root / "ckpt"), "--quiet"]
    out = {}
    for name, entry, kw in (("gpu", port_main, {"device": "cpu"}), ("tpu", jax_main, {})):
        stdout = io.StringIO()
        rc = entry(argv + ["--out", str(root / name)], stdout=stdout, stderr=io.StringIO(),
                   install_signal_handlers=False, **kw)
        assert rc == 0, stdout.getvalue()
        out[name] = json.loads(stdout.getvalue())
    return out["gpu"], out["tpu"], str(root / "gpu"), str(root / "ckpt")


def test_distill_summary_has_the_jax_clis_shape(distilled):
    """The same keys, the same corpus block and run settings; both wrote
    version 1 (the JAX one Orbax, the port HF safetensors); finite losses."""
    ours, theirs, out, _ckpt = distilled
    assert sorted(ours) == sorted(theirs)
    for key in ("corpus", "corpus_hash", "version", "train", "holdout", "student", "teacher",
                "steps", "batch", "seq", "weight_version", "runs_scanned", "deduped"):
        assert ours[key] == theirs[key], key
    for key in ("loss", "kl", "ce", "grad_norm", "holdout_loss_before", "holdout_loss_after"):
        assert np.isfinite(ours[key]), key
    assert os.listdir(os.path.join(out, "v0001", "params")) == ["model.safetensors"]


def test_distilled_checkpoint_swaps_in_with_its_digest(distilled):
    """The provider loads the distilled version (its digest checked with the
    integrity plane on) into a served engine: generates then equal a fresh
    engine loaded from the checkpoint."""
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    _ours, _theirs, out, ckpt = distilled
    latest = latest_checkpoint(out)
    integrity.install(integrity.IntegrityPlane())
    prov = GPUProvider(device="cpu", ignore_eos=True, checkpoint_dir=ckpt)
    try:
        meta = {k: v for k, v in latest.items() if k != "params_path"}
        stats = prov.swap_weights(f"gpu:{PRESET}", latest["params_path"], latest["version"],
                                  meta=meta)
        assert stats["accepted"] and stats["weight_version"] == 1, stats
        eng = prov._engines[PRESET]
        fresh = Engine(get_config(PRESET), try_load_params(
            get_config(PRESET), latest["params_path"], device=CPU), device="cpu")
        s = SamplingParams(max_new_tokens=8, ignore_eos=True)
        assert eng.generate("a swapped judge", s).token_ids == fresh.generate(
            "a swapped judge", s).token_ids
        assert integrity.plane().stats()["checks"].get("ckpt") == 1
        bad = dict(meta, params_digest="00000000")
        refused = prov.swap_weights(f"gpu:{PRESET}", latest["params_path"], 9, meta=bad)
        assert refused["accepted"] is False and refused["rejected"] == "params_digest_mismatch"
    finally:
        prov.release()


def test_v1_swap_out_dir_swaps_the_newest_version(distilled, tmp_path):
    """``POST /v1/swap {"model", "out_dir"}`` on the port's gateway over a
    real provider: the newest version installs (200, its version), and the
    served engine generates what a fresh engine on the checkpoint does."""
    import http.client

    from llm_consensus_tpu_torch import serve
    from llm_consensus_tpu_torch.engine.checkpoint import try_load_params
    from llm_consensus_tpu_torch.providers import Registry
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    _ours, _theirs, out, ckpt = distilled
    prov = GPUProvider(device="cpu", ignore_eos=True, checkpoint_dir=ckpt)
    registry = Registry()
    registry.register(f"gpu:{PRESET}", prov)
    gw = serve.build_gateway(registry, [f"gpu:{PRESET}"], f"gpu:{PRESET}", max_tokens=8,
                             data_dir=str(tmp_path), save=False, port=0,
                             pressure={"enabled": False})
    try:
        gw.start()
        conn = http.client.HTTPConnection("127.0.0.1", gw.address[1], timeout=120)
        conn.request("POST", "/v1/swap", json.dumps({"model": f"gpu:{PRESET}", "out_dir": out}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        assert r.status == 200 and doc["weight_version"] == 1, doc
        s = SamplingParams(max_new_tokens=8, ignore_eos=True)
        params = try_load_params(get_config(PRESET), latest_checkpoint(out)["params_path"],
                                 device=CPU)
        want = Engine(get_config(PRESET), params, device="cpu").generate("served", s).token_ids
        assert prov._engines[PRESET].generate("served", s).token_ids == want
    finally:
        gw.close(drain=False)
        prov.release()
