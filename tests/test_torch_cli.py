"""The port's consensus run end to end on the CPU: CLI, runner, judge and
persistence, held to the JAX package's output contract."""

import io
import json
import os
import threading
import time

import pytest
import torch

from llm_consensus_tpu.consensus.agreement import score_agreement as jax_agreement
from llm_consensus_tpu.consensus.judge import render_judge_prompt as jax_render
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.cli.main import main
from llm_consensus_tpu_torch.consensus import Judge, render_judge_prompt
from llm_consensus_tpu_torch.providers import ProviderFunc, Registry, Response
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.runner import AllModelsFailed, Callbacks, Runner
from llm_consensus_tpu_torch.utils.context import Context

PANEL = "gpu:tiny-llama,gpu:tiny-qwen2"
JUDGE = "gpu:tiny-llama"


def _run(argv, stdin_text=""):
    stdout, stderr = io.StringIO(), io.StringIO()
    rc = main(argv, device="cpu", stdin=io.StringIO(stdin_text), stdout=stdout,
              stderr=stderr, install_signal_handlers=False)
    return rc, stdout.getvalue(), stderr.getvalue()


@pytest.fixture(scope="module", autouse=True)
def _release_engines():
    # Engines bind the telemetry planes when built: start from none, so the
    # CLI's planes reach every engine here, and leave none behind.
    for provider in GPUProvider._shared.values():
        provider.release()
    GPUProvider._shared.clear()
    yield
    GPUProvider.shared("cpu").release()
    obs.reset_planes()


# -- the output contract, against the JAX CLI's own files ---------------------------

QUESTION = "what is consensus?"
MAX_TOKENS = "8"


def _run_jax(argv):
    """The JAX CLI in this process, with a fresh shared TPU provider (it
    reads LLMC_CHECKPOINT_DIR when built); the previous one is restored."""
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


@pytest.fixture(scope="module")
def checkpoint_runs(tmp_path_factory):
    """Both CLIs, auto-saving, on the same synthetic HF checkpoints of
    tiny-llama and tiny-qwen2 through LLMC_CHECKPOINT_DIR: the JAX one with
    ``tpu:`` names, the port with ``gpu:``. Returns each run directory."""
    from llm_consensus_tpu.models import get_config as jax_config
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("cli-contract")
    for seed, preset in enumerate(("tiny-llama", "tiny-qwen2")):
        _make_hf_checkpoint(jax_config(preset), str(root / "ckpt" / preset), seed=seed)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_CHECKPOINT_DIR", str(root / "ckpt"))
        for scheme, runner in (("tpu", _run_jax), ("gpu", _run)):
            data = root / scheme
            rc, out, err = runner([
                "--models", f"{scheme}:tiny-llama,{scheme}:tiny-qwen2",
                "--judge", f"{scheme}:tiny-llama", "--max-tokens", MAX_TOKENS,
                "--data-dir", str(data), QUESTION])
            assert rc == 0, err
            assert out == ""
            (runs[scheme],) = list(data.iterdir())
    provider = GPUProvider.shared("cpu", checkpoint_dir=str(root / "ckpt"))
    yield runs, provider
    provider.release()
    GPUProvider._shared = {k: v for k, v in GPUProvider._shared.items() if v is not provider}


def _doc(run_dir, name="result.json"):
    return json.loads((run_dir / name).read_text())


def test_cli_end_to_end_auto_save(tmp_path, checkpoint_runs):
    data = tmp_path / "data"
    rc, out, err = _run(["--models", PANEL, "--judge", JUDGE, "--max-tokens", MAX_TOKENS,
                         "--data-dir", str(data), QUESTION])
    assert rc == 0, err
    assert out == ""  # auto-saved, not printed (stderr is no terminal)
    (run_dir,) = list(data.iterdir())
    # The JAX CLI's run directory, metrics.json included.
    jax_dir = checkpoint_runs[0]["tpu"]
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(jax_dir)) == [
        "consensus.md", "metrics.json", "panel", "prompt.txt", "result.json", "run.json"]
    doc = _doc(run_dir)
    assert (run_dir / "prompt.txt").read_text() == QUESTION
    assert (run_dir / "consensus.md").read_text() == doc["consensus"]
    assert sorted(r["model"] for r in doc["responses"]) == sorted(PANEL.split(","))
    assert doc["judge"] == JUDGE and doc["consensus"]
    assert all(r["provider"] == "gpu" and 0 < r["tokens"] <= 8 for r in doc["responses"])

    # The JAX CLI's own result.json: the same fields in the same order.
    jax_doc = _doc(jax_dir)
    assert list(doc) == list(jax_doc)
    for got, want in zip(doc["responses"], jax_doc["responses"]):
        assert list(got) == list(want)
    assert list(doc["agreement"]) == list(jax_doc["agreement"]) == [
        "score", "level", "divergence"]


def _as_jax(responses):
    return [JaxResponse(model=r["model"], content=r["content"], provider=r["provider"])
            for r in responses]


def test_checkpoint_runs_give_the_jax_cli_result_fields(checkpoint_runs):
    """result.json of the two CLIs on one checkpoint: key order, the
    per-response keys of each model, and ``agreement``: the JAX scoring of
    the port's own responses always, and the JAX run's exactly where the
    answers' contents are equal."""
    runs, provider = checkpoint_runs
    doc, jax_doc = _doc(runs["gpu"]), _doc(runs["tpu"])
    assert list(doc) == list(jax_doc)
    got = {r["model"].split(":", 1)[1]: r for r in doc["responses"]}
    want = {r["model"].split(":", 1)[1]: r for r in jax_doc["responses"]}
    assert sorted(got) == sorted(want) == ["tiny-llama", "tiny-qwen2"]
    for preset in got:
        assert list(got[preset]) == list(want[preset]), preset
    assert doc["agreement"] == jax_agreement(_as_jax(doc["responses"])).to_dict()
    if all(got[p]["content"] == want[p]["content"] for p in got):
        rename = {f"tpu:{p}": f"gpu:{p}" for p in got}
        jax_agree = dict(jax_doc["agreement"])
        jax_agree["divergence"] = {rename[m]: v for m, v in jax_agree["divergence"].items()}
        assert doc["agreement"] == jax_agree
    # The engines took the checkpoint's weights, not a random init.
    from llm_consensus_tpu_torch.engine.checkpoint import SafetensorsDir

    engine = provider.engines()["tiny-llama"]
    ckpt = SafetensorsDir(os.path.join(provider.checkpoint_dir, "tiny-llama"))
    assert torch.equal(engine.params["embed"],
                       ckpt.get("model.embed_tokens.weight").to(engine.dtype))


def test_checkpoint_runs_write_the_jax_manifest_and_panel(checkpoint_runs):
    runs, _ = checkpoint_runs
    gpu, tpu = runs["gpu"], runs["tpu"]
    assert sorted(os.listdir(gpu)) == sorted(os.listdir(tpu))
    manifest, jax_manifest = _doc(gpu, "run.json"), _doc(tpu, "run.json")
    assert list(manifest) == list(jax_manifest)
    for key in ("models", "judge"):
        jax_manifest[key] = json.loads(json.dumps(jax_manifest[key]).replace("tpu:", "gpu:"))
    assert manifest == jax_manifest
    assert manifest["models"] == ["gpu:tiny-llama", "gpu:tiny-qwen2"]

    # One journal file per answer, numbered in landing order, named by slug.
    names = sorted(os.listdir(gpu / "panel"))
    jax_names = sorted(os.listdir(tpu / "panel"))
    assert [n[:4] for n in names] == [n[:4] for n in jax_names] == ["000-", "001-"]
    assert sorted(n[4:] for n in names) == sorted(
        n[4:].replace("tpu_", "gpu_") for n in jax_names) == [
        "gpu_tiny-llama.json", "gpu_tiny-qwen2.json"]
    responses = {r["model"]: r for r in _doc(gpu)["responses"]}
    for name in names:
        entry = _doc(gpu / "panel", name)
        assert entry == responses[entry["model"]]
        assert list(entry) == list(_doc(tpu / "panel", jax_names[0]))


def test_panel_journal_numbers_past_existing_files_and_never_fails_a_model(tmp_path):
    from llm_consensus_tpu_torch.cli.main import panel_journal

    panel = tmp_path / "panel"
    panel.mkdir()
    (panel / "004-gpu_a.json").write_text("{torn")
    journal = panel_journal(str(tmp_path))
    journal(_resp("gpu:b", "answer"))
    assert sorted(os.listdir(panel)) == ["004-gpu_a.json", "005-gpu_b.json"]
    assert json.loads((panel / "005-gpu_b.json").read_text())["content"] == "answer"

    # A journal hook that raises is swallowed: the model still counts.
    reg = Registry()
    reg.register("ok", ProviderFunc(lambda ctx, req: _resp(req.model, "fine")))

    def boom(resp):
        raise OSError("disk full")

    result = Runner(reg, timeout=5).with_callbacks(Callbacks(on_model_response=boom)).run(
        Context.background(), ["ok"], "p")
    assert [r.model for r in result.responses] == ["ok"] and not result.failed_models


def test_cli_prints_panel_agreement_on_a_terminal(tmp_path, monkeypatch):
    """On a terminal the phase lines include the JAX CLI's "Panel
    agreement" line; the run directory is journaled the same way."""
    from llm_consensus_tpu_torch import ui

    class Terminal(io.StringIO):
        pass

    # The CLI's terminal test is ui.is_terminal (a character device, as in
    # the JAX package's ui/); a StringIO stands in for one here.
    monkeypatch.setattr(ui, "is_terminal", lambda f: isinstance(f, Terminal))
    answers = {"m:a": "the answer is forty two", "m:b": "the answer is 42"}
    reg = {m: ProviderFunc(lambda ctx, req: _resp(req.model, answers.get(req.model, "ok")))
           for m in (*answers, "m:judge")}
    stderr = Terminal()
    rc = main(["--models", "m:a,m:b", "--judge", "m:judge", "--data-dir", str(tmp_path), "q"],
              factory=reg.__getitem__, stdin=io.StringIO(""), stdout=io.StringIO(),
              stderr=stderr, install_signal_handlers=False)
    assert rc == 0
    want = jax_agreement([JaxResponse(model=m, content=c, provider="gpu")
                          for m, c in answers.items()])
    assert f"Panel agreement: {want.level} ({want.score:.2f})" in stderr.getvalue()
    (run_dir,) = list(tmp_path.iterdir())
    assert sorted(n[4:] for n in os.listdir(run_dir / "panel")) == ["m_a.json", "m_b.json"]


def test_agreement_scores_like_jax():
    from llm_consensus_tpu_torch.consensus import score_agreement

    specs = [("gpu:a", "the answer is forty two"), ("gpu:b", "the answer is 42"),
             ("gpu:c", "something else entirely"), ("gpu:d", "")]
    for n in (1, 2, 4):
        ours = score_agreement([_resp(m, c) for m, c in specs[:n]])
        theirs = jax_agreement([JaxResponse(model=m, content=c, provider="gpu")
                                for m, c in specs[:n]])
        assert (ours is None) == (theirs is None) == (n < 2)
        if ours is not None:
            assert ours.to_dict() == theirs.to_dict()


def test_cli_json_to_stdout(tmp_path):
    rc, out, err = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens",
                         "4", "--json", "--data-dir", str(tmp_path), "hi"])
    assert rc == 0, err
    doc = json.loads(out)
    # One panel answer: the judge passes it through unchanged.
    assert doc["consensus"] == doc["responses"][0]["content"]
    assert list(tmp_path.iterdir()) == []  # --json disables auto-save


def test_cli_output_file_and_stdin_prompt(tmp_path):
    target = tmp_path / "out" / "r.json"
    rc, _, err = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens", "4",
                       "--output", str(target)], stdin_text="piped prompt\n")
    assert rc == 0, err
    assert json.loads(target.read_text())["prompt"] == "piped prompt"


def test_cli_prompt_precedence(tmp_path):
    f = tmp_path / "p.txt"
    f.write_text("from file\n")
    rc, out, _ = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens", "2",
                       "--json", "--file", str(f), "positional", "wins"], "stdin")
    assert rc == 0 and json.loads(out)["prompt"] == "positional wins"
    rc, out, _ = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens", "2",
                       "--json", "--file", str(f)], "stdin")
    assert rc == 0 and json.loads(out)["prompt"] == "from file"


def test_cli_unknown_gpu_preset_lists_available():
    rc, _, err = _run(["--models", "gpu:tiny-llama,gpu:no-such-model", "x"])
    assert rc == 1
    assert "unknown gpu model 'gpu:no-such-model'" in err
    assert "gpu:llama-3-8b" in err and "gpu:consensus-1b" in err


def test_cli_flag_errors():
    assert _run(["x"])[0] == 1  # --models is required
    rc, _, err = _run(["--models", "openai-model", "x"])
    assert rc == 1 and "unknown model" in err
    assert _run(["--models", "gpu:tiny-llama", "--bogus-flag", "x"])[0] == 2


def _resp(model, content, provider="gpu"):
    return Response(model=model, content=content, provider=provider)


def test_judge_prompt_byte_identical_to_jax():
    specs = [("gpu:a", "first answer\nwith lines", "gpu"),
             ("gpu:b", "ünïcode — second", "gpu"), ("gpu:c", "", "other")]
    ours = render_judge_prompt("the user's {prompt}?", [_resp(*s) for s in specs])
    theirs = jax_render("the user's {prompt}?",
                        [JaxResponse(model=m, content=c, provider=p) for m, c, p in specs])
    assert ours.encode() == theirs.encode()


def test_judge_single_response_passthrough():
    def never(ctx, req):
        raise AssertionError("the judge must not query for one response")

    seen = []
    judge = Judge(ProviderFunc(never), "gpu:judge")
    text = judge.synthesize_stream(Context.background(), "p", [_resp("m", "only")],
                                   seen.append)
    assert text == "only" and seen == ["only"]


def test_judge_synthesize_and_model_match_jax():
    """``Judge.synthesize`` (the blocking form) and ``Judge.model``, held to
    the JAX judge over a fake provider of each package: the same judge
    request, the same answer, the same errors."""
    from llm_consensus_tpu.consensus import Judge as JaxJudge
    from llm_consensus_tpu.consensus import NoResponsesError as JaxNoResponses
    from llm_consensus_tpu.providers import ProviderFunc as JaxProviderFunc
    from llm_consensus_tpu.utils import Context as JaxContext
    from llm_consensus_tpu_torch.consensus import NoResponsesError

    specs = [("gpu:a", "first answer", "gpu"), ("gpu:b", "second answer", "gpu")]
    runs = []
    for judge_cls, func_cls, resp_cls, ctx in (
            (Judge, ProviderFunc, Response, Context.background()),
            (JaxJudge, JaxProviderFunc, JaxResponse, JaxContext.background())):
        seen = []

        def fn(ctx, req, seen=seen, resp_cls=resp_cls):
            seen.append((req.model, req.prompt, req.max_tokens, req.priority))
            return resp_cls(model=req.model, content=f"judged {len(req.prompt)}",
                            provider="gpu")

        judge = judge_cls(func_cls(fn), "gpu:judge", max_tokens=32)
        responses = [resp_cls(model=m, content=c, provider=p) for m, c, p in specs]
        text = judge.synthesize(ctx, "the question", responses)
        single = judge.synthesize(ctx, "the question", responses[:1])
        runs.append((judge.model, text, single, seen))
    assert runs[0] == runs[1]
    assert runs[0][0] == "gpu:judge" and runs[0][2] == "first answer"
    assert len(runs[0][3]) == 1  # one query: the single response passes through
    with pytest.raises(NoResponsesError):
        Judge(ProviderFunc(lambda ctx, req: None), "j").synthesize(Context.background(), "p", [])
    with pytest.raises(JaxNoResponses):
        JaxJudge(JaxProviderFunc(lambda ctx, req: None), "j").synthesize(
            JaxContext.background(), "p", [])


def test_runner_partial_failure_and_wipeout():
    reg = Registry()
    reg.register("ok", ProviderFunc(lambda ctx, req: _resp(req.model, "fine")))

    def boom(ctx, req):
        raise RuntimeError("device lost")

    reg.register("bad", ProviderFunc(boom))
    result = Runner(reg, timeout=5).run(Context.background(), ["ok", "bad"], "p")
    assert [r.model for r in result.responses] == ["ok"]
    assert result.failed_models == ["bad"] and "device lost" in result.warnings[0]
    with pytest.raises(AllModelsFailed):
        Runner(reg, timeout=5).run(Context.background(), ["bad", "missing"], "p")


def test_runner_watchdog_abandons_a_wedged_worker():
    release = threading.Event()
    reg = Registry()
    reg.register("ok", ProviderFunc(lambda ctx, req: _resp(req.model, "fine")))
    # Ignores its context: only the watchdog can give up on it.
    reg.register("stuck", ProviderFunc(lambda ctx, req: (release.wait(10), _resp("s", ""))[1]))
    t0 = time.monotonic()
    try:
        result = Runner(reg, timeout=0.2, stall_grace=0.2).run(
            Context.background(), ["ok", "stuck"], "p")
    finally:
        release.set()
    assert time.monotonic() - t0 < 5
    assert result.failed_models == ["stuck"]
    assert "abandoned" in result.warnings[0]


# -- quantization through the environment -------------------------------------

QUANT_KNOBS = ("LLMC_QUANT", "LLMC_KV_QUANT", "LLMC_W8A8", "LLMC_DECODE_W8A8",
               "LLMC_DECODE_QSTRUCT", "LLMC_INT4_IMPL")


@pytest.fixture
def clean_knobs(monkeypatch):
    for name in QUANT_KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    for key, provider in list(GPUProvider._shared.items()):
        if key[1] != tuple(sorted(GPUProvider(device="cpu").modes.items())):
            provider.release()
            del GPUProvider._shared[key]


def test_cli_env_knobs_reach_the_engines(tmp_path, clean_knobs):
    clean_knobs.setenv("LLMC_QUANT", "int8")
    clean_knobs.setenv("LLMC_KV_QUANT", "int8")
    clean_knobs.setenv("LLMC_W8A8", "1")
    clean_knobs.setenv("LLMC_DECODE_W8A8", "1")
    rc, out, err = _run(["--models", PANEL, "--judge", JUDGE, "--max-tokens", "6",
                         "--json", "--data-dir", str(tmp_path), "what is consensus?"])
    assert rc == 0, err
    doc = json.loads(out)
    provider = GPUProvider.shared("cpu", quant="int8", kv_quant="int8", w8a8=True,
                                  decode_w8a8=True)
    engines = provider.engines()
    assert sorted(engines) == ["tiny-llama", "tiny-qwen2"]
    for engine in engines.values():
        assert (engine.quant, engine.kv_quant, engine.w8a8) == ("int8", "int8", True)
        assert engine.params["layers"]["wq"]["q8"].dtype == torch.int8
    # tiny-llama has a GQA group of 2 (decode W8A8 applies); tiny-qwen2 may not.
    assert engines["tiny-llama"].decode_w8a8
    assert GPUProvider.shared("cpu").engines().get("tiny-llama") is not engines["tiny-llama"]
    # The output contract (result.json's keys) does not change with the modes.
    for name in QUANT_KNOBS:
        clean_knobs.delenv(name, raising=False)
    rc, out_bf16, _ = _run(["--models", PANEL, "--judge", JUDGE, "--max-tokens", "6",
                            "--json", "--data-dir", str(tmp_path), "what is consensus?"])
    assert list(json.loads(out_bf16)) == list(doc)
    for got, want in zip(doc["responses"], json.loads(out_bf16)["responses"]):
        assert list(got) == list(want)


def test_cli_bogus_quant_fails_before_any_build(clean_knobs, monkeypatch):
    import llm_consensus_tpu_torch.engine as engine_pkg

    def no_build(*a, **k):
        raise AssertionError("no engine may be built for a bad mode")

    monkeypatch.setattr(engine_pkg, "Engine", no_build)
    before = dict(GPUProvider._shared)
    for name, value, msg in (("LLMC_QUANT", "bogus", "unknown quant mode 'bogus'"),
                             ("LLMC_KV_QUANT", "int4", "unknown kv_quant mode 'int4'"),
                             ("LLMC_INT4_IMPL", "nible", "unknown int4_impl 'nible'")):
        clean_knobs.setenv(name, value)
        rc, out, err = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "x"])
        assert rc == 1 and out == ""
        assert err.startswith("error: initializing provider for gpu:tiny-llama") and msg in err
        clean_knobs.delenv(name)
    assert GPUProvider._shared == before


@pytest.mark.parametrize("off", ["bf16", "none", ""])
def test_cli_bf16_and_none_mean_off(clean_knobs, off):
    from llm_consensus_tpu_torch.cli.main import create_provider

    clean_knobs.setenv("LLMC_QUANT", off)
    clean_knobs.setenv("LLMC_KV_QUANT", off)
    provider = create_provider("gpu:tiny-llama", "cpu")
    assert provider is GPUProvider.shared("cpu")
    assert provider.modes["quant"] is None and provider.modes["kv_quant"] is None


def test_provider_mbu_uses_the_modes_byte_widths(monkeypatch):
    """MBU counts 1 byte per int8 weight, 0.5 per int4 weight and 1 per
    int8 cache element (the JAX provider's widths)."""
    import llm_consensus_tpu_torch.utils.flops as flops
    from llm_consensus_tpu_torch.providers import Request

    seen = []

    def fake_mbu(cfg, tps, kind, context_len=0, weight_bytes=2, kv_bytes=2):
        seen.append((weight_bytes, kv_bytes))
        return 0.5

    monkeypatch.setattr(flops, "decode_mbu", fake_mbu)
    for modes, want in (({}, (4, 4)), ({"quant": "int8", "kv_quant": "int8"}, (1, 1)),
                        ({"quant": "int4"}, (0.5, 4))):
        provider = GPUProvider(device="cpu", **modes)
        engine = provider._engine_for("gpu:tiny-llama")
        engine.dtype = torch.float32
        monkeypatch.setattr(engine, "generate", lambda *a, **k: type("R", (), dict(
            token_ids=[1] * 40, text="x", finish_reason="length", prompt_tokens=5,
            truncated_prompt=False, decode_tokens=32, decode_s=0.5))())
        resp = provider.query(Context.background(), Request(model="gpu:tiny-llama", prompt="p"))
        assert resp.tokens_per_sec == 64.0
        assert seen[-1] == want, modes


# -- continuous batching through the environment --------------------------------

BATCH_KNOBS = ("LLMC_MAX_BATCH", "LLMC_BATCH_STREAMS", "LLMC_POOL_PREFIX",
               "LLMC_POOL_PREFIX_MIN", "LLMC_PREFILL_BUDGET", "LLMC_POOL_BUCKET",
               "LLMC_PRESSURE_PREEMPT")
# The batching part of the default shared provider's key.
DEFAULT_BATCHING = tuple(sorted({
    "batch_streams": 1, "pool_prefix": True, "pool_prefix_min": 192, "prefill_budget": 0,
    "pool_bucket": True, "preempt": True}.items()))
# 4 panel streams of one prompt share all of it but one token: at least the
# 192 common tokens that establish sharing.
LONG_PROMPT = ("Compare shipping drives by courier with streaming over the existing "
               "link and with renting a dedicated line, on cost, time, risk and effort, "
               "for a dataset of four hundred terabytes that has to arrive within five "
               "days; recommend one option and say why.")


@pytest.fixture
def batch_knobs(monkeypatch):
    for name in BATCH_KNOBS + QUANT_KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    for key, provider in list(GPUProvider._shared.items()):
        if key[2] != DEFAULT_BATCHING:
            provider.release()
            del GPUProvider._shared[key]


def test_cli_batched_duplicate_panel_matches_unbatched(tmp_path, batch_knobs):
    """A panel of 4 x gpu:tiny-llama under LLMC_MAX_BATCH=4: every answer
    comes through the one batcher (which establishes the shared prompt as
    its prefix) and result.json holds the answers and consensus of the
    unbatched run."""
    def argv(data_dir):
        return ["--models", ",".join(["gpu:tiny-llama"] * 4), "--judge", JUDGE,
                "--max-tokens", "12", "--data-dir", str(data_dir), LONG_PROMPT]

    assert len(LONG_PROMPT) > 193
    rc, _, err = _run(argv(tmp_path / "plain"))
    assert rc == 0, err
    batch_knobs.setenv("LLMC_MAX_BATCH", "4")
    rc, _, err = _run(argv(tmp_path / "batched"))
    assert rc == 0, err
    provider = GPUProvider.shared("cpu", batch_streams=4)
    stats = provider.batcher_stats()
    assert list(stats) == ["tiny-llama"]
    assert stats["tiny-llama"]["prefix_len"] == 0  # the judge, last, admitted alone
    assert stats["tiny-llama"]["admitted"] == 5  # every panel answer and the judge's
    assert stats["tiny-llama"]["establish_tokens"] == len(LONG_PROMPT)
    doc, ref = (json.loads(next((tmp_path / side).iterdir()).joinpath("result.json")
                           .read_text()) for side in ("batched", "plain"))
    assert len(doc["responses"]) == 4 and not doc.get("failed_models")
    assert sorted(r["content"] for r in doc["responses"]) == sorted(
        r["content"] for r in ref["responses"])
    assert doc["consensus"] == ref["consensus"]
    assert list(doc) == list(ref)


def test_cli_batched_panel_establishes_the_shared_prefix(tmp_path, batch_knobs, monkeypatch):
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    seen = []
    real = ContinuousBatcher._establish_prefix

    def spy(self, prefix_ids):
        ok = real(self, prefix_ids)
        seen.append((len(prefix_ids), ok))
        return ok

    monkeypatch.setattr(ContinuousBatcher, "_establish_prefix", spy)
    batch_knobs.setenv("LLMC_BATCH_STREAMS", "4")  # the fallback spelling
    rc, _, err = _run(["--models", ",".join(["gpu:tiny-llama"] * 4), "--judge", JUDGE,
                       "--max-tokens", "6", "--json", LONG_PROMPT])
    assert rc == 0, err
    assert seen == [(len(LONG_PROMPT), True)]  # bos + bytes, less the last token


def test_shared_provider_keys_on_batching(batch_knobs):
    from llm_consensus_tpu_torch.cli.main import create_provider

    plain = create_provider("gpu:tiny-llama", "cpu")
    batch_knobs.setenv("LLMC_MAX_BATCH", "4")
    batched = create_provider("gpu:tiny-llama", "cpu")
    assert plain is GPUProvider.shared("cpu") and plain.batch_streams == 1
    assert batched is not plain and batched.batch_streams == 4
    batch_knobs.setenv("LLMC_POOL_PREFIX", "0")
    unshared = create_provider("gpu:tiny-llama", "cpu")
    assert unshared is not batched and unshared.pool_prefix is False


def test_batch_knobs_parse_like_jax(batch_knobs):
    from llm_consensus_tpu.utils import knobs as jknobs
    from llm_consensus_tpu_torch.utils.knobs import batch_settings

    for env in ({}, {"LLMC_MAX_BATCH": "4"}, {"LLMC_BATCH_STREAMS": "3"},
                {"LLMC_MAX_BATCH": "x", "LLMC_BATCH_STREAMS": "2"},
                {"LLMC_POOL_PREFIX": "off", "LLMC_POOL_PREFIX_MIN": "64"},
                {"LLMC_POOL_PREFIX_MIN": "bad"},
                {"LLMC_PREFILL_BUDGET": "2048", "LLMC_POOL_BUCKET": "0"},
                {"LLMC_PREFILL_BUDGET": "-3", "LLMC_PRESSURE_PREEMPT": "no"}):
        for name in BATCH_KNOBS:
            batch_knobs.delenv(name, raising=False)
        for name, value in env.items():
            batch_knobs.setenv(name, value)
        want = {
            "batch_streams": (jknobs.get_int("LLMC_MAX_BATCH", 0)
                              or jknobs.get_int("LLMC_BATCH_STREAMS")),
            "pool_prefix": jknobs.get_bool("LLMC_POOL_PREFIX"),
            "pool_prefix_min": jknobs.get_int("LLMC_POOL_PREFIX_MIN"),
            # The JAX batcher clamps the budget at 0 when it reads it.
            "prefill_budget": max(0, jknobs.get_int("LLMC_PREFILL_BUDGET")),
            "pool_bucket": jknobs.get_bool("LLMC_POOL_BUCKET"),
            "preempt": jknobs.get_bool("LLMC_PRESSURE_PREEMPT"),
        }
        assert batch_settings() == want, env


def test_cli_refuses_interleaved_admission(batch_knobs, monkeypatch, capsys):
    """Interleaved admission is served now: LLMC_PREFILL_BUDGET and
    --prefill-budget (one setting, as in the JAX CLI) reach the batcher;
    what the CLI still refuses is a budget that is not an integer, with
    argparse's exit code 2 like the JAX CLI."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    budgets = []
    real = ContinuousBatcher.__init__

    def spy(self, engine, max_batch=8, **kw):
        budgets.append(kw.get("prefill_budget"))
        real(self, engine, max_batch, **kw)

    monkeypatch.setattr(ContinuousBatcher, "__init__", spy)
    batch_knobs.setenv("LLMC_MAX_BATCH", "4")
    batch_knobs.setenv("LLMC_PREFILL_BUDGET", "512")
    rc, _, err = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens", "4",
                       "--json", "x"])
    assert rc == 0, err
    batch_knobs.delenv("LLMC_PREFILL_BUDGET")
    rc, _, err = _run(["--models", "gpu:tiny-llama", "--judge", JUDGE, "--max-tokens", "4",
                       "--prefill-budget", "64", "--json", "x"])
    assert rc == 0, err
    assert budgets == [512, 64]
    from llm_consensus_tpu_torch.utils.knobs import batch_settings

    assert batch_settings()["prefill_budget"] == 64  # the flag set the knob
    capsys.readouterr()
    rc, out, _ = _run(["--models", "gpu:tiny-llama", "--prefill-budget", "lots", "x"])
    assert rc == 2 and out == ""  # argparse reports on the process's stderr
    assert "--prefill-budget" in capsys.readouterr().err


class _Recording:
    """Fake providers for both CLIs that record each request's priority
    class: (model, priority, is the judge's prompt)."""

    def __init__(self, scheme):
        self.scheme, self.seen, self._lock = scheme, [], threading.Lock()

    def factory(self, model):
        if self.scheme == "tpu":
            from llm_consensus_tpu.providers import ProviderFunc as Func
            from llm_consensus_tpu.providers.base import Response as Resp
        else:
            Func, Resp = ProviderFunc, Response

        def fn(ctx, req):
            with self._lock:
                self.seen.append((req.model.split(":", 1)[1], req.priority,
                                  "You are a synthesis judge" in req.prompt))
            return Resp(req.model, f"{req.model} says yes", "fake", 1.0)

        return Func(fn)


PRIORITY_CASES = {
    "none": [],
    "low": ["--priority", "low"],
    "numeric high": ["-priority", "0"],
    "normal with overlap": ["--priority", "Normal", "--judge-overlap"],
}


@pytest.mark.parametrize("case", sorted(PRIORITY_CASES))
def test_cli_priority_reaches_panel_and_judge_like_jax(tmp_path, case):
    """--priority stamps every panel request and the judge's one class above
    it (max 0): each CLI's fakes see the same classes, the JAX CLI's run
    and the port's print the same result."""
    from llm_consensus_tpu.cli.main import main as jax_main

    seen, outs = {}, {}
    for scheme, entry in (("tpu", jax_main), ("gpu", main)):
        fakes = _Recording(scheme)
        argv = ["--models", f"{scheme}:a,{scheme}:b", "--judge", f"{scheme}:j", "--json",
                *PRIORITY_CASES[case], "q"]
        stdout, stderr = io.StringIO(), io.StringIO()
        rc = entry(argv, factory=fakes.factory, stdin=io.StringIO(""), stdout=stdout,
                   stderr=stderr, install_signal_handlers=False)
        assert rc == 0, stderr.getvalue()
        seen[scheme] = sorted(fakes.seen)
        doc = json.loads(stdout.getvalue())
        outs[scheme] = (doc["consensus"].replace("tpu:", "gpu:"),
                        sorted(r["content"].replace("tpu:", "gpu:") for r in doc["responses"]))
    assert seen["gpu"] == seen["tpu"]
    panel = [p for m, p, judge in seen["gpu"] if not judge]
    judge = [p for m, p, is_judge in seen["gpu"] if is_judge]
    want = {"none": (None, 0), "low": (2, 1), "numeric high": (0, 0),
            "normal with overlap": (1, 0)}[case]
    assert panel == [want[0]] * 2 and judge == [want[1]]
    assert outs["gpu"] == outs["tpu"]


@pytest.mark.parametrize("value", ["urgent", "3", "-1", "1.5"])
def test_cli_bad_priority_fails_like_jax_before_any_provider(value):
    from llm_consensus_tpu.cli.main import main as jax_main

    errs = {}
    for scheme, entry in (("tpu", jax_main), ("gpu", main)):
        built = []
        stdout, stderr = io.StringIO(), io.StringIO()
        rc = entry(["--models", f"{scheme}:a", "--priority", value, "q"],
                   factory=built.append, stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                   install_signal_handlers=False)
        assert rc == 1 and stdout.getvalue() == "" and built == []
        errs[scheme] = stderr.getvalue()
    assert errs["gpu"] == errs["tpu"] and errs["gpu"].startswith("error: ")


def test_cli_priority_reaches_the_batcher(tmp_path, batch_knobs, monkeypatch):
    """With a batched provider, the class of each submit: the panel's
    --priority low is 2, the judge's 1."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    classes = []
    real = ContinuousBatcher.submit

    def spy(self, prompt, sampling, ctx=None, on_text=None, *, priority=1, **kw):
        classes.append((priority, "You are a synthesis judge" in prompt))
        return real(self, prompt, sampling, ctx, on_text, priority=priority, **kw)

    monkeypatch.setattr(ContinuousBatcher, "submit", spy)
    batch_knobs.setenv("LLMC_MAX_BATCH", "4")
    rc, _, err = _run(["--models", "gpu:tiny-llama,gpu:tiny-llama", "--judge", JUDGE,
                       "--max-tokens", "4", "--priority", "low", "--prefill-budget", "32",
                       "--json", "which class?"])
    assert rc == 0, err
    assert sorted(classes) == [(1, True), (2, False), (2, False)]


# -- remote providers and the overlapped judge ---------------------------------------


@pytest.fixture
def fake_openai(monkeypatch):
    """A local stand-in for the OpenAI Responses API (SSE), reached through
    OPENAI_BASE_URL; yields the bodies it received."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    bodies = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            bodies.append(body)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for delta in ("remote ", "answer"):
                event = {"type": "response.output_text.delta", "delta": delta}
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")

        def log_message(self, *args):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("OPENAI_BASE_URL", f"http://127.0.0.1:{server.server_address[1]}")
    yield bodies
    server.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_mixed_panel_with_judge_overlap_writes_the_jax_cli_run(tmp_path, fake_openai,
                                                              monkeypatch):
    """A remote model beside a gpu one, the gpu judge overlapped (it is also
    a panel model, so its session prefills while its engine decodes the
    panel answer): both CLIs write the same run directory and result.json
    fields, and the port's judge really rode a prefill session."""
    from llm_consensus_tpu_torch.engine import Engine

    sessions = []
    real_session = Engine.prefill_session

    def counted(self):
        sessions.append(self.cfg.name)
        return real_session(self)

    monkeypatch.setattr(Engine, "prefill_session", counted)
    docs, dirs = {}, {}
    for scheme, runner in (("tpu", _run_jax), ("gpu", _run)):
        data = tmp_path / scheme
        rc, out, err = runner([
            "--models", f"gpt-5.2-2025-12-11,{scheme}:tiny-llama",
            "--judge", f"{scheme}:tiny-llama", "--judge-overlap", "--max-tokens", MAX_TOKENS,
            "--data-dir", str(data), QUESTION])
        assert rc == 0, err
        (dirs[scheme],) = list(data.iterdir())
        docs[scheme] = _doc(dirs[scheme])
    assert sorted(os.listdir(dirs["gpu"])) == sorted(os.listdir(dirs["tpu"]))
    assert sorted(os.listdir(dirs["gpu"] / "panel")) == sorted(
        n.replace("tpu_", "gpu_") for n in os.listdir(dirs["tpu"] / "panel"))
    doc, jax_doc = docs["gpu"], docs["tpu"]
    assert list(doc) == list(jax_doc)
    by_model = {r["model"]: r for r in doc["responses"]}
    jax_by_model = {r["model"].replace("tpu:", "gpu:"): r for r in jax_doc["responses"]}
    assert sorted(by_model) == sorted(jax_by_model) == ["gpt-5.2-2025-12-11", "gpu:tiny-llama"]
    for model, resp in by_model.items():
        assert list(resp) == list(jax_by_model[model])
    remote = by_model["gpt-5.2-2025-12-11"]
    assert remote["content"] == jax_by_model["gpt-5.2-2025-12-11"]["content"] == "remote answer"
    assert remote["provider"] == "openai"
    assert doc["judge"] == "gpu:tiny-llama" and doc["consensus"] and not doc.get("warnings")
    assert sessions == ["tiny-llama"]  # the port's judge rode one prefill session
    assert [b["input"] for b in fake_openai] == [QUESTION, QUESTION]
    assert all(b["stream"] is True and b["model"] == "gpt-5.2-2025-12-11" for b in fake_openai)


def test_unknown_model_message_is_the_jax_clis():
    rc, _, err = _run(["--models", "openai-model", "x"])
    jax_rc, _, jax_err = _run_jax(["--models", "openai-model", "x"])
    assert rc == jax_rc == 1
    assert err == jax_err.replace("tpu:<model>", "gpu:<model>")
    assert "gpt-5.2-2025-12-11" in err and "'gpu:<model>'" in err


def test_remote_model_without_a_key_fails_at_registry_init(monkeypatch):
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    rc, _, err = _run(["--models", "claude-opus-4-5,gpu:tiny-llama", "x"])
    assert rc == 1
    assert "initializing provider for claude-opus-4-5" in err and "ANTHROPIC_API_KEY" in err


# -- fault injection and crash recovery through the CLI (faults/, recovery/) -------------------


@pytest.fixture
def fault_knobs(monkeypatch):
    """Both packages' fault plans, journals and integrity planes reset around
    the test (they are process-wide; the JAX ones resolve from the
    environment once)."""
    from llm_consensus_tpu import faults as jax_faults
    from llm_consensus_tpu import integrity as jax_integrity
    from llm_consensus_tpu import recovery as jax_recovery
    from llm_consensus_tpu_torch import faults, integrity

    mods = (faults, integrity, jax_faults, jax_integrity, jax_recovery)
    for mod in mods:
        mod.reset()
    before = dict(GPUProvider._shared)
    yield monkeypatch
    for key, provider in list(GPUProvider._shared.items()):
        if key not in before:
            provider.release()
            del GPUProvider._shared[key]
    for mod in mods:
        mod.reset()


def test_cli_crash_replay_writes_the_jax_faults_txt(tmp_path, checkpoint_runs, fault_knobs):
    """``LLMC_FAULTS=crash@chunk=3 LLMC_JOURNAL=1`` on a batched pool, both
    CLIs on one checkpoint: the run survives the crash (one restart, the
    answer whole), the run directory lists what the JAX CLI's lists, with
    ``faults.txt``, and ``faults.txt`` and ``metrics.json``'s ``faults`` are
    the JAX CLI's, byte for byte after the ``tpu:`` → ``gpu:`` rename."""
    runs, _provider = checkpoint_runs
    ckpt = runs["tpu"].parent.parent / "ckpt"
    for knob, value in (("LLMC_CHECKPOINT_DIR", str(ckpt)), ("LLMC_MAX_BATCH", "2"),
                        ("LLMC_JOURNAL", "1"), ("LLMC_FAULTS", "crash@chunk=3"),
                        ("LLMC_FAULTS_SEED", "7")):
        fault_knobs.setenv(knob, value)
    dirs = {}
    for scheme, runner in (("tpu", _run_jax), ("gpu", _run)):
        data = tmp_path / scheme
        rc, out, err = runner(["--models", f"{scheme}:tiny-llama", "--judge",
                               f"{scheme}:tiny-llama", "--max-tokens", "48", "--events",
                               "--data-dir", str(data), QUESTION])
        assert rc == 0, err
        (dirs[scheme],) = list(data.iterdir())
    ours, theirs = dirs["gpu"], dirs["tpu"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "consensus.md", "faults.txt", "metrics.json", "panel", "prompt.txt", "result.json",
        "run.json", "trace.json"]
    trace = (ours / "faults.txt").read_bytes()
    assert trace == (theirs / "faults.txt").read_bytes().replace(b"tpu:", b"gpu:")
    assert b"engine#3[model=tiny-llama]->crash" in trace
    assert trace.count(b"build#") == 2  # the engine and its one rebuild
    metrics = _doc(ours, "metrics.json")
    assert metrics["faults"] == [ln.replace("tpu:", "gpu:")
                                 for ln in _doc(theirs, "metrics.json")["faults"]]
    assert (ours / "faults.txt").read_text().splitlines() == metrics["faults"]
    (resp,) = _doc(ours)["responses"]
    assert resp["tokens"] == 48
    provider = next(p for p in GPUProvider._shared.values() if p.journal is not None)
    stats = provider.recovery_stats()
    assert (stats["restarts"], stats["journal_depth"]) == (1, 0), stats


def test_cli_without_faults_writes_no_faults_txt(tmp_path, fault_knobs):
    from llm_consensus_tpu_torch import faults

    rc, _out, err = _run(["--models", "gpu:tiny-llama", "--judge", "gpu:tiny-llama",
                          "--max-tokens", "4", "--data-dir", str(tmp_path), QUESTION])
    assert rc == 0, err
    (run_dir,) = list(tmp_path.iterdir())
    assert "faults.txt" not in os.listdir(run_dir) and faults.plan() is None


def test_recovery_and_fault_knobs_parse_like_jax(fault_knobs):
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    assert knobs.recovery_settings() == {"journal": "", "engine_heartbeat_s": 0.0,
                                         "engine_restarts": 3}
    assert knobs.fault_settings() == {"spec": "", "seed": 0}
    assert not knobs.integrity_enabled()
    for name, value in (("LLMC_JOURNAL", "/tmp/wal"), ("LLMC_ENGINE_HEARTBEAT_S", "2.5"),
                        ("LLMC_ENGINE_RESTARTS", "5"), ("LLMC_FAULTS", "crash@chunk=2"),
                        ("LLMC_FAULTS_SEED", "9"), ("LLMC_INTEGRITY", "1")):
        fault_knobs.setenv(name, value)
    assert knobs.recovery_settings() == {
        "journal": "/tmp/wal", "engine_heartbeat_s": jax_knobs.get_float(
            "LLMC_ENGINE_HEARTBEAT_S"), "engine_restarts": jax_knobs.get_int(
            "LLMC_ENGINE_RESTARTS")}
    assert knobs.fault_settings() == {"spec": jax_knobs.get_str("LLMC_FAULTS"),
                                      "seed": jax_knobs.get_int("LLMC_FAULTS_SEED")}
    assert knobs.integrity_enabled() and jax_knobs.get_bool("LLMC_INTEGRITY")
    fault_knobs.setenv("LLMC_JOURNAL", "0")
    assert knobs.recovery_settings()["journal"] == ""
    # The journal settings join the shared provider's key.
    a = GPUProvider.shared("cpu", journal="1")
    b = GPUProvider.shared("cpu", journal="1", engine_heartbeat_s=2.0)
    assert a is not GPUProvider.shared("cpu") and a is not b
    assert a is GPUProvider.shared("cpu", journal="1") and a.journal is not None
    assert GPUProvider.shared("cpu", journal="0") is GPUProvider.shared("cpu")
