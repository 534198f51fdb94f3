"""Speculative decoding through the port's provider and CLI (mirrors
tests/test_speculative.py's provider and CLI cases and
tests/test_tpu_provider.py's draft-with-batching pair).

The provider cases hold a drafted ``GPUProvider`` to the plain one (greedy
output is token-exact) and check the routing rules: model drafts are
single-stream and ignored with one warning under batching, ``lookup``
batches through the pool's rounds, configuration errors turn speculation off
with one warning. The CLI cases run both CLIs on one synthetic tiny
checkpoint with ``--draft``/``--spec-k``, the config file's ``draft`` and a
batched ``--draft lookup --events`` run, and compare ``result.json`` (and
``metrics.json``'s ``spec`` block) after the ``tpu:`` → ``gpu:`` rename.
"""

import io
import json
import warnings

import pytest
import torch

from llm_consensus_tpu.providers import tpu as jax_tpu
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.cli.main import main
from llm_consensus_tpu_torch.providers import Request
from llm_consensus_tpu_torch.providers import gpu as gpu_mod
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.utils import knobs
from llm_consensus_tpu_torch.utils.context import Context

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC_KNOBS = ("LLMC_DRAFT", "LLMC_SPEC_K", "LLMC_SPEC_NGRAM", "LLMC_SPEC_ADAPT",
              "LLMC_SPEC_GOVERNOR", "LLMC_SPEC_PROBE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in SPEC_KNOBS + ("LLMC_MAX_BATCH", "LLMC_BATCH_STREAMS", "LLMC_CHECKPOINT_DIR",
                              "LLMC_EVENTS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("LLMC_CONFIG", "0")
    before = dict(GPUProvider._shared)
    yield
    for key, provider in list(GPUProvider._shared.items()):
        if key not in before:
            provider.release()
            del GPUProvider._shared[key]
    obs.reset_planes()


def _provider(**kw):
    return GPUProvider(device="cpu", ignore_eos=True, stream_interval=4, **kw)


# The provider's engines run bf16, where the verify forward (T = k + 1) and
# the decode step (T = 1) round differently: a greedy token may flip where
# the model's two best logits are this close (a bf16 ulp at |logit| ~3 is
# 0.016; seen: 0.008 on tiny-mistral). Float32 engines are exact
# (tests/test_torch_speculative.py).
NEAR_TIE = 0.05


def _equal_or_near_tie(engine, prompt, got, want):
    """Greedy tokens equal, or equal up to a first difference where the
    model's logits of the two tokens (teacher-forced on ``want``) are
    within NEAR_TIE."""
    import torch

    from llm_consensus_tpu_torch.models.transformer import forward

    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return len(got) == len(want)
    ids = engine.tokenizer.encode(prompt) + want[:i]
    with torch.inference_mode():
        logits, _ = forward(engine.params, engine.cfg, torch.tensor([ids]), None, 0)
    last = logits[0, -1].float()
    return abs(float(last[got[i]] - last[want[i]])) <= NEAR_TIE


def test_provider_draft_flag_exactness():
    """A draft through the provider: greedy output equals the plain
    provider's (bf16: up to a near-tie), and the speculative engine is
    engaged with the target's capacity cap."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    plain, drafted = _provider(), _provider(draft="tiny-llama")
    prompt = "drafted consensus check"
    req = Request(model="gpu:tiny-mistral", prompt=prompt, max_tokens=16)
    try:
        want = plain.query(Context.background(), req)
        got = drafted.query(Context.background(), req)
        assert got.tokens == want.tokens == 16
        entry = drafted._specs.get("tiny-mistral")
        assert entry is not None and entry[1] is not None
        assert entry[1].stats["rounds"] > 0
        assert entry[1].draft.max_seq == entry[0].max_seq  # the target's cap
        s = SamplingParams(max_new_tokens=16, ignore_eos=True)
        ref = plain._engines["tiny-mistral"].generate(prompt, s)
        assert ref.text == want.content
        spec_ids = entry[1].generate(prompt, s).token_ids
        assert _equal_or_near_tie(entry[0], prompt, spec_ids, ref.token_ids)
    finally:
        plain.release()
        drafted.release()


def test_provider_draft_self_pair_disabled():
    provider = _provider(draft="tiny-llama")
    assert provider._draft_preset_for("tiny-llama") is None
    assert provider._draft_preset_for("tiny-mistral") == "tiny-llama"


@pytest.mark.parametrize("spec", ["", "tiny-llama", "a=b, c=d", "a=b,fallback", " lookup ",
                                  "x=lookup,,y=z"])
def test_provider_draft_pair_spec_parsing(spec):
    assert gpu_mod._parse_draft_spec(spec) == jax_tpu._parse_draft_spec(spec)


def test_draft_plus_batching_warns_and_batches():
    """A model draft under batching is ignored with ONE warning and the
    requests batch (never a silent bypass); the pool is not speculative."""
    provider = _provider(batch_streams=2, draft="tiny-llama")
    req = Request(model="gpu:tiny-mistral", prompt="spec vs batch", max_tokens=4)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            provider.query(Context.background(), req)
            provider.query(Context.background(), req)
        msgs = [str(c.message) for c in caught
                if "model draft" in str(c.message) and "ignored" in str(c.message)]
        assert len(msgs) == 1, msgs
        assert "tiny-mistral" in provider._batchers
        assert not provider._specs
        assert provider._batchers["tiny-mistral"]._spec is None
    finally:
        provider.release()


def test_lookup_draft_composes_with_batching():
    """``lookup`` with batching: the pool runs rounds (no warning), the
    output equals the plain batched provider's, ``spec_stats`` carries the
    pool's snapshot."""
    req = Request(model="gpu:tiny-llama", prompt="lookup composes", max_tokens=8)
    plain, spec = _provider(batch_streams=2), _provider(batch_streams=2, draft="lookup")
    try:
        want = plain.query(Context.background(), req)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = spec.query(Context.background(), req)
        assert got.content == want.content
        assert not [c for c in caught if "ignored" in str(c.message)]
        batcher = spec._batchers["tiny-llama"]
        assert batcher._spec is not None and batcher.spec_snapshot()["rounds"] > 0
        stats = spec.spec_stats()
        assert stats["tiny-llama"]["kind"] == "lookup"
        assert plain.spec_stats() == {}
    finally:
        plain.release()
        spec.release()


def test_lookup_single_stream_and_stats_keys():
    """Unbatched ``lookup``: the provider's single-stream speculative engine;
    ``spec_stats`` has the JAX provider's keys."""
    provider = _provider(draft="lookup", spec_k=3)
    req = Request(model="gpu:tiny-llama", prompt="lookup lookup lookup lookup", max_tokens=12)
    plain = _provider()
    try:
        assert (provider.query(Context.background(), req).content
                == plain.query(Context.background(), req).content)
        (stats,) = provider.spec_stats().values()
        assert set(stats) == {"kind", "k", "rounds", "accepted", "mean_accepted", "accept_ema",
                              "governor_disables", "collapse_faults"}
        assert stats["kind"] == "lookup" and stats["k"] == 3 and stats["rounds"] > 0
    finally:
        provider.release()
        plain.release()


def test_unknown_draft_preset_warns_once_and_serves_plain():
    provider = _provider(draft="no-such-model")
    plain = _provider()
    req = Request(model="gpu:tiny-llama", prompt="typo'd draft", max_tokens=6)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = provider.query(Context.background(), req)
            provider.query(Context.background(), req)
        msgs = [str(c.message) for c in caught
                if "speculative decoding disabled" in str(c.message)]
        assert len(msgs) == 1 and "no-such-model" in msgs[0], msgs
        assert got.content == plain.query(Context.background(), req).content
        assert provider.spec_stats() == {}
    finally:
        provider.release()
        plain.release()


def test_draft_build_errors_other_than_configuration_propagate(monkeypatch):
    """A failure building the draft engine that is no configuration error
    (here a RuntimeError, as a CUDA error is) is not swallowed."""
    provider = _provider(draft="tiny-llama")
    real = GPUProvider._build_engine

    def build(self, preset, max_seq=None):
        if max_seq is not None:  # the draft's build
            raise RuntimeError("device lost while building the draft")
        return real(self, preset, max_seq)

    monkeypatch.setattr(GPUProvider, "_build_engine", build)
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            provider._spec_for("tiny-mistral", provider._engine_for("gpu:tiny-mistral"))
    finally:
        provider.release()


def test_set_draft_and_set_spec_k():
    provider = _provider(spec_k=5)
    provider.set_draft("lookup", k=2)
    assert provider._draft_preset_for("tiny-llama") == "lookup" and provider._spec_k == 2
    provider.set_spec_k(3)
    assert provider._spec_k == 3 and provider._draft_preset_for("x") == "lookup"
    provider.set_draft("")  # resets the map and k to the provider's setting
    assert provider._draft_preset_for("tiny-llama") is None and provider._spec_k == 5


@pytest.mark.parametrize("env", [{}, {"LLMC_DRAFT": "lookup", "LLMC_SPEC_K": "6",
                                      "LLMC_SPEC_NGRAM": "2", "LLMC_SPEC_ADAPT": "0",
                                      "LLMC_SPEC_GOVERNOR": "off", "LLMC_SPEC_PROBE": "32"},
                                 {"LLMC_SPEC_K": "0", "LLMC_SPEC_NGRAM": "-3"}])
def test_spec_knobs_parse_like_jax(monkeypatch, env):
    """``spec_settings`` reads the JAX package's knobs with its defaults
    and its clamps (``spec_config_from_env``)."""
    from llm_consensus_tpu.engine.speculative import spec_config_from_env
    from llm_consensus_tpu.utils import knobs as jax_knobs

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours = knobs.spec_settings()
    theirs = spec_config_from_env(kind="lookup")
    assert ours["spec_k"] == theirs.k and ours["spec_ngram"] == theirs.ngram
    assert ours["spec_adapt"] == theirs.adaptive
    assert ours["spec_governor"] == theirs.governor
    assert ours["spec_probe"] == theirs.probe_tokens
    assert ours["draft"] == jax_knobs.get_str("LLMC_DRAFT")


def test_spec_settings_join_the_shared_key(monkeypatch):
    a = GPUProvider.shared("cpu")
    monkeypatch.setenv("LLMC_DRAFT", "lookup")
    b = GPUProvider.shared("cpu", **knobs.spec_settings())
    assert a is not b and b._draft_preset_for("tiny-llama") == "lookup"


# -- both CLIs on one synthetic checkpoint ----------------------------------------

QUESTION = "what is consensus? what is consensus?"


def _run_port(argv):
    stdout, stderr = io.StringIO(), io.StringIO()
    rc = main(argv, device="cpu", stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
              install_signal_handlers=False)
    return rc, stdout.getvalue(), stderr.getvalue()


def _run_jax(argv):
    from llm_consensus_tpu.cli.main import main as jax_main
    from llm_consensus_tpu.providers.tpu import TPUProvider

    saved = TPUProvider._shared
    TPUProvider._shared = None
    try:
        stdout, stderr = io.StringIO(), io.StringIO()
        rc = jax_main(argv, stdin=io.StringIO(""), stdout=stdout, stderr=stderr,
                      install_signal_handlers=False)
        provider = TPUProvider._shared
    finally:
        TPUProvider._shared = saved
    if provider is not None:
        provider.release()
    return rc, stdout.getvalue(), stderr.getvalue()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from llm_consensus_tpu.models import get_config as jax_config
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("spec-cli")
    for seed, preset in enumerate(("tiny-llama", "tiny-qwen2")):
        _make_hf_checkpoint(jax_config(preset), str(root / preset), seed=seed)
    return root


@pytest.fixture
def one_device(monkeypatch):
    """The JAX planner would spread a model over the 8 virtual CPU devices,
    which turns its speculation off: pin every placement to one device."""
    import jax
    from llm_consensus_tpu.providers.tpu import TPUProvider

    orig = TPUProvider.prepare
    monkeypatch.setattr(TPUProvider, "prepare", lambda self, models, judge, devices=None:
                        orig(self, models, judge, devices=jax.devices()[:1]))


def _both(tmp_path, argv, ckpt, monkeypatch, env=None):
    """Both CLIs auto-saving into their own data dir; returns each run
    directory."""
    monkeypatch.setenv("LLMC_CHECKPOINT_DIR", str(ckpt))
    for name, value in (env or {}).items():
        monkeypatch.setenv(name, value)
    dirs = {}
    for scheme, runner in (("tpu", _run_jax), ("gpu", _run_port)):
        data = tmp_path / scheme
        args = [a.replace("@", f"{scheme}:") for a in argv]
        rc, _out, err = runner(args + ["--data-dir", str(data), QUESTION])
        assert rc == 0, err
        (dirs[scheme],) = list(data.iterdir())
    return dirs


def _result(run_dir):
    doc = json.loads((run_dir / "result.json").read_text().replace("tpu:", "gpu:"))
    for r in doc["responses"]:
        r["provider"] = r["provider"].replace("tpu", "gpu")
        r.pop("latency_ms")
        r.pop("tokens_per_sec", None)
        r.pop("mfu", None)
        r.pop("mbu", None)
    doc["responses"].sort(key=lambda r: r["model"])  # completion order varies
    return doc


PANEL = ["--models", "@tiny-llama,@tiny-qwen2", "--judge", "@tiny-llama", "--max-tokens", "16"]


@pytest.fixture(scope="module")
def plain_runs(ckpt, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_CONFIG", "0")
        return _both(tmp_path_factory.mktemp("plain"), PANEL, ckpt, mp)


@pytest.mark.parametrize("how", ["flag", "config"])
def test_cli_draft_and_spec_k_equal_the_jax_cli_and_plain(tmp_path, ckpt, plain_runs,
                                                          monkeypatch, one_device, how):
    """``--draft tiny-llama=tiny-qwen2 --spec-k 3`` (or the config file's
    ``draft``): both CLIs' result.json equal each other and the plain runs'
    (greedy exactness at the product surface), the draft engaged."""
    argv = PANEL + ["--spec-k", "3"]
    if how == "flag":
        argv += ["--draft", "tiny-llama=tiny-qwen2"]
    else:
        cfg = tmp_path / "c.json"
        cfg.write_text(json.dumps({"draft": "tiny-llama=tiny-qwen2"}))
        monkeypatch.setenv("LLMC_CONFIG", str(cfg))
    from llm_consensus_tpu_torch.consensus import judge as judge_mod

    judge_prompts = []
    render = judge_mod.render_judge_prompt
    monkeypatch.setattr(judge_mod, "render_judge_prompt",
                        lambda *a: judge_prompts.append(render(*a)) or judge_prompts[-1])
    dirs = _both(tmp_path, argv, ckpt, monkeypatch)
    provider = next(p for p in GPUProvider._shared.values()
                    if p._draft_preset_for("tiny-llama") == "tiny-qwen2")
    ours, theirs = _result(dirs["gpu"]), _result(dirs["tpu"])
    # The JAX CLI's fields in its order, a drafted response's ``spec`` block
    # included (contents differ across the packages in bf16: see
    # tests/test_torch_cli.py).
    assert list(ours) == list(theirs)
    for got, want in zip(ours["responses"], theirs["responses"]):
        assert list(got) == list(want) and list(got.get("spec", {})) == list(want.get("spec", {}))
    assert "spec" in next(r for r in ours["responses"] if r["model"] == "gpu:tiny-llama")
    # Greedy exactness at the product surface: the plain run's answers; the
    # drafted judge's tokens equal its plain engine's up to a bf16 near-tie
    # (NEAR_TIE, teacher-forced on the judge prompt the run rendered).
    plain = _result(plain_runs["gpu"])
    strip = [{k: v for k, v in r.items() if k != "spec"} for r in ours["responses"]]
    assert strip == plain["responses"]
    if ours["consensus"] != plain["consensus"]:
        from llm_consensus_tpu_torch.engine import SamplingParams

        (judge_prompt,) = judge_prompts
        spec = provider._specs["tiny-llama"][1]
        s = SamplingParams(max_new_tokens=16)
        want = spec.target.generate(judge_prompt, s)
        got = spec.generate(judge_prompt, s)
        assert got.text == ours["consensus"] and want.text == plain["consensus"]
        assert _equal_or_near_tie(spec.target, judge_prompt, got.token_ids, want.token_ids)
    stats = provider.spec_stats()
    assert stats["tiny-llama"]["rounds"] > 0 and stats["tiny-llama"]["k"] == 3
    assert "tiny-qwen2" not in stats  # a target drafts only through its pair


def test_cli_batched_lookup_with_events(tmp_path, ckpt, monkeypatch, one_device):
    """``LLMC_MAX_BATCH=2 --draft lookup --events``: both CLIs' answers
    equal, metrics.json's ``spec`` block has the JAX CLI's keys."""
    argv = PANEL + ["--draft", "lookup", "--events"]
    dirs = _both(tmp_path, argv, ckpt, monkeypatch, env={"LLMC_MAX_BATCH": "2"})
    ours, theirs = _result(dirs["gpu"]), _result(dirs["tpu"])
    assert list(ours) == list(theirs)
    for got, want in zip(ours["responses"], theirs["responses"]):
        assert list(got) == list(want)
    mine = json.loads((dirs["gpu"] / "metrics.json").read_text())
    jax_m = json.loads((dirs["tpu"] / "metrics.json").read_text())
    assert set(mine["spec"]) == set(jax_m["spec"]) == {"tiny-llama", "tiny-qwen2"}
    for preset in mine["spec"]:
        assert set(mine["spec"][preset]) == set(jax_m["spec"][preset])
        assert mine["spec"][preset]["kind"] == "lookup"


def test_cli_draft_does_not_leak_into_the_next_run(tmp_path, ckpt, monkeypatch):
    """The flag reaches the shared provider on every run, so a run without
    ``--draft`` after one with it drafts nothing."""
    monkeypatch.setenv("LLMC_CHECKPOINT_DIR", str(ckpt))
    base = ["--models", "gpu:tiny-llama", "--judge", "gpu:tiny-llama", "--max-tokens", "4",
            "--no-save", "--json", QUESTION]
    assert _run_port(base[:-1] + ["--draft", "lookup", QUESTION])[0] == 0
    provider = next(p for p in GPUProvider._shared.values()
                    if p.checkpoint_dir == str(ckpt))
    assert provider._draft_preset_for("tiny-llama") == "lookup"
    assert _run_port(base)[0] == 0
    assert provider._draft_preset_for("tiny-llama") is None
