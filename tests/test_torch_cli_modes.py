"""The consensus modes of the port's CLI held to the JAX CLI on the CPU.

Each mode's argv goes through ``llm_consensus_tpu.cli.main.main(factory=)``
and ``llm_consensus_tpu_torch.cli.main.main(factory=)`` with one
deterministic fake provider per package: its content is a function of
(model, prompt), a fixed grading reply answers the confidence prompt, and
panel workers answer in worker order, so the judge prompt (which lists the
answers in completion order) is deterministic. After the one rename
between the CLIs (``tpu:`` → ``gpu:``) and without latency fields, every
prompt each fake received, ``result.json``, ``run.json``, the ``panel/``
listing and the error messages must be equal. The real engines then run
``--rounds 2 --confidence`` and ``--vote`` over synthetic checkpoints.
Unit copies of the JAX package's vote and confidence tests run against the
port's modules."""

import hashlib
import importlib
import io
import json
import os
import re
import threading
import time

import pytest

from llm_consensus_tpu.cli.main import main as jax_main
from llm_consensus_tpu.consensus import judge as jax_judge
from llm_consensus_tpu.providers import ProviderFunc as JaxProviderFunc
from llm_consensus_tpu.providers import Response as JaxResponse
from llm_consensus_tpu_torch.cli.main import main as port_main
from llm_consensus_tpu_torch.consensus import (
    grade_confidence,
    parse_confidence,
    parse_vote,
    render_confidence_prompt,
    render_critique_prompt,
    render_refine_prompt,
    render_vote_prompt,
    tally_votes,
)
from llm_consensus_tpu_torch.providers import ProviderFunc, Request, Response
from llm_consensus_tpu_torch.utils.context import Context

cli_mod = importlib.import_module("llm_consensus_tpu_torch.cli.main")

SCHEMES = ("tpu", "gpu")
GRADE = "CONFIDENCE: 72\nCONTROVERSY:\n- the panel split on cost\n- and on risk"
GRADE_MARK = "You are a grading judge"
VOTE_MARK = "Choose exactly ONE of the following options"
CRITIQUE_MARK = "Critique it"
REFINE_MARK = "[Previous draft answer under revision]"
QUESTION = "Which transport should carry 400 TB in five days?"


def _norm(text: str) -> str:
    """The one rename between the CLIs' outputs: model names and slugs."""
    return text.replace("tpu:", "gpu:").replace("tpu_", "gpu_")


# How long a panel worker waits for its predecessors before it fails the
# run: far past any real tiny-engine answer on a loaded machine.
TURN_BOUND_S = 300.0


def _wait_turn(bound_s: float = TURN_BOUND_S) -> None:
    """Panel worker ``i`` (thread ``runner-<i>-<model>`` in both runners)
    answers only once workers 0..i-1 of the fan-out have finished: answers
    land in worker order. A worker never answers out of turn: past
    ``bound_s`` it raises (its model fails, loudly) instead."""
    name = threading.current_thread().name
    if not name.startswith("runner-"):
        return
    idx = int(name.split("-")[1])
    deadline = time.monotonic() + bound_s
    while any(t.is_alive() and t.name.startswith("runner-")
              and int(t.name.split("-")[1]) < idx for t in threading.enumerate()):
        if time.monotonic() >= deadline:
            raise RuntimeError(f"panel worker {idx} waited {bound_s} s for its predecessors")
        time.sleep(0.002)


class Fakes:
    """The fake providers of one CLI invocation. ``fail(preset, prompt)``
    makes a query raise; ``votes`` maps a preset to its vote reply;
    ``grade`` answers the confidence prompt."""

    def __init__(self, scheme: str, fail=None, votes=None, grade=GRADE):
        self.scheme = scheme
        self.fail = fail
        self.votes = votes or {}
        self.grade = grade
        self.calls: list = []
        self.built: list = []
        self._lock = threading.Lock()

    def factory(self, model: str):
        self.built.append(_norm(model))
        resp_cls, func_cls = ((JaxResponse, JaxProviderFunc) if self.scheme == "tpu"
                              else (Response, ProviderFunc))
        preset = model.split(":", 1)[-1]

        def fn(ctx, req):
            _wait_turn()
            prompt = _norm(req.prompt)
            with self._lock:
                self.calls.append((_norm(req.model), req.system, prompt))
            if self.fail is not None and self.fail(preset, prompt):
                raise RuntimeError(f"{preset} refused the query")
            if GRADE_MARK in prompt:
                content = self.grade
            elif VOTE_MARK in prompt:
                content = self.votes.get(preset, "A")
            else:
                digest = hashlib.sha256(prompt.encode()).hexdigest()[:10]
                verb = "refines" if REFINE_MARK in prompt else "answers"
                content = f"{preset} {verb} {digest}\nwith a second line"
            return resp_cls(req.model, content, "fake", 1.0)

        return func_cls(fn)


def _invoke(scheme: str, argv: list, stdin: str = "", **fake_kw):
    fakes = Fakes(scheme, **fake_kw)
    stdout, stderr = io.StringIO(), io.StringIO()
    entry = jax_main if scheme == "tpu" else port_main
    rc = entry(argv, factory=fakes.factory, stdin=io.StringIO(stdin), stdout=stdout,
               stderr=stderr, install_signal_handlers=False)
    return rc, stdout.getvalue(), stderr.getvalue(), fakes


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k != "latency_ms"}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _text(text: str):
    """Normalized output: a JSON document without latencies, else text."""
    text = _norm(text)
    try:
        return _strip(json.loads(text))
    except ValueError:
        return re.sub(r'"latency_ms": [^,\n]*', '"latency_ms": 0', text)


def _run_dirs(data_dir: str) -> list:
    """Every run directory of ``data_dir`` in start order (its run.json's
    mtime), each as its listing and its files, normalized."""
    if not os.path.isdir(data_dir):
        return []
    dirs = [os.path.join(data_dir, d) for d in os.listdir(data_dir)]
    dirs.sort(key=lambda d: os.stat(os.path.join(d, "run.json")).st_mtime_ns)
    out = []
    for d in dirs:
        snap = {"listing": sorted(os.listdir(d)), "files": {}, "panel": []}
        for name in ("run.json", "result.json", "prompt.txt", "consensus.md"):
            path = os.path.join(d, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    snap["files"][name] = _text(f.read())
        panel = os.path.join(d, "panel")
        for name in sorted(os.listdir(panel)) if os.path.isdir(panel) else []:
            with open(os.path.join(panel, name), encoding="utf-8") as f:
                snap["panel"].append((_norm(name), _text(f.read())))
        out.append(snap)
    return out


def _snapshot(rc, out, err, fakes, data_dir=None) -> dict:
    return {"rc": rc, "out": _text(out), "err": _norm(err),
            "calls": sorted(fakes.calls, key=lambda c: (c[0], c[2], c[1] or "")),
            "built": sorted(fakes.built),
            "runs": _run_dirs(data_dir) if data_dir else []}


def both(tmp_path, argv_of, stdin_of=None, **fake_kw) -> dict:
    """Run ``argv_of(scheme, data_dir)`` through each CLI (each with its own
    data directory) and return the gpu snapshot after asserting it equals
    the tpu one."""
    snaps = {}
    for scheme in SCHEMES:
        data = str(tmp_path / scheme)
        rc, out, err, fakes = _invoke(scheme, argv_of(scheme, data),
                                      stdin_of(scheme) if stdin_of else "", **fake_kw)
        snaps[scheme] = _snapshot(rc, out, err, fakes, data)
    assert snaps["gpu"] == snaps["tpu"]
    return snaps["gpu"]


def panel(scheme, *presets):
    return ",".join(f"{scheme}:{p}" for p in presets)


def _base(scheme, data, *flags, presets=("a", "b")):
    return ["--models", panel(scheme, *presets), "--judge", f"{scheme}:j", "--data-dir",
            data, *flags]


def _judge_calls(snap):
    return [c for c in snap["calls"] if c[0] == "gpu:j"]


# -- fake-provider parity, mode by mode ---------------------------------------


def test_rounds_2_parity(tmp_path):
    snap = both(tmp_path, lambda s, d: _base(s, d, "--rounds", "2", QUESTION))
    assert snap["rc"] == 0 and snap["err"] == ""
    (run,) = snap["runs"]
    assert run["files"]["run.json"]["rounds"] == 2
    critiques = [c for c in snap["calls"] if CRITIQUE_MARK in c[2]]
    assert len(critiques) == 2 and len(_judge_calls(snap)) == 2
    assert sum(REFINE_MARK in c[2] for c in _judge_calls(snap)) == 1
    # The result keeps round 1's answers, the consensus is round 2's.
    result = run["files"]["result.json"]
    assert all(CRITIQUE_MARK not in r["content"] for r in result["responses"])
    assert [n for n, _ in run["panel"]] == ["000-gpu_a.json", "001-gpu_b.json"]


def test_rounds_3_with_a_failing_critique_parity(tmp_path):
    snap = both(tmp_path, lambda s, d: _base(s, d, "--rounds", "3", "--json", QUESTION,
                                             presets=("a", "b", "c")),
                fail=lambda preset, prompt: preset == "b" and CRITIQUE_MARK in prompt)
    assert snap["rc"] == 0
    warnings = snap["out"]["warnings"]
    assert [w.split(":")[0] for w in warnings] == ["round 2", "round 3"]
    assert all("gpu:b: b refused the query" in w for w in warnings)
    assert len(_judge_calls(snap)) == 3
    assert "failed_models" not in snap["out"]


def test_rounds_keep_the_last_good_consensus_parity(tmp_path):
    """Round 3's critique loses every model: a warning, round 2's consensus
    stays."""
    snap = both(tmp_path, lambda s, d: _base(s, d, "--rounds", "3", "--json", QUESTION),
                fail=lambda preset, prompt: CRITIQUE_MARK in prompt
                and "j refines" in prompt.split("--- Draft answer ---", 1)[1])
    assert snap["rc"] == 0
    assert snap["out"]["warnings"][0].startswith(
        "round 3 critique failed, keeping round 2 consensus: all models failed: gpu:a: a "
        "refused the query")
    assert snap["out"]["consensus"].startswith("j refines ")
    assert len(_judge_calls(snap)) == 2


VOTES = {
    "winner": ({"a": "B\nbecause it is fastest", "b": "A", "c": "I pick B in the end."},
               "B"),
    "tie": ({"a": "C", "b": "A"}, "A"),
    "no parse": ({"a": "hmm", "b": "no idea"}, None),
}


@pytest.mark.parametrize("case", sorted(VOTES))
def test_vote_parity(tmp_path, case):
    votes, winner = VOTES[case]
    presets = tuple(sorted(votes))
    snap = both(tmp_path, lambda s, d: _base(s, d, "--vote", "--options", "A,B,C", QUESTION,
                                             presets=presets), votes=votes)
    assert snap["rc"] == 0
    (run,) = snap["runs"]
    result = run["files"]["result.json"]
    assert result["judge"] == "vote" and not _judge_calls(snap)
    assert "gpu:j" not in snap["built"]  # the judge is never built
    assert all(VOTE_MARK in c[2] for c in snap["calls"])
    first = result["consensus"].splitlines()[0]
    assert first == (winner or "No winner: no response contained a recognizable vote.")
    unparsed = [p for p, v in votes.items() if parse_vote(v, ["A", "B", "C"]) is None]
    assert result.get("warnings", []) == [
        f"gpu:{p}: no recognizable vote in response" for p in unparsed]
    assert run["files"]["run.json"]["vote"] is True
    assert run["files"]["run.json"]["options"] == ["A", "B", "C"]


@pytest.mark.parametrize("grade", [GRADE, "no structured grade here"],
                         ids=["graded", "unparseable"])
def test_confidence_parity(tmp_path, grade):
    snap = both(tmp_path, lambda s, d: _base(s, d, "--confidence", QUESTION), grade=grade)
    assert snap["rc"] == 0
    (run,) = snap["runs"]
    result = run["files"]["result.json"]
    assert [c for c in snap["calls"] if GRADE_MARK in c[2]]
    if grade == GRADE:
        assert result["confidence"] == {"score": 72, "controversy": [
            "the panel split on cost", "and on risk"]}
        assert list(result)[-1] == "confidence"
    else:
        assert "confidence" not in result
        assert result["warnings"] == ["confidence grading returned an unparseable reply"]
    assert run["files"]["run.json"]["confidence"] is True


def test_confidence_failure_is_a_warning_parity(tmp_path):
    snap = both(tmp_path, lambda s, d: _base(s, d, "--confidence", "--json", QUESTION),
                fail=lambda preset, prompt: GRADE_MARK in prompt)
    assert snap["rc"] == 0
    assert snap["out"]["warnings"] == ["confidence grading failed: j refused the query"]


@pytest.mark.parametrize("how", ["flag", "file"])
def test_system_prompt_parity(tmp_path, how):
    sys_file = tmp_path / "system.txt"
    sys_file.write_text("Answer as a storage engineer.\n")
    flag = (["--system", "Answer as a storage engineer."] if how == "flag"
            else ["--system-file", str(sys_file)])
    snap = both(tmp_path, lambda s, d: _base(s, d, *flag, QUESTION))
    assert snap["rc"] == 0
    systems = {c[0]: c[1] for c in snap["calls"]}
    assert systems == {"gpu:a": "Answer as a storage engineer.",
                       "gpu:b": "Answer as a storage engineer.", "gpu:j": None}
    (run,) = snap["runs"]
    assert run["files"]["run.json"]["system"] == "Answer as a storage engineer."


def test_continue_chained_twice_parity(tmp_path):
    def chain(scheme):
        data = str(tmp_path / scheme)
        fakes_all = []
        for i, q in enumerate(("first question", "second question", "third question")):
            argv = _base(scheme, data, q)
            if i:
                runs = sorted(os.listdir(data), key=lambda r: os.stat(
                    os.path.join(data, r, "run.json")).st_mtime_ns)
                argv += ["--continue", runs[-1]]
            rc, out, err, fakes = _invoke(scheme, argv)
            assert rc == 0, err
            fakes_all += fakes.calls
        return {"calls": sorted(fakes_all, key=lambda c: (c[0], c[2])),
                "runs": _run_dirs(data)}

    tpu, gpu = chain("tpu"), chain("gpu")
    assert gpu == tpu
    histories = [r["files"]["result.json"].get("history", []) for r in gpu["runs"]]
    assert [[h["prompt"] for h in hist] for hist in histories] == [
        [], ["first question"], ["first question", "second question"]]
    third = gpu["runs"][2]
    assert third["files"]["run.json"]["history"] == histories[2]
    assert third["files"]["prompt.txt"] == "third question"
    # Panel and judge see the folded conversation.
    folded = {c[0]: c[2] for c in gpu["calls"] if "third question" in c[2]}
    assert sorted(folded) == ["gpu:a", "gpu:b", "gpu:j"]
    assert all(folded[m].startswith("Earlier exchanges in this conversation:\n\n[User]\n"
                                    "first question") for m in ("gpu:a", "gpu:b"))
    assert "Earlier exchanges in this conversation:" in folded["gpu:j"]


def _resume_both(tmp_path, prepare, fail_first=None, resume_flags=(), first_flags=()):
    """A run auto-saved through each CLI, ``prepare(run_dir)`` (delete files
    as a crash would leave them), then ``--resume`` of it; returns the gpu
    snapshot of the resume after asserting it equals the tpu one."""
    snaps = {}
    for scheme in SCHEMES:
        data = str(tmp_path / scheme)
        rc, _, err, _ = _invoke(scheme, _base(scheme, data, *first_flags, QUESTION),
                                fail=fail_first)
        assert rc == 0, err
        (run_id,) = os.listdir(data)
        prepare(os.path.join(data, run_id))
        rc, out, err, fakes = _invoke(scheme, ["--data-dir", data, "--resume", run_id,
                                               *resume_flags])
        snaps[scheme] = _snapshot(rc, out, err.replace(run_id, "RUN_ID"), fakes, data)
    assert snaps["gpu"] == snaps["tpu"]
    return snaps["gpu"]


def test_resume_reuses_the_journal_parity(tmp_path):
    def crash(run_dir):
        os.remove(os.path.join(run_dir, "result.json"))
        (answer_b,) = [n for n in os.listdir(os.path.join(run_dir, "panel"))
                       if n.endswith("_b.json")]
        os.remove(os.path.join(run_dir, "panel", answer_b))

    snap = _resume_both(tmp_path, crash)
    assert snap["rc"] == 0
    # Only the deleted answer reruns, then the judge.
    assert [c[0] for c in snap["calls"]] == ["gpu:b", "gpu:j"]
    (run,) = snap["runs"]
    assert [n for n, _ in run["panel"]] == ["000-gpu_a.json", "001-gpu_b.json"]
    assert run["listing"] == ["consensus.md", "panel", "prompt.txt", "result.json", "run.json"]


def test_resume_takes_the_manifest_identity_parity(tmp_path):
    """A resumed run keeps the saved run's rounds, confidence, system
    prompt and token budget: none of them is on the resume's argv."""
    def crash(run_dir):
        os.remove(os.path.join(run_dir, "result.json"))

    snap = _resume_both(tmp_path, crash, first_flags=(
        "--rounds", "2", "--confidence", "--system", "be brief", "--max-tokens", "5"))
    assert snap["rc"] == 0
    assert sum(CRITIQUE_MARK in c[2] for c in snap["calls"]) == 2
    assert sum(GRADE_MARK in c[2] for c in snap["calls"]) == 1
    assert {c[1] for c in snap["calls"] if c[0] != "gpu:j"} == {"be brief"}
    (run,) = snap["runs"]
    assert run["files"]["result.json"]["confidence"]["score"] == 72


def test_resume_reruns_only_the_failed_models_parity(tmp_path):
    def crash(run_dir):
        os.remove(os.path.join(run_dir, "result.json"))

    snap = _resume_both(tmp_path, crash, fail_first=lambda preset, prompt: preset == "b")
    assert snap["rc"] == 0
    assert [c[0] for c in snap["calls"]] == ["gpu:b", "gpu:j"]
    (run,) = snap["runs"]
    result = run["files"]["result.json"]
    assert [r["model"] for r in result["responses"]] == ["gpu:a", "gpu:b"]
    assert "failed_models" not in result


def test_resume_refuses_a_completed_run_parity(tmp_path):
    snap = _resume_both(tmp_path, lambda run_dir: None)
    assert snap["rc"] == 1 and snap["calls"] == []
    assert "already completed (result.json exists); use --continue" in snap["err"]


@pytest.mark.parametrize("flags", [["--models", "gpu:x"], ["--judge=gpu:x", "--rounds", "2"],
                                   ["--system", "s", "--max-tokens", "3", "--confidence"]],
                         ids=["models", "judge-rounds", "system-max-tokens-confidence"])
def test_resume_refuses_identity_flags_parity(tmp_path, flags):
    snap = _resume_both(tmp_path, lambda run_dir: os.remove(
        os.path.join(run_dir, "result.json")), resume_flags=flags)
    assert snap["rc"] == 1 and snap["calls"] == []
    assert snap["err"].startswith("error: --resume takes ")
    assert "from the saved run's manifest" in snap["err"]


def test_interactive_session_parity(tmp_path):
    def script(scheme):
        return "\n".join([
            "first question",
            f"/models +{scheme}:c",
            "second question",
            f"/judge {scheme}:k",
            f"/models -{scheme}:a -{scheme}:b",
            "boom question",
            "third question",
            "/models",
            "/reset",
            "/unknown",
            f"/models -{scheme}:c",
            "fourth question",
            "/exit",
            "never reached",
        ]) + "\n"

    snap = both(tmp_path, lambda s, d: _base(s, d, "-i"), stdin_of=script,
                fail=lambda preset, prompt: prompt.endswith("boom question"))
    assert snap["rc"] == 0
    assert "error: running queries: all models failed" in snap["err"]
    assert "unknown command '/unknown'" in snap["err"]
    assert "cannot remove the last panel model" in snap["err"]
    assert "never reached" not in json.dumps(snap["calls"])
    runs = snap["runs"]
    # The failed query left a run directory without result.json.
    prompts = [r["files"]["run.json"]["prompt"] for r in runs]
    assert prompts == ["first question", "second question", "boom question",
                       "third question", "fourth question"]
    results = [r["files"].get("result.json") for r in runs]
    assert results[2] is None
    assert [len(r["history"]) if "history" in r else 0 for r in results if r] == [0, 1, 2, 0]
    assert [r["judge"] for r in results if r] == ["gpu:j", "gpu:j", "gpu:k", "gpu:k"]
    assert [len(r["responses"]) for r in results if r] == [2, 3, 1, 1]


def test_sigint_ends_an_interactive_session(tmp_path):
    """SIGINT while the session waits for a line ends it with exit 0."""
    import signal

    class Blocking(io.StringIO):
        def readline(self, *a):
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(5)
            return "never\n"

    fakes = Fakes("gpu")
    before = signal.getsignal(signal.SIGINT)
    t0 = time.monotonic()
    rc = port_main(["--models", "gpu:a", "-i", "--data-dir", str(tmp_path)],
                   factory=fakes.factory, stdin=Blocking(), stdout=io.StringIO(),
                   stderr=io.StringIO(), install_signal_handlers=False)
    assert rc == 0 and time.monotonic() - t0 < 4 and fakes.calls == []
    assert signal.getsignal(signal.SIGINT) is before


# -- flag errors: each message the JAX CLI's -----------------------------------

FLAG_ERRORS = {
    "no models": ["q"],
    "vote without options": ["--models", "{s}:a", "--vote", "q"],
    "vote with one option": ["--models", "{s}:a", "--vote", "--options", "A", "q"],
    "options without vote": ["--models", "{s}:a", "--options", "A,B", "q"],
    "rounds below 1": ["--models", "{s}:a", "--rounds", "0", "q"],
    "vote and rounds": ["--models", "{s}:a", "--vote", "--options", "A,B", "--rounds", "2",
                        "q"],
    "vote and confidence": ["--models", "{s}:a", "--vote", "--options", "A,B",
                            "--confidence", "q"],
    "system and system-file": ["--models", "{s}:a", "--system", "x", "--system-file",
                               "{sysfile}", "q"],
    "missing system-file": ["--models", "{s}:a", "--system-file", "{d}/none.txt", "q"],
    "resume and prompt": ["--resume", "r1", "q"],
    "resume and file": ["--resume", "r1", "--file", "{sysfile}"],
    "resume and interactive": ["--resume", "r1", "-i"],
    "resume and continue": ["--resume", "r1", "--continue", "r0"],
    "resume and output": ["--resume", "r1", "--output", "{d}/o.json"],
    "resume and json": ["--resume", "r1", "--json"],
    "resume and no-save": ["--resume", "r1", "--no-save"],
    "resume and identity flags": ["--resume", "r1", "-models", "{s}:a", "--vote",
                                  "--options=A,B", "-rounds=1"],
    "resume of a missing run": ["--resume", "r1", "--data-dir", "{d}"],
    "interactive and prompt": ["--models", "{s}:a", "-i", "hello"],
    "interactive and file": ["--models", "{s}:a", "--interactive", "--file", "{sysfile}"],
    "interactive and output": ["--models", "{s}:a", "-interactive", "--output", "x.json"],
    "continue of a missing run": ["--models", "{s}:a", "--data-dir", "{d}", "--continue",
                                  "nope", "q"],
}


@pytest.mark.parametrize("case", sorted(FLAG_ERRORS))
def test_flag_errors_say_what_jax_says(tmp_path, case):
    sysfile = tmp_path / "system.txt"
    sysfile.write_text("x")
    errs = {}
    for scheme in SCHEMES:
        argv = [a.format(s=scheme, d=tmp_path, sysfile=sysfile) for a in FLAG_ERRORS[case]]
        rc, out, err, fakes = _invoke(scheme, argv)
        assert rc == 1 and out == "" and not fakes.calls, (scheme, err)
        errs[scheme] = _norm(err)
    assert errs["gpu"] == errs["tpu"]
    assert errs["gpu"].startswith("error: ") and errs["gpu"].count("\n") == 1


# -- the config file and aliases ---------------------------------------------

CONFIGS = {
    # name: (config document or raw text, argv, expectation)
    "defaults and aliases": ({"models": "@panel", "judge": "{s}:j", "timeout": 7,
                              "rounds": 2, "confidence": True,
                              "aliases": {"@panel": "{s}:a, {s}:b", "@solo": "{s}:c"}},
                             ["--json", "q"], 0),
    "flags beat the config": ({"models": "@panel", "judge": "{s}:j",
                               "aliases": {"@panel": "{s}:a,{s}:b", "@solo": "{s}:c"}},
                              ["--models", "@solo", "--judge", "{s}:k", "--json", "q"], 0),
    "alias overlap keeps duplicates": ({"aliases": {"@x": "{s}:a,{s}:b", "@y": "{s}:b,{s}:c"}},
                                       ["--models", "@x,@y", "--judge", "{s}:j", "--json",
                                        "q"], 0),
    "judge alias of one model": ({"aliases": {"@boss": "{s}:k"}},
                                 ["--models", "{s}:a,{s}:b", "--judge", "@boss", "--json",
                                  "q"], 0),
    "judge alias of two models": ({"aliases": {"@two": "{s}:k,{s}:l"}},
                                  ["--models", "{s}:a", "--judge", "@two", "q"], 1),
    "unknown alias": ({"aliases": {"@a": "{s}:a"}}, ["--models", "@nope", "q"], 1),
    "unknown key": ({"modles": "typo"}, ["--models", "{s}:a", "q"], 1),
    "not an object": (["{s}:a"], ["--models", "{s}:a", "q"], 1),
    "broken json": ("{broken", ["--models", "{s}:a", "q"], 1),
    "rounds as a string": ({"rounds": "2"}, ["--models", "{s}:a", "q"], 1),
    "timeout as a bool": ({"timeout": True}, ["--models", "{s}:a", "q"], 1),
    "models as a list": ({"models": ["{s}:a"]}, ["q"], 1),
    "confidence as a string": ({"confidence": "yes"}, ["--models", "{s}:a", "q"], 1),
    "aliases as a list": ({"aliases": ["@a"]}, ["--models", "{s}:a", "q"], 1),
    "disabled by LLMC_CONFIG=0": ("{broken", ["--models", "{s}:a", "--judge", "{s}:j",
                                              "--json", "q"], 0),
    "missing explicit path": (None, ["--models", "{s}:a", "q"], 1),
    "version with a broken config": ("{broken", ["--version"], 0),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_file_cases(tmp_path, monkeypatch, case):
    doc, argv, want_rc = CONFIGS[case]
    snaps = {}
    for scheme in SCHEMES:
        path = tmp_path / f"{scheme}.json"
        if isinstance(doc, str):
            path.write_text(doc)
        elif doc is not None:
            path.write_text(json.dumps(doc).replace("{s}", scheme))
        env = "0" if case.startswith("disabled") else str(path)
        if doc is None:
            env = str(tmp_path / "typo.json")
        monkeypatch.setenv("LLMC_CONFIG", env)
        rc, out, err, fakes = _invoke(scheme, [a.format(s=scheme) for a in argv])
        snaps[scheme] = _snapshot(rc, out.replace("llm-consensus-torch", "llm-consensus"),
                                  err.replace(str(path), "CONFIG"), fakes)
    assert snaps["gpu"] == snaps["tpu"]
    snap = snaps["gpu"]
    assert snap["rc"] == want_rc, snap["err"]
    if case == "defaults and aliases":
        assert [r["model"] for r in snap["out"]["responses"]] == ["gpu:a", "gpu:b"]
        assert snap["out"]["judge"] == "gpu:j" and snap["out"]["confidence"]["score"] == 72
        assert len([c for c in snap["calls"] if CRITIQUE_MARK in c[2]]) == 2
    if case == "alias overlap keeps duplicates":
        assert [r["model"] for r in snap["out"]["responses"]] == [
            "gpu:a", "gpu:b", "gpu:b", "gpu:c"]
    if case == "version with a broken config":
        assert snap["out"].startswith("llm-consensus 0.1.0\n  commit: ")


def test_version_prints_the_port_prog(monkeypatch, tmp_path):
    (tmp_path / "c.json").write_text("{broken")
    monkeypatch.setenv("LLMC_CONFIG", str(tmp_path / "c.json"))
    stdout = io.StringIO()
    assert port_main(["--version"], stdout=stdout, stderr=io.StringIO(),
                     install_signal_handlers=False) == 0
    from llm_consensus_tpu_torch.version import __commit__, __date__, __version__

    assert stdout.getvalue() == (f"llm-consensus-torch {__version__}\n  commit: {__commit__}"
                                 f"\n  built:  {__date__}\n")


def test_config_draft_is_refused_by_the_port(tmp_path, monkeypatch):
    """The JAX key set includes ``draft``; the port has no --draft, so a
    config file that sets it fails instead of being ignored."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"draft": "lookup", "models": "gpu:a"}))
    monkeypatch.setenv("LLMC_CONFIG", str(path))
    rc, out, err, fakes = _invoke("gpu", ["q"])
    assert rc == 1 and not fakes.calls and not fakes.built
    assert err == (f"error: config file {path}: 'draft' sets --draft, which is not in the "
                   "PyTorch port yet; remove the key\n")


def test_config_search_order(tmp_path, monkeypatch):
    """Unset LLMC_CONFIG searches ./.llm-consensus.json, then the home
    directory's."""
    home = tmp_path / "home"
    home.mkdir()
    (home / ".llm-consensus.json").write_text(json.dumps({"judge": "gpu:home"}))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(work)
    monkeypatch.delenv("LLMC_CONFIG")
    assert cli_mod.load_config_file()[0] == {"judge": "gpu:home"}
    (work / ".llm-consensus.json").write_text(json.dumps({"judge": "gpu:here"}))
    assert cli_mod.load_config_file() == ({"judge": "gpu:here"}, ".llm-consensus.json")


# -- real engines on the CPU -----------------------------------------------------


class Counting:
    """A provider proxy that records each query (model, prompt, reply) and
    lets panel workers answer in worker order (``_wait_turn``), so each
    CLI's sequence of queries is deterministic."""

    def __init__(self, inner, seen: list):
        self._inner, self._seen = inner, seen

    def prepare(self, models, judge):
        return self._inner.prepare(models, judge)

    def query(self, ctx, req):
        return self.query_stream(ctx, req, None)

    def query_stream(self, ctx, req, callback):
        _wait_turn()
        resp = self._inner.query_stream(ctx, req, callback)
        self._seen.append((_norm(req.model), _provider_norm(req.prompt), resp.content))
        return resp


MODE_FLAGS = {"rounds 2 confidence": ["--rounds", "2", "--confidence"],
              "vote": ["--vote", "--options", "A,B,C"]}


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Both CLIs, auto-saving, over the synthetic HF checkpoints of
    tiny-llama and tiny-qwen2, in each mode; returns the run directory and
    the queries per (mode, scheme)."""
    from llm_consensus_tpu.cli.main import create_provider as jax_create
    from llm_consensus_tpu.models import get_config as jax_config
    from llm_consensus_tpu.providers.tpu import TPUProvider
    from llm_consensus_tpu_torch.cli.main import create_provider as port_create
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from tests.test_hf_golden import _make_hf_checkpoint

    root = tmp_path_factory.mktemp("modes-engines")
    for seed, preset in enumerate(("tiny-llama", "tiny-qwen2")):
        _make_hf_checkpoint(jax_config(preset), str(root / "ckpt" / preset), seed=seed)
    out = {}
    saved = TPUProvider._shared
    before = dict(GPUProvider._shared)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLMC_CONFIG", "0")
        mp.setenv("LLMC_CHECKPOINT_DIR", str(root / "ckpt"))
        TPUProvider._shared = None
        try:
            for mode, flags in MODE_FLAGS.items():
                for scheme in SCHEMES:
                    seen: list = []
                    if scheme == "tpu":
                        entry, make = jax_main, jax_create
                    else:
                        entry, make = port_main, lambda m: port_create(m, "cpu")
                    data = root / mode.replace(" ", "-") / scheme
                    stderr = io.StringIO()
                    rc = entry(["--models", f"{scheme}:tiny-llama,{scheme}:tiny-qwen2",
                                "--judge", f"{scheme}:tiny-llama", "--max-tokens", "6",
                                "--data-dir", str(data), *flags, "what is consensus?"],
                               factory=lambda m, seen=seen, make=make: Counting(make(m), seen),
                               stdin=io.StringIO(""), stdout=io.StringIO(), stderr=stderr,
                               install_signal_handlers=False)
                    assert rc == 0, stderr.getvalue()
                    (run_dir,) = list(data.iterdir())
                    out[mode, scheme] = (run_dir, seen)
        finally:
            TPUProvider._shared = saved
            for key, provider in list(GPUProvider._shared.items()):
                if key not in before:
                    provider.release()
                    del GPUProvider._shared[key]
    return out


_ENGINE_STATS = ("latency_ms", "tokens", "tokens_per_sec", "mfu", "mbu")


def _provider_norm(text: str) -> str:
    """The real engines' providers also carry the scheme's name ("tpu",
    "gpu") in each response and in the judge's separator lines."""
    return _norm(text).replace("| Provider: tpu ---", "| Provider: gpu ---").replace(
        '"provider": "tpu"', '"provider": "gpu"')


def _without_stats(doc):
    if isinstance(doc, dict):
        return {k: _without_stats(v) for k, v in doc.items() if k not in _ENGINE_STATS}
    if isinstance(doc, list):
        return [_without_stats(v) for v in doc]
    return doc


@pytest.mark.parametrize("mode", sorted(MODE_FLAGS))
def test_real_engines_follow_the_jax_cli(engine_runs, mode):
    """The same queries in the same order, each prompt byte-identical for as
    long as the engines' replies before it agree; where every reply agrees,
    the same result.json."""
    (jax_dir, jax_seen), (dir_, seen) = engine_runs[mode, "tpu"], engine_runs[mode, "gpu"]
    assert sorted(os.listdir(dir_)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(dir_ / "panel")) == len(os.listdir(jax_dir / "panel")) == 2
    doc = json.loads((dir_ / "result.json").read_text())
    jax_doc = json.loads(_provider_norm((jax_dir / "result.json").read_text()))
    assert list(doc) == list(jax_doc)
    for got, want in zip(doc["responses"], jax_doc["responses"]):
        assert list(got) == list(want)
    # Panel 2, then judge 1; --rounds 2 adds a critique (2) and a refine
    # (1), --confidence a grading (1).
    want = ["gpu:tiny-llama", "gpu:tiny-qwen2"]
    if mode != "vote":
        want += ["gpu:tiny-llama", "gpu:tiny-llama", "gpu:tiny-qwen2", "gpu:tiny-llama",
                 "gpu:tiny-llama"]
    assert [m for m, _, _ in seen] == [m for m, _, _ in jax_seen] == want
    assert json.loads((dir_ / "run.json").read_text()) == json.loads(
        _norm((jax_dir / "run.json").read_text()))
    agreed = True
    for (_, prompt, reply), (_, jax_prompt, jax_reply) in zip(seen, jax_seen):
        assert prompt == jax_prompt
        if reply != jax_reply:
            agreed = False
            break
    if agreed:
        assert _without_stats(doc) == _without_stats(jax_doc)
    if mode == "vote":
        assert doc["judge"] == "vote"


# -- the prompts, byte for byte ----------------------------------------------------


def test_critique_and_refine_prompts_byte_identical_to_jax():
    for prompt, draft in (("the user's {prompt}?", "draft {draft}\nline"), ("", ""),
                          ("ünïcode — q", "— d")):
        assert (render_critique_prompt(prompt, draft).encode()
                == jax_judge.render_critique_prompt(prompt, draft).encode())
        assert (render_refine_prompt(prompt, draft).encode()
                == jax_judge.render_refine_prompt(prompt, draft).encode())
    from llm_consensus_tpu.consensus import confidence as jconf
    from llm_consensus_tpu.consensus import vote as jvote

    responses = [("gpu:a", "first\nanswer"), ("gpu:b", "ünïcode")]
    assert render_confidence_prompt("q", [Response(m, c, "gpu") for m, c in responses],
                                    "c").encode() == jconf.render_confidence_prompt(
        "q", [JaxResponse(m, c, "gpu") for m, c in responses], "c").encode()
    assert (render_vote_prompt("pick {one}", ["X", "Y z"]).encode()
            == jvote.render_vote_prompt("pick {one}", ["X", "Y z"]).encode())


# -- unit copies of tests/test_vote.py ---------------------------------------------


def _resp(model, content):
    return Response(model, content, "fake", 1.0)


def run_cli(argv, stdin_text="", factory=None):
    stdout, stderr = io.StringIO(), io.StringIO()
    if factory is None:
        def factory(model):
            return ProviderFunc(lambda ctx, req: Response(req.model, "A", "fake", 1.0))
    code = port_main(argv, factory=factory, stdin=io.StringIO(stdin_text), stdout=stdout,
                     stderr=stderr, install_signal_handlers=False)
    return code, stdout.getvalue(), stderr.getvalue()


def test_parse_vote_first_line_exact():
    assert parse_vote("B\nbecause reasons", ["A", "B", "C"]) == "B"
    assert parse_vote("- C.\nexplanation", ["A", "B", "C"]) == "C"


def test_parse_vote_last_mention_fallback():
    assert parse_vote("While A is popular, B is the better fit.", ["A", "B"]) == "B"
    assert parse_vote("B is tempting, but in the end A wins.", ["A", "B"]) == "A"
    assert parse_vote("no option mentioned", ["A", "B"]) is None


def test_parse_vote_whole_word_only():
    assert parse_vote("B it is. Apples are nice.", ["A", "B"]) == "B"


def test_tally_plurality_and_tie_break():
    r = tally_votes([_resp("m1", "A"), _resp("m2", "B"), _resp("m3", "A")], ["A", "B"])
    assert r.winner == "A" and r.counts == {"A": 2, "B": 1}
    tie = tally_votes([_resp("m1", "B"), _resp("m2", "A")], ["A", "B"])
    assert tie.winner == "A"  # option order breaks ties


def test_tally_unparsed_recorded():
    r = tally_votes([_resp("m1", "hmm"), _resp("m2", "B")], ["A", "B"])
    assert r.winner == "B"
    assert r.unparsed == ["m1"]
    assert "(no vote parsed): m1" in r.summary()


def test_render_vote_prompt_lists_options():
    p = render_vote_prompt("pick one", ["X", "Y"])
    assert "pick one" in p and "- X" in p and "- Y" in p


def _vote_factory(model: str):
    choice = {"m1": "A", "m2": "B", "m3": "A"}.get(model, "A")
    return ProviderFunc(lambda ctx, req, c=choice: Response(req.model, c, "fake", 1.0))


def test_cli_vote_mode_tallies_without_judge():
    code, out, err = run_cli(["--models", "m1,m2,m3", "--vote", "--options", "A,B", "--json",
                              "ask"], factory=_vote_factory)
    assert code == 0, err
    data = json.loads(out)
    assert data["judge"] == "vote"
    assert data["consensus"].startswith("A")
    assert "A: 2" in data["consensus"] and "B: 1" in data["consensus"]


def test_cli_vote_requires_options():
    code, _, err = run_cli(["--models", "m1", "--vote", "ask"])
    assert code == 1 and "--vote requires --options" in err


def test_cli_options_without_vote_rejected():
    code, _, err = run_cli(["--models", "m1", "--options", "A,B", "ask"])
    assert code == 1 and "--options only applies with --vote" in err


def test_cli_vote_skips_judge_provider():
    built = []

    def factory(model):
        built.append(model)
        return _vote_factory(model)

    code, out, _ = run_cli(["--models", "m1,m2", "--vote", "--options", "A,B", "--json", "q"],
                           factory=factory)
    assert code == 0
    assert set(built) == {"m1", "m2"}  # no default judge


def test_cli_multi_round_refines():
    judge_prompts = []

    def factory(model):
        if model == "j":
            def judge_fn(ctx, req):
                judge_prompts.append(req.prompt)
                return Response(req.model, f"draft-v{len(judge_prompts)}", "fake", 1.0)
            return ProviderFunc(judge_fn)
        return ProviderFunc(lambda ctx, req: Response(
            req.model, "critique!" if "Draft answer" in req.prompt else "answer", "fake", 1.0))

    code, out, err = run_cli(["--models", "m1,m2", "--judge", "j", "--rounds", "2", "--json",
                              "q"], factory=factory)
    assert code == 0, err
    data = json.loads(out)
    assert data["consensus"] == "draft-v2"
    assert len(judge_prompts) == 2
    assert "draft-v1" in judge_prompts[1]
    assert "critique!" in judge_prompts[1]
    assert all(r["content"] == "answer" for r in data["responses"])


def test_cli_vote_rounds_mutually_exclusive():
    code, _, err = run_cli(["--models", "m1", "--vote", "--options", "A,B", "--rounds", "2",
                            "q"])
    assert code == 1 and "mutually exclusive" in err


def test_cli_rounds_must_be_positive():
    code, _, err = run_cli(["--models", "m1", "--rounds", "0", "q"])
    assert code == 1 and "--rounds must be >= 1" in err


def test_cli_round_failure_keeps_prior_consensus():
    def factory(model):
        if model == "j":
            return ProviderFunc(lambda ctx, req: Response(req.model, "draft-v1", "fake", 1.0))

        def panel_fn(ctx, req):
            if "Draft answer" in req.prompt:
                raise RuntimeError("panel exploded in round 2")
            return Response(req.model, "answer", "fake", 1.0)

        return ProviderFunc(panel_fn)

    code, out, err = run_cli(["--models", "m1", "--judge", "j", "--rounds", "2", "--json",
                              "q"], factory=factory)
    assert code == 0, err
    data = json.loads(out)
    assert data["consensus"] == "answer"
    assert any("round 2 critique failed" in w for w in data.get("warnings", []))


def test_cli_vote_with_gpu_judge_builds_no_judge():
    built = []

    def factory(model):
        built.append(model)
        return _vote_factory(model)

    code, out, _ = run_cli(["--models", "m1,m2", "--vote", "--options", "A,B", "--judge",
                            "gpu:llama-3-8b", "--json", "q"], factory=factory)
    assert code == 0
    assert json.loads(out)["judge"] == "vote" and "gpu:llama-3-8b" not in built


# -- unit copies of tests/test_confidence.py -----------------------------------------


def test_render_prompt_embeds_everything():
    text = render_confidence_prompt(
        "the question", [_resp("m1", "answer one"), _resp("m2", "answer two")],
        "the consensus")
    assert "the question" in text
    assert "--- Model: m1 | Provider: fake ---" in text
    assert "answer one" in text and "answer two" in text
    assert "the consensus" in text
    assert "CONFIDENCE:" in text


def test_parse_well_formed():
    c = parse_confidence("CONFIDENCE: 82\nCONTROVERSY:\n- models disagreed on X\n- and on Y\n")
    assert c.score == 82
    assert c.controversy == ["models disagreed on X", "and on Y"]


def test_parse_none_controversy_and_clamping():
    c = parse_confidence("CONFIDENCE: 250\nCONTROVERSY: none\n")
    assert c.score == 100
    assert c.controversy == []


def test_parse_tolerates_surrounding_prose_and_stops_list():
    c = parse_confidence("Here is my grading.\nCONFIDENCE: 55\nCONTROVERSY:\n"
                         "- point one\nSome trailing commentary.\n- not a controversy point\n")
    assert c.score == 55
    assert c.controversy == ["point one"]


def test_parse_garbage_returns_none_score():
    c = parse_confidence("I feel pretty good about this one!")
    assert c.score is None
    assert c.controversy == []


def test_grade_confidence_queries_judge():
    seen = {}

    def judge(ctx, req: Request):
        seen["prompt"] = req.prompt
        return Response(req.model, "CONFIDENCE: 64\nCONTROVERSY: none", "fake", 1.0)

    c = grade_confidence(Context.background(), ProviderFunc(judge), "j", "q",
                         [_resp("m1", "a"), _resp("m2", "b")], "the consensus")
    assert c.score == 64
    assert "the consensus" in seen["prompt"]


def _grading_factory(grade_reply):
    def factory(model):
        def fn(ctx, req: Request):
            if "CONFIDENCE" in req.prompt:
                return Response(req.model, grade_reply, "fake", 1.0)
            return Response(req.model, f"ans-{req.model}", "fake", 1.0)
        return ProviderFunc(fn)
    return factory


def _run_graded(argv, grade_reply="CONFIDENCE: 77\nCONTROVERSY:\n- scope of X\n"):
    return run_cli(argv, factory=_grading_factory(grade_reply))


def test_cli_confidence_in_json_result():
    code, out, _ = _run_graded(["--models", "m1,m2", "--judge", "j", "--json", "--confidence",
                                "q"])
    assert code == 0
    assert json.loads(out)["confidence"] == {"score": 77, "controversy": ["scope of X"]}


def test_cli_without_flag_omits_confidence():
    code, out, _ = _run_graded(["--models", "m1,m2", "--judge", "j", "--json", "q"])
    assert code == 0
    assert "confidence" not in json.loads(out)


def test_cli_unparseable_grading_warns_not_fails():
    code, out, _ = _run_graded(["--models", "m1,m2", "--judge", "j", "--json", "--confidence",
                                "q"], grade_reply="no structured grade here")
    assert code == 0
    result = json.loads(out)
    assert "confidence" not in result
    assert any("unparseable" in w for w in result.get("warnings", []))


def test_cli_vote_and_confidence_exclusive():
    code, _, err = _run_graded(["--models", "m1,m2", "--vote", "--options", "a,b",
                                "--confidence", "q"])
    assert code == 1
    assert "mutually exclusive" in err


def test_config_file_confidence_default(tmp_path, monkeypatch):
    cfgp = tmp_path / "conf.json"
    cfgp.write_text(json.dumps({"confidence": True}))
    monkeypatch.setenv("LLMC_CONFIG", str(cfgp))
    code, out, _ = _run_graded(["--models", "m1,m2", "--judge", "j", "--json", "q"])
    assert code == 0
    assert json.loads(out)["confidence"]["score"] == 77


def test_single_response_panel_still_grades():
    code, out, _ = _run_graded(["--models", "m1", "--judge", "j", "--json", "--confidence",
                                "q"])
    assert code == 0
    assert json.loads(out)["confidence"]["score"] == 77


def test_judge_single_response_passthrough_in_refine_rounds():
    """One panel model: each round's judge passes the critique through with
    no judge query, as in the JAX CLI."""
    judge_calls = []

    def factory(model):
        def fn(ctx, req):
            if model == "j":
                judge_calls.append(req.prompt)
            return Response(req.model, f"{model}:{len(req.prompt)}", "fake", 1.0)
        return ProviderFunc(fn)

    code, out, err = run_cli(["--models", "m1", "--judge", "j", "--rounds", "3", "--json",
                              "q"], factory=factory)
    assert code == 0, err
    assert judge_calls == []
    assert json.loads(out)["consensus"].startswith("m1:")


def test_prepare_failure_names_what_the_port_prepares():
    """A divergence kept on purpose: the JAX CLI reports a provider whose
    ``prepare`` fails as "planning device placement" (its provider carves
    mesh slices there); the port's ``prepare`` builds the CUDA kernels, and
    says "preparing provider"."""
    class Failing(ProviderFunc):
        def prepare(self, models, judge):
            raise RuntimeError("nvcc failed")

    class JaxFailing(JaxProviderFunc):
        def prepare(self, models, judge):
            raise RuntimeError("nvcc failed")

    errs = {}
    for scheme, cls in (("tpu", JaxFailing), ("gpu", Failing)):
        stderr = io.StringIO()
        entry = jax_main if scheme == "tpu" else port_main
        rc = entry(["--models", f"{scheme}:a", "--judge", f"{scheme}:j", "--json", "q"],
                   factory=lambda m, cls=cls: cls(lambda ctx, req: None),
                   stdin=io.StringIO(""), stdout=io.StringIO(), stderr=stderr,
                   install_signal_handlers=False)
        assert rc == 1
        errs[scheme] = stderr.getvalue()
    assert errs == {"tpu": "error: planning device placement: nvcc failed\n",
                    "gpu": "error: preparing provider: nvcc failed\n"}
