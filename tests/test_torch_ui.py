"""The port's TTY UI (``llm_consensus_tpu_torch/ui/``): unit copies of the
JAX package's ``tests/test_ui.py`` against the port's modules, the printers
byte for byte against the JAX ones, and the pretty terminal output of both
CLIs in each consensus mode."""

import importlib
import io
import re
import time

import pytest

from llm_consensus_tpu import ui as jax_ui
from llm_consensus_tpu_torch import ui
from llm_consensus_tpu_torch.providers import Response
from llm_consensus_tpu_torch.ui import (
    ModelStatus,
    Progress,
    print_consensus,
    print_header,
    print_model_response,
    print_summary,
)
from llm_consensus_tpu_torch.ui.progress import spinner, truncate

# -- unit copies of tests/test_ui.py ----------------------------------------------


def test_truncate():
    assert truncate("hello", 10) == "hello"
    assert truncate("a\nb\nc", 10) == "a b c"
    assert truncate("x" * 30, 10) == "x" * 9 + "…"
    assert truncate("  padded  ", 10) == "padded"


def test_spinner_cycles_all_frames():
    frames = {spinner(t / 10.0) for t in range(10)}
    assert len(frames) == 10


def test_state_machine_transitions():
    buf = io.StringIO()
    p = Progress(buf, ["m1", "m2"], quiet=True)
    assert p._models["m1"].status is ModelStatus.PENDING
    p.model_started("m1")
    assert p._models["m1"].status is ModelStatus.RUNNING
    p.model_streaming("m1", "hello world!")  # 12 chars → 3 tokens
    assert p._models["m1"].status is ModelStatus.STREAMING
    assert p._models["m1"].token_est == 3
    p.model_completed("m1")
    assert p._models["m1"].status is ModelStatus.COMPLETE
    p.model_failed("m2", RuntimeError("nope"))
    assert p._models["m2"].status is ModelStatus.FAILED


def test_token_estimate_accumulates_chars_div_4():
    p = Progress(io.StringIO(), ["m"], quiet=True)
    for _ in range(10):
        p.model_streaming("m", "abcdefgh")  # 80 chars total
    assert p._models["m"].token_est == 20


def test_unknown_model_updates_ignored():
    p = Progress(io.StringIO(), ["m"], quiet=True)
    p.model_started("ghost")  # must not raise
    p.model_streaming("ghost", "x")
    p.model_completed("ghost")


def test_render_paints_and_clears():
    buf = io.StringIO()
    p = Progress(buf, ["model-a"], quiet=False)
    p.start()
    p.model_started("model-a")
    p.model_streaming("model-a", "some output text")
    time.sleep(0.25)  # let the 100 ms repaint loop run a few frames
    p.stop()
    out = buf.getvalue()
    assert "Querying 1 models" in out
    assert "model-a" in out
    assert "\033[A\033[K" in out  # cursor-up + clear-line repaint
    assert "streaming ~4 tokens" in out


def test_quiet_progress_writes_nothing():
    buf = io.StringIO()
    p = Progress(buf, ["m"], quiet=True)
    p.start()
    p.model_started("m")
    p.stop()
    assert buf.getvalue() == ""


def test_printers_shapes():
    buf = io.StringIO()
    print_header(buf, "what is the answer to everything?" * 5)
    print_model_response(buf, "m1", "prov", "line1\nline2", 1500.0)
    print_consensus(buf, "the answer")
    print_summary(buf, 3, 2, 1, 12.34)
    out = buf.getvalue()
    assert "LLM Consensus" in out
    assert "m1 (prov) [1.5s]" in out
    assert "│\033[0m line1" in out and "│\033[0m line2" in out
    assert "CONSENSUS" in out and "║\033[0m the answer" in out
    assert "Models queried: 3" in out and "2 succeeded" in out and "1 failed" in out
    assert "Total time: 12.3s" in out


# -- the printers and the progress state machine against the JAX package's -------


def _both(fn_name, *args):
    ours, theirs = io.StringIO(), io.StringIO()
    getattr(ui, fn_name)(ours, *args)
    getattr(jax_ui, fn_name)(theirs, *args)
    return ours.getvalue(), theirs.getvalue()


STATS = [Response("gpu:a", "x", "gpu", tokens=64, tokens_per_sec=43.68, mfu=0.0123, mbu=0.21),
         Response("gpu:b", "y", "gpu", tokens=64, tokens_per_sec=25.29),
         Response("gpu:c", "z", "gpu")]

PRINTS = {
    "header": ("print_header", "a prompt\nwith lines " * 9),
    "phase": ("print_phase", "Round 2: panel critique..."),
    "success": ("print_success", "Votes tallied!"),
    "error": ("print_error", "round 2 critique failed"),
    "model response": ("print_model_response", "gpu:a", "gpu", "one\ntwo", 1234.5),
    "consensus": ("print_consensus", "the\nconsensus"),
    "summary": ("print_summary", 3, 2, 1, 7.07),
    "throughput": ("print_throughput", STATS),
    "throughput, none": ("print_throughput", STATS[2:]),
    "aggregate": ("print_aggregate", {"tokens": 192.0, "tokens_per_sec": 61.2, "mfu": 0.02}),
    "aggregate, empty": ("print_aggregate", {"tokens": 0.0, "tokens_per_sec": 0.0}),
    "aggregate, none": ("print_aggregate", None),
}


@pytest.mark.parametrize("case", sorted(PRINTS))
def test_printers_byte_identical_to_jax(case):
    ours, theirs = _both(*PRINTS[case])
    assert ours == theirs


def test_progress_frames_match_jax(monkeypatch):
    """One render of each state, at one clock reading, byte for byte."""
    from llm_consensus_tpu.ui import progress as jax_progress
    from llm_consensus_tpu_torch.ui import progress

    for mod in (progress, jax_progress):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 100.0)
        monkeypatch.setattr(mod.time, "time", lambda: 100.35)
    outs = []
    for cls in (Progress, jax_ui.Progress):
        buf = io.StringIO()
        p = cls(buf, ["gpu:a-very-long-model-name-over-25", "gpu:b", "gpu:c", "gpu:d", "e"])
        p.model_started("gpu:b")
        p.model_started("gpu:c")
        p.model_streaming("gpu:c", "x" * 41)
        p.model_completed("gpu:d")
        p.model_failed("e", RuntimeError("device lost"))
        p._render()
        p._render()
        p._rendered = True
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\033[A\033[K") == 7


def test_is_terminal_is_a_character_device_check(tmp_path):
    assert ui.is_terminal(io.StringIO()) is False
    with open(tmp_path / "f", "w") as f:
        assert ui.is_terminal(f) is False
    with open("/dev/null", "w") as f:  # a character device
        assert ui.is_terminal(f) is True
    assert ui.is_terminal(object()) is False


# -- the CLIs' pretty terminal output --------------------------------------------


class Terminal(io.StringIO):
    """A stderr the CLIs take for a terminal."""


def _normalized(text: str) -> str:
    """Terminal output without its clock readings."""
    text = text.replace("tpu:", "gpu:").replace("tpu_", "gpu_")
    text = re.sub(r"\(\d+\.\ds\)", "(T)", text)
    text = re.sub(r"\d+\.\ds", "Ts", text)
    return re.sub(r"/\d{8}-\d{6}-[0-9a-f]{6}", "/RUN_ID", text)


@pytest.mark.parametrize("flags", [
    ["--rounds", "2", "--confidence"],
    ["--vote", "--options", "A,B"],
    ["--system", "be brief", "--json"],
    ["--no-save"],
    ["--output", "{d}/out.json"],
], ids=["rounds-confidence", "vote", "json", "no-save", "output"])
def test_terminal_output_follows_the_jax_cli(tmp_path, monkeypatch, flags):
    from tests.test_torch_cli_modes import Fakes

    jax_cli = importlib.import_module("llm_consensus_tpu.cli.main")
    port_cli = importlib.import_module("llm_consensus_tpu_torch.cli.main")
    from llm_consensus_tpu.ui import progress as jax_progress
    from llm_consensus_tpu_torch.ui import progress

    # One paint and one clear per display: no repaint inside a run.
    for mod in (progress, jax_progress):
        monkeypatch.setattr(mod, "REPAINT_INTERVAL", 3600)
    for cli in (jax_cli, port_cli):
        monkeypatch.setattr(cli.ui, "is_terminal", lambda f: isinstance(f, Terminal))
    outs = {}
    for scheme, cli in (("tpu", jax_cli), ("gpu", port_cli)):
        data = tmp_path / scheme
        fakes = Fakes(scheme, votes={"a": "A", "b": "B"})
        stderr, stdout = Terminal(), io.StringIO()
        argv = ["--models", f"{scheme}:a,{scheme}:b", "--judge", f"{scheme}:j",
                "--data-dir", str(data), *[f.format(d=data) for f in flags], "q"]
        rc = cli.main(argv, factory=fakes.factory, stdin=io.StringIO(""), stdout=stdout,
                      stderr=stderr, install_signal_handlers=False)
        assert rc == 0, stderr.getvalue()
        outs[scheme] = _normalized(stderr.getvalue().replace(str(data), "DATA"))
    assert outs["gpu"] == outs["tpu"]
    if "--json" not in flags:
        assert "LLM Consensus" in outs["gpu"] and "▸ Querying models..." in outs["gpu"]
    if "--rounds" in flags:
        assert "Round 2: panel critique..." in outs["gpu"]
        assert "Judge confidence: 72/100" in outs["gpu"]
