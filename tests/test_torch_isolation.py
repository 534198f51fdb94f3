"""The port stands alone: no file of ``llm_consensus_tpu_torch`` (or
``chip_smoke.py``) imports JAX or the JAX package, every port module
imports with JAX made unimportable, and the entry points refuse to fall
back to the CPU when no card is visible."""

import ast
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import llm_consensus_tpu_torch
from llm_consensus_tpu_torch.cli.main import main as cli_main
from llm_consensus_tpu_torch.engine import Engine
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.providers.gpu import GPUProvider

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "llm_consensus_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "llm_consensus_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_the_obs_modules_are_covered():
    names = {p.name for p in _port_files() if p.parent.name == "obs"}
    assert names == {"__init__.py", "attrib.py", "blackbox.py", "export.py", "live.py",
                     "multihost.py", "profiler.py", "prom.py", "recorder.py", "roofline.py"}


def test_the_parallel_modules_are_covered():
    """The AST checks cover the whole of the ported ``parallel/`` and the
    multi-controller runner."""
    names = {p.name for p in _port_files() if p.parent.name == "parallel"}
    assert names == {"__init__.py", "distributed.py", "mesh.py", "multicontroller.py",
                     "pipeline.py", "ring.py", "sharding.py"}
    assert (PKG / "runner" / "multihost.py").exists()


def test_the_serve_modules_are_covered():
    """The AST checks above and below cover the serving gateway's package
    with the fleet tier (router, fleet state, the whole elastic module),
    the governor and the serve and route subcommands."""
    names = {p.name for p in _port_files() if p.parent.name == "serve"}
    assert names == {"__init__.py", "admission.py", "cache.py", "elastic.py", "fleet.py",
                     "gateway.py", "router.py", "scheduler.py", "stats.py"}
    files = {p.relative_to(PKG).as_posix() for p in _port_files() if PKG in p.parents}
    assert {"pressure/governor.py", "cli/serve.py", "cli/route.py"} <= files
    elastic = (PKG / "serve" / "elastic.py").read_text()
    for name in ("class ElasticController", "class MigrationRecord", "class MigrationTable",
                 "class StreamMigrated", "def ship_record"):
        assert name in elastic, name


def test_the_kv_modules_are_covered():
    """The AST checks above and below cover the KV pool's package."""
    names = {p.name for p in _port_files() if p.parent.name == "kv"}
    assert names == {"__init__.py", "pool.py", "radix.py"}


def test_the_knobs_module_reads_only_knobs_the_jax_package_declares():
    """Every ``LLMC_*`` name in utils/knobs.py (its readers and its
    docstring) is declared by the JAX package's knob registry: the port adds
    no knob."""
    from llm_consensus_tpu.utils import knobs as jax_knobs

    text = (PKG / "utils" / "knobs.py").read_text()
    named = set(re.findall(r"LLMC_[A-Z0-9_]+", text))
    assert {"LLMC_KV_POOL", "LLMC_KV_POOL_BLOCK", "LLMC_KV_POOL_MB",
            "LLMC_INTEGRITY_SAMPLE", "LLMC_DRAFT", "LLMC_SPEC_K", "LLMC_SPEC_NGRAM",
            "LLMC_SPEC_ADAPT", "LLMC_SPEC_GOVERNOR", "LLMC_SPEC_PROBE"} <= named
    assert {"LLMC_ELASTIC_WARM_S", "LLMC_INTEGRITY_QUARANTINE_AFTER", "LLMC_INTEGRITY_PROBE_N",
            "LLMC_SWAP_WAIT_S", "LLMC_FLEET_ANNOUNCE", "LLMC_DISAGG", "LLMC_PRESSURE",
            "LLMC_PRESSURE_POLL_S", "LLMC_PRESSURE_HIGH_WATER", "LLMC_PRESSURE_LOW_WATER",
            "LLMC_PRESSURE_UP_PATIENCE", "LLMC_PRESSURE_DOWN_PATIENCE",
            "LLMC_PRESSURE_EVICT_TARGET", "LLMC_PRESSURE_JUDGE_FALLBACK",
            "LLMC_PRESSURE_BROWNOUT_MAX_NEW", "LLMC_PRESSURE_SHED_CLASS", "LLMC_PRESSURE_AGE_S",
            "LLMC_PRESSURE_RETRY_SPREAD", "LLMC_SLO_TTFT_P99_S", "LLMC_SLO_WINDOWS"} <= named
    assert {"LLMC_MAX_SEQ", "LLMC_PREFILL_CHUNK", "LLMC_STALL_GRACE",
            "LLMC_FLEET_POLL_S", "LLMC_FLEET_SUSPECT_AFTER", "LLMC_FLEET_DEAD_AFTER",
            "LLMC_FLEET_REVIVE_AFTER", "LLMC_FLEET_SATURATION",
            "LLMC_FLEET_SPILLOVER_MIN_TIMEOUT_S", "LLMC_FLEET_SPILLOVER_MAX_PRIORITY",
            "LLMC_FLEET_HEARTBEAT_S", "LLMC_ELASTIC", "LLMC_ELASTIC_TICK_S",
            "LLMC_ELASTIC_HIGH_WATER", "LLMC_ELASTIC_LOW_WATER", "LLMC_ELASTIC_UP_PATIENCE",
            "LLMC_ELASTIC_DOWN_PATIENCE", "LLMC_ELASTIC_MIN_REPLICAS",
            "LLMC_ELASTIC_MAX_REPLICAS", "LLMC_ELASTIC_MIGRATE_TIMEOUT_S",
            "LLMC_CANARY_FRACTION"} <= named
    # Disaggregation (4, beside LLMC_DISAGG, now honoured), the data
    # directory (1) and distillation (8): exactly these 13 joined the 98
    # names before them. The prefill share of a multi-device slice and the
    # canary watcher's three knobs have no reader in the port yet.
    assert {"LLMC_DISAGG_DEPTH", "LLMC_DISAGG_WAVE", "LLMC_DISAGG_WAIT_S",
            "LLMC_DISAGG_OVERLAP", "LLMC_DATA_DIR",
            "LLMC_DISTILL_LR", "LLMC_DISTILL_STEPS", "LLMC_DISTILL_BATCH", "LLMC_DISTILL_SEQ",
            "LLMC_DISTILL_TEMP", "LLMC_DISTILL_ALPHA", "LLMC_DISTILL_HOLDOUT",
            "LLMC_DISTILL_CKPT_EVERY"} <= named
    # Placement and multi-controller runs: exactly these 7 joined next.
    assert {"LLMC_DISTRIBUTED", "LLMC_COORDINATOR", "LLMC_NUM_PROCESSES", "LLMC_PROCESS_ID",
            "LLMC_MULTIHOST_PLACEMENT", "LLMC_ALLGATHER_TIMEOUT", "LLMC_DISAGG_FRACTION"} <= named
    assert not {"LLMC_CANARY_WINDOWS", "LLMC_CANARY_LATENCY_TOL",
                "LLMC_CANARY_MIN_SAMPLES"} & named
    # The concurrency analysis: exactly these 5 joined next (the sanitizer's
    # switch, read lazily outside the CLI boundary, and the schedule explorer's).
    assert {"LLMC_SANITIZE", "LLMC_SCHED", "LLMC_SCHED_PREEMPTS", "LLMC_SCHED_STEPS",
            "LLMC_SCHED_RACE"} <= named
    assert len(named) == 98 + 13 + 7 + 5, sorted(named)
    undeclared = sorted(n for n in named if n not in jax_knobs.REGISTRY)
    assert not undeclared, undeclared


def test_the_disagg_and_flywheel_settings_take_the_jax_defaults(monkeypatch):
    """With the environment empty, the disaggregation and distillation
    knobs read the JAX registry's defaults."""
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    names = {
        "disagg_settings": {"disagg": "LLMC_DISAGG", "disagg_depth": "LLMC_DISAGG_DEPTH", "disagg_wave": "LLMC_DISAGG_WAVE",
                            "disagg_wait_s": "LLMC_DISAGG_WAIT_S",
                            "disagg_overlap": "LLMC_DISAGG_OVERLAP"},
        "flywheel_settings": {k: "LLMC_DISTILL_" + n for k, n in (
            ("lr", "LR"), ("steps", "STEPS"), ("batch", "BATCH"), ("seq", "SEQ"),
            ("temperature", "TEMP"), ("alpha", "ALPHA"), ("holdout", "HOLDOUT"),
            ("ckpt_every", "CKPT_EVERY"))},
    }
    for fn, keys in names.items():
        for name in keys.values():
            monkeypatch.delenv(name, raising=False)
        got = getattr(knobs, fn)()
        assert set(got) == set(keys), fn
        for key, name in keys.items():
            assert got[key] == jax_knobs.REGISTRY[name].default, (fn, key)
    monkeypatch.delenv("LLMC_DATA_DIR", raising=False)
    assert knobs.data_dir() == jax_knobs.REGISTRY["LLMC_DATA_DIR"].default


@pytest.mark.parametrize("path", [p for p in _port_files() if p.parent != ROOT],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_only_the_knobs_module_reads_llmc_variables(path):
    """The environment is read at one boundary: utils/knobs.py. No other
    module of the package holds an ``LLMC_*`` variable's name as a string
    (the key a read needs; help texts and docstrings may mention them)."""
    if path == PKG / "utils" / "knobs.py":
        return
    tree = ast.parse(path.read_text(), filename=str(path))
    named = [
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and re.fullmatch(r"LLMC_[A-Z0-9_]*", node.value)
    ]
    assert not named, f"{path.name} names {named}"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        llm_consensus_tpu_torch.__path__, "llm_consensus_tpu_torch."))


def test_every_module_imports_without_jax():
    modules = _port_modules()
    assert "llm_consensus_tpu_torch.ops.kernels.decode_attention" in modules
    assert "llm_consensus_tpu_torch.engine.batcher" in modules
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'llm_consensus_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_raises_without_a_gpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_config("tiny-llama"))


def test_provider_raises_without_a_gpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPUProvider()


def test_cli_raises_without_a_gpu(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--models", "gpu:tiny-llama", "x"], install_signal_handlers=False)


def test_explicit_cpu_runs_on_the_cpu(no_cuda):
    eng = Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=64, device="cpu")
    assert eng.device.type == "cpu"
    assert all(w.device.type == "cpu" for w in eng.params["layers"].values())


def test_the_serving_settings_take_the_jax_defaults(monkeypatch):
    """With the environment empty, the port's serving knobs read the JAX
    registry's defaults, and no serving module writes the environment."""
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    names = {
        "serve_settings": {"elastic_warm_s": "LLMC_ELASTIC_WARM_S",
                           "quarantine_after": "LLMC_INTEGRITY_QUARANTINE_AFTER",
                           "probe_n": "LLMC_INTEGRITY_PROBE_N",
                           "swap_wait_s": "LLMC_SWAP_WAIT_S",
                           "announce": "LLMC_FLEET_ANNOUNCE", "disagg": "LLMC_DISAGG"},
        "live_settings": {"slo_ttft_p99_s": "LLMC_SLO_TTFT_P99_S",
                          "slo_windows": "LLMC_SLO_WINDOWS"},
        "pressure_settings": {k: "LLMC_PRESSURE" + ("" if k == "enabled" else "_" + k.upper())
                              for k in ("enabled", "poll_s", "high_water", "low_water",
                                        "up_patience", "down_patience", "evict_target",
                                        "judge_fallback", "brownout_max_new", "shed_class",
                                        "age_s", "retry_spread")},
    }
    for fn, keys in names.items():
        for name in keys.values():
            monkeypatch.delenv(name, raising=False)
        got = getattr(knobs, fn)()
        for key, name in keys.items():
            assert got[key] == jax_knobs.REGISTRY[name].default, (fn, key)
    for path in sorted(PKG.rglob("*.py")):
        assert "os.environ[" not in path.read_text() or path.name == "knobs.py", path

def test_the_engine_and_fleet_settings_take_the_jax_defaults(monkeypatch):
    """With the environment empty, the engines' capacity and prefill knobs,
    the runner's stall grace and the fleet tier's knobs read the JAX
    registry's defaults (``LLMC_MAX_SEQ`` 0 is the preset's window: None)."""
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    names = {
        "fleet_settings": {k: "LLMC_FLEET_" + k.upper()
                           for k in ("poll_s", "suspect_after", "dead_after", "revive_after",
                                     "saturation", "spillover_min_timeout_s",
                                     "spillover_max_priority", "heartbeat_s")},
        "elastic_settings": {k: "LLMC_ELASTIC" + ("" if k == "enabled" else "_" + k.upper())
                             for k in ("enabled", "tick_s", "high_water", "low_water",
                                       "up_patience", "down_patience", "min_replicas",
                                       "max_replicas", "migrate_timeout_s")},
    }
    names["fleet_settings"]["canary_fraction"] = "LLMC_CANARY_FRACTION"
    for name in ("LLMC_MAX_SEQ", "LLMC_PREFILL_CHUNK", "LLMC_STALL_GRACE"):
        monkeypatch.delenv(name, raising=False)
    for fn, keys in names.items():
        for name in keys.values():
            monkeypatch.delenv(name, raising=False)
        got = getattr(knobs, fn)()
        assert set(got) == set(keys), fn
        for key, name in keys.items():
            assert got[key] == jax_knobs.REGISTRY[name].default, (fn, key)
    assert knobs.engine_settings() == {
        "max_seq": jax_knobs.REGISTRY["LLMC_MAX_SEQ"].default or None,
        "prefill_chunk": jax_knobs.REGISTRY["LLMC_PREFILL_CHUNK"].default}
    assert knobs.stall_grace() == jax_knobs.REGISTRY["LLMC_STALL_GRACE"].default
    monkeypatch.setenv("LLMC_MAX_SEQ", "64")
    monkeypatch.setenv("LLMC_PREFILL_CHUNK", "0")
    monkeypatch.setenv("LLMC_STALL_GRACE", "0.3")
    assert knobs.engine_settings() == {"max_seq": 64, "prefill_chunk": 0}
    assert knobs.stall_grace() == 0.3


def test_the_placement_knobs_take_the_jax_defaults(monkeypatch):
    """With the environment empty, the 7 placement and multi-controller knobs
    read the JAX registry's defaults."""
    from llm_consensus_tpu.utils import knobs as jax_knobs
    from llm_consensus_tpu_torch.utils import knobs

    names = ("LLMC_DISTRIBUTED", "LLMC_COORDINATOR", "LLMC_NUM_PROCESSES", "LLMC_PROCESS_ID",
             "LLMC_MULTIHOST_PLACEMENT", "LLMC_ALLGATHER_TIMEOUT", "LLMC_DISAGG_FRACTION")
    for name in names:
        monkeypatch.delenv(name, raising=False)
    reg = jax_knobs.REGISTRY
    assert knobs.disagg_fraction() == reg["LLMC_DISAGG_FRACTION"].default
    assert knobs.multihost_placement() == reg["LLMC_MULTIHOST_PLACEMENT"].default
    assert knobs.allgather_timeout() == reg["LLMC_ALLGATHER_TIMEOUT"].default
    assert knobs.placement_settings() == {"disagg_fraction": knobs.disagg_fraction(),
                                          "multihost_placement": knobs.multihost_placement()}
    d = knobs.distributed_settings()
    assert d["force"] == reg["LLMC_DISTRIBUTED"].default
    assert (d["coordinator_address"] or "") == reg["LLMC_COORDINATOR"].default
    assert (d["num_processes"] or 0) == reg["LLMC_NUM_PROCESSES"].default
    assert d["process_id"] == reg["LLMC_PROCESS_ID"].default
