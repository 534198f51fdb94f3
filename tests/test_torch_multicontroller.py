"""The port's multi-controller execution (``parallel/multicontroller.py``,
``runner/multihost.py``, ``obs/multihost.py``) held to
``tests/test_multicontroller.py`` case by case: the single-process identity
of the exchange primitives, the runner's merge, the judge broadcast and the
degraded mode under simulated faults, run through BOTH packages where the
JAX object takes the same fakes; the real two-process CLI run (slow, as in
JAX); and a two-process gloo exchange of bytes with no model (tier-1).
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from llm_consensus_tpu import faults as jax_faults
from llm_consensus_tpu.parallel import multicontroller as jax_mc
from llm_consensus_tpu.providers.base import ProviderFunc as JaxProviderFunc
from llm_consensus_tpu.providers.base import Response as JaxResponse
from llm_consensus_tpu.providers.registry import Registry as JaxRegistry
from llm_consensus_tpu.runner.multihost import MultiControllerRunner as JaxRunner
from llm_consensus_tpu.runner.runner import AllModelsFailed as JaxAllFailed
from llm_consensus_tpu.utils.context import Context as JaxContext
from llm_consensus_tpu_torch import faults
from llm_consensus_tpu_torch import obs
from llm_consensus_tpu_torch.obs import export as obs_export
from llm_consensus_tpu_torch.obs.multihost import merge_timelines
from llm_consensus_tpu_torch.parallel import multicontroller as mc
from llm_consensus_tpu_torch.providers.base import ProviderFunc, Request, Response
from llm_consensus_tpu_torch.providers.registry import Registry
from llm_consensus_tpu_torch.runner.multihost import MultiControllerRunner
from llm_consensus_tpu_torch.runner.runner import AllModelsFailed
from llm_consensus_tpu_torch.utils.context import Context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread beside other xdist workers (restored)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ok(name):
    return ProviderFunc(lambda ctx, req: Response(model=req.model, content=f"answer from {name}",
                                                  provider="fake"))


def _jax_ok(name):
    return JaxProviderFunc(lambda ctx, req: JaxResponse(
        model=req.model, content=f"answer from {name}", provider="fake"))


def _both(models: dict, owner, models_run, **kw):
    """The same registry of fakes through both runners: ``models`` maps a
    name to "ok" or an error message. Returns (port result, JAX result)."""
    reg, jreg = Registry(), JaxRegistry()
    for name, kind in models.items():
        if kind == "ok":
            reg.register(name, _ok(name))
            jreg.register(name, _jax_ok(name))
        else:
            def boom(ctx, req, msg=kind):
                raise RuntimeError(msg)
            reg.register(name, ProviderFunc(boom))
            jreg.register(name, JaxProviderFunc(boom))
    got = MultiControllerRunner(reg, timeout=5.0, owner_fn=owner, **kw).run(
        Context.background(), models_run, "q")
    want = JaxRunner(jreg, timeout=5.0, owner_fn=owner, **kw).run(
        JaxContext.background(), models_run, "q")
    return got, want


def _same(got, want):
    assert [(r.model, r.content) for r in got.responses] == [
        (r.model, r.content) for r in want.responses]
    assert got.failed_models == want.failed_models
    assert got.warnings == want.warnings


@pytest.fixture()
def faults_env():
    """Install-and-clean fault plans and degraded-peer state, both packages."""
    faults.reset()
    jax_faults.reset()
    mc.reset_degraded()
    jax_mc.reset_degraded()
    yield
    faults.reset()
    jax_faults.reset()
    mc.reset_degraded()
    jax_mc.reset_degraded()


def test_single_process_primitives_are_identity():
    assert mc.allgather_bytes(b"abc") == [b"abc"] == jax_mc.allgather_bytes(b"abc")
    assert mc.broadcast_bytes(b"xyz", owner=0) == b"xyz"
    assert mc.allgather_json({"a": 1}) == [{"a": 1}]
    assert mc.broadcast_json([1, 2], owner=0) == [1, 2]
    assert not mc.is_multicontroller()
    assert mc.process_index() == 0 and mc.process_count() == 1


def test_model_owner_defaults():
    reg = Registry()
    reg.register("m", _ok("m"))
    assert mc.model_owner(reg, "m") == 0
    assert mc.model_owner(reg, "unknown") == 0


def test_model_owner_follows_the_placement():
    """A provider's placement names the owner: the least process index over
    its mesh."""
    from llm_consensus_tpu_torch.parallel.mesh import Device, make_mesh

    import torch

    mesh = make_mesh({"dp": 1, "tp": 2}, [Device(2, 1, torch.device("cpu")),
                                          Device(3, 1, torch.device("cpu"))])

    class Placed(ProviderFunc):
        def placement(self, model):
            return mesh

    reg = Registry()
    reg.register("m", Placed(lambda ctx, req: None))
    assert mc.mesh_owner(mesh) == 1 and mc.model_owner(reg, "m") == 1


def test_multicontroller_runner_single_process_merge():
    got, want = _both({"a": "ok", "b": "ok", "evil": "boom"}, lambda m: 0, ["b", "evil", "a"])
    assert [r.model for r in got.responses] == ["b", "a"]
    assert got.failed_models == ["evil"]
    assert any("boom" in w for w in got.warnings)
    _same(got, want)


def test_multicontroller_runner_all_fail():
    reg = Registry()
    reg.register("evil", ProviderFunc(lambda ctx, req: (_ for _ in ()).throw(RuntimeError("dead"))))
    runner = MultiControllerRunner(reg, timeout=5.0, owner_fn=lambda m: 0)
    with pytest.raises(AllModelsFailed, match="dead"):
        runner.run(Context.background(), ["evil"], "q")
    jreg = JaxRegistry()
    jreg.register("evil", JaxProviderFunc(
        lambda ctx, req: (_ for _ in ()).throw(RuntimeError("dead"))))
    with pytest.raises(JaxAllFailed, match="dead"):
        JaxRunner(jreg, timeout=5.0, owner_fn=lambda m: 0).run(
            JaxContext.background(), ["evil"], "q")


def test_multicontroller_runner_unowned_models_not_queried():
    calls = []

    def track(ctx, req):
        calls.append(req.model)
        return Response(model=req.model, content="x", provider="fake")

    reg = Registry()
    reg.register("mine", ProviderFunc(track))
    reg.register("theirs", ProviderFunc(track))
    runner = MultiControllerRunner(reg, timeout=5.0, owner_fn={"mine": 0, "theirs": 1}.__getitem__)
    result = runner.run(Context.background(), ["mine", "theirs"], "q")
    assert calls == ["mine"]
    assert [r.model for r in result.responses] == ["mine"]


def test_broadcast_provider_single_process_passthrough():
    provider = mc.BroadcastProvider(_ok("judge"), owner=0)
    chunks = []
    resp = provider.query_stream(Context.background(), Request(model="j", prompt="p"),
                                 chunks.append)
    assert resp.content == "answer from judge" and chunks == ["answer from judge"]

    def boom(ctx, req):
        raise RuntimeError("judge exploded")

    with pytest.raises(RuntimeError, match="judge exploded"):
        mc.BroadcastProvider(ProviderFunc(boom), owner=0).query(
            Context.background(), Request(model="j", prompt="p"))


_CLI_WORKER = textwrap.dedent("""
    import io, sys
    from llm_consensus_tpu_torch.cli.main import main

    code = main(
        ["--models", "gpu:tiny-llama,gpu:tiny-mistral",
         "--judge", "gpu:tiny-llama", "--json", "--no-save",
         "--max-tokens", "8", "multi controller probe"],
        stdin=io.StringIO(""), stdout=sys.stdout, stderr=sys.stderr,
        install_signal_handlers=False, device="cpu",
    )
    sys.exit(code)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, n, env_for, timeout):
    procs = [subprocess.Popen([sys.executable, str(script), *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for args, env in (env_for(i) for i in range(n))]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        outs.append((p.returncode, out, err))
    return outs


def _pythonpath():
    return REPO + os.pathsep + os.environ.get("PYTHONPATH", "")


@pytest.mark.slow
def test_two_process_cpu_cluster_end_to_end(tmp_path):
    """Two controller processes joined through LLMC_COORDINATOR, one CPU
    position each, the whole CLI: host-aware planning gives each process its
    model, each drives only its own, the exchange merges over gloo, and
    process 0 alone prints."""
    worker = tmp_path / "worker.py"
    worker.write_text(_CLI_WORKER)
    port = _free_port()

    def env_for(pid):
        return [], dict(os.environ, LLMC_COORDINATOR=f"127.0.0.1:{port}",
                        LLMC_NUM_PROCESSES="2", LLMC_PROCESS_ID=str(pid), LLMC_CONFIG="0",
                        PYTHONPATH=_pythonpath())

    (rc0, out0, err0), (rc1, out1, err1) = _spawn(worker, 2, env_for, 420)
    assert rc0 == 0, err0[-2000:]
    assert rc1 == 0, err1[-2000:]
    d = json.loads(out0)
    assert {r["model"] for r in d["responses"]} == {"gpu:tiny-llama", "gpu:tiny-mistral"}
    assert d["consensus"]
    assert out1.strip() == ""  # the secondary controller owns no output


_BYTES_WORKER = textwrap.dedent("""
    import json, sys
    from llm_consensus_tpu_torch.parallel import distributed, multicontroller as mc

    port, rank = sys.argv[1], int(sys.argv[2])
    assert distributed.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=20)
    parts = mc.allgather_bytes(("from %d " % rank).encode() * (rank + 1) if rank else b"")
    said = mc.broadcast_bytes(b"the judge's text" if rank == 1 else None, owner=1)
    merged, missing = mc.allgather_json_bounded({"rank": rank}, timeout=10.0)
    print(json.dumps({"parts": [p.decode() for p in parts], "said": said.decode(),
                      "merged": merged, "missing": missing, "count": mc.process_count()}))
    distributed.shutdown()
""")


def test_two_gloo_processes_exchange_bytes(tmp_path):
    """Two processes joined over gloo, no model: allgather_bytes (payloads of
    different lengths, an empty one included), broadcast_bytes from process
    1, and the bounded JSON allgather leave both with the same values."""
    worker = tmp_path / "bytes_worker.py"
    worker.write_text(_BYTES_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_pythonpath())
    t0 = time.monotonic()
    outs = _spawn(worker, 2, lambda i: ([str(port), str(i)], env), 30)
    docs = []
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        docs.append(json.loads(out.strip().splitlines()[-1]))
    assert docs[0] == docs[1]
    assert docs[0] == {"parts": ["", "from 1 from 1 "], "said": "the judge's text",
                       "merged": [{"rank": 0}, {"rank": 1}], "missing": [], "count": 2}
    assert time.monotonic() - t0 < 30


def test_multicontroller_runner_duplicate_models():
    got, want = _both({"m": "ok"}, lambda m: 0, ["m", "m"])
    assert [r.model for r in got.responses] == ["m", "m"]
    _same(got, want)


# -- degraded mode ----------------------------------------------------------------


def test_bounded_allgather_identity_without_faults(faults_env):
    assert mc.allgather_json_bounded({"a": 1}, timeout=5.0) == ([{"a": 1}], [])
    assert mc.allgather_bytes_bounded(b"xy", timeout=5.0) == ([b"xy"], [])
    assert mc.degraded_peers() == frozenset()


def _install(spec):
    faults.install(faults.FaultPlan(spec))
    jax_faults.install(jax_faults.FaultPlan(spec))


@pytest.mark.faults
def test_degraded_merge_dead_controller(faults_env):
    _install("controller_drop@host=1")
    with pytest.warns(RuntimeWarning, match="missed the allgather deadline"):
        got, want = _both({"mine": "ok", "theirs": "ok"}, {"mine": 0, "theirs": 1}.__getitem__,
                          ["mine", "theirs"], allgather_timeout=2.0)
    assert [r.model for r in got.responses] == ["mine"]
    assert got.failed_models == ["theirs"]
    assert any("controller 1 missed" in w for w in got.warnings)
    assert mc.degraded_peers() == frozenset({1}) == jax_mc.degraded_peers()
    _same(got, want)


@pytest.mark.faults
def test_degraded_merge_all_owned_models_failed(faults_env):
    _install("controller_drop@host=1")
    reg = Registry()
    reg.register("a", _ok("a"))
    reg.register("b", _ok("b"))
    runner = MultiControllerRunner(reg, timeout=5.0, owner_fn=lambda m: 1, allgather_timeout=2.0)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(AllModelsFailed, match="missed the allgather"):
            runner.run(Context.background(), ["a", "b"], "q")


@pytest.mark.faults
def test_late_controller_within_deadline_merges_normally(faults_env):
    _install("controller_late@host=1@s=0.01")
    got, want = _both({"mine": "ok"}, lambda m: 0, ["mine"], allgather_timeout=2.0)
    assert [r.model for r in got.responses] == ["mine"]
    assert got.failed_models == []
    assert mc.degraded_peers() == frozenset()
    _same(got, want)


@pytest.mark.faults
def test_late_controller_past_deadline_is_dropped(faults_env):
    faults.install(faults.FaultPlan("controller_late@host=1@s=5"))
    reg = Registry()
    reg.register("mine", _ok("mine"))
    reg.register("theirs", _ok("theirs"))
    runner = MultiControllerRunner(reg, timeout=5.0, owner_fn={"mine": 0, "theirs": 1}.__getitem__,
                                   allgather_timeout=0.05)
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning):
        result = runner.run(Context.background(), ["mine", "theirs"], "q")
    assert time.monotonic() - t0 < 3.0
    assert [r.model for r in result.responses] == ["mine"]
    assert result.failed_models == ["theirs"]
    assert mc.degraded_peers() == frozenset({1})


@pytest.mark.faults
def test_broadcast_provider_degrades_to_local_judge(faults_env):
    mc.mark_degraded([1])
    calls = []

    def judge_fn(ctx, req):
        calls.append(req.model)
        return Response(model=req.model, content="verdict", provider="fake")

    resp = mc.BroadcastProvider(ProviderFunc(judge_fn), owner=1).query(
        Context.background(), Request(model="j", prompt="p"))
    assert resp.content == "verdict"
    assert calls == ["j"]


def test_allgather_timeout_respects_context_deadline():
    ctx = Context.background().with_timeout(0.5)
    assert mc.allgather_timeout(ctx) <= 0.5
    assert mc.allgather_timeout(None) == mc.DEFAULT_ALLGATHER_TIMEOUT_S == \
        jax_mc.DEFAULT_ALLGATHER_TIMEOUT_S
    assert mc.allgather_timeout(None, cap=7.0) == 7.0


# -- the timeline merge, in one process ---------------------------------------------


def test_merge_timelines_single_process_is_the_local_trace(faults_env):
    """One process: the merge is the local timeline (pid 0, the same events
    and times as export.local_trace's spans), nothing missing; the exchange
    itself lands on the recorder as an ``allgather`` span."""
    rec = obs.Recorder()
    t0 = rec.now()
    rec.complete("prefill", t0, tid="engine", tokens=3)
    rec.instant("degraded", tid="mc", peers=[1])
    obs.install(rec)
    try:
        doc, missing = merge_timelines(rec, timeout=5.0)
    finally:
        obs.install(None)
    assert missing == []
    local = obs_export.local_trace(obs.Recorder())  # shape only
    assert set(doc) == set(local)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names == ["prefill", "degraded"]
    assert all(e["pid"] == 0 for e in doc["traceEvents"])
    assert [e.name for e in rec.events()][-1] == "allgather"


@pytest.mark.faults
def test_merge_timelines_survives_a_dead_controller(faults_env):
    """A dropped peer costs its timeline, not the merge."""
    faults.install(faults.FaultPlan("controller_drop@host=1"))
    rec = obs.Recorder()
    rec.complete("decode", rec.now(), tid="engine")
    doc, missing = merge_timelines(rec, timeout=1.0)
    assert missing == [1]
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"] == ["decode"]


def test_cli_runs_single_process_unchanged(monkeypatch, tmp_path):
    """With no coordinator configured the CLI's initialize is a no-op and the
    run takes the plain runner (nothing of the multi-controller path)."""
    from llm_consensus_tpu_torch.cli.main import main
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    for v in ("LLMC_COORDINATOR", "LLMC_NUM_PROCESSES", "LLMC_PROCESS_ID", "LLMC_DISTRIBUTED"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("LLMC_CONFIG", "0")
    prov = GPUProvider(device="cpu", ignore_eos=True, stream_interval=4)
    out = io.StringIO()
    rc = main(["--models", "gpu:tiny-llama", "--judge", "gpu:tiny-llama", "--json",
               "--max-tokens", "4", "probe"], factory=lambda m: prov, stdout=out,
              stderr=io.StringIO(), install_signal_handlers=False)
    assert rc == 0
    assert json.loads(out.getvalue())["responses"][0]["model"] == "gpu:tiny-llama"
    assert not mc.is_multicontroller()
