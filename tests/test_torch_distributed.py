"""The port's multi-host layer (``parallel/distributed.py``) held to
``tests/test_distributed.py`` case by case: the granule and axis math of
``hybrid_mesh`` against JAX's by device id, the no-op contract of
``initialize``, the train and engine stacks on a hybrid mesh against the
JAX results, the launcher markers; and, beyond the JAX file, a data-parallel
train step across two gloo processes held to the one-process step."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.parallel.distributed import _pod_env as jax_pod_env
from llm_consensus_tpu.parallel.distributed import hybrid_mesh as jax_hybrid_mesh
from llm_consensus_tpu.train import make_train_step as jax_train_step
from llm_consensus_tpu.train.step import TrainState as JaxTrainState
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.parallel import virtual_devices
from llm_consensus_tpu_torch.parallel.distributed import (
    _pod_env, hybrid_mesh, initialize, is_initialized)
from llm_consensus_tpu_torch.train.step import init_train_state, make_train_step, sgd
from llm_consensus_tpu_torch.utils import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread beside other xdist workers (restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _batch(seed, vocab, batch=4, seq=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": mask}


def test_initialize_is_noop_without_config(monkeypatch):
    for v in ("LLMC_COORDINATOR", "LLMC_NUM_PROCESSES", "LLMC_PROCESS_ID", "LLMC_DISTRIBUTED",
              "WORLD_SIZE", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(v, raising=False)
    settings = knobs.distributed_settings()
    assert settings == {"coordinator_address": None, "num_processes": None, "process_id": 0,
                        "force": False}
    assert initialize(**settings) is False
    assert not is_initialized()


def test_hybrid_mesh_axis_order_and_granules():
    mesh = hybrid_mesh({"dp": 2}, {"tp": 4}, virtual_devices(8, "cpu"))
    jmesh = jax_hybrid_mesh({"dp": 2}, {"tp": 4}, jax.devices())
    assert mesh.axis_names == ("dp", "tp") == jmesh.axis_names
    assert mesh.shape == {"dp": 2, "tp": 4}
    ids = _ids(mesh)
    assert ids.tolist() == np.vectorize(lambda d: d.id)(jmesh.devices).tolist()
    for row in ids:
        assert list(row) == list(range(row[0], row[0] + 4))


def test_hybrid_mesh_multi_axis():
    mesh = hybrid_mesh({"pp": 2}, {"dp": 2, "tp": 2}, virtual_devices(8, "cpu"))
    assert mesh.axis_names == ("pp", "dp", "tp")
    assert mesh.devices.shape == (2, 2, 2)
    jmesh = jax_hybrid_mesh({"pp": 2}, {"dp": 2, "tp": 2}, jax.devices())
    assert _ids(mesh).tolist() == np.vectorize(lambda d: d.id)(jmesh.devices).tolist()


def test_hybrid_mesh_size_mismatch_raises():
    with pytest.raises(ValueError, match="needs 16 devices"):
        hybrid_mesh({"dp": 4}, {"tp": 4}, virtual_devices(8, "cpu"))


def test_train_step_runs_on_hybrid_mesh():
    """The dp (DCN) x tp (ICI) layout drives the unchanged train stack; the
    loss equals the JAX step's on its hybrid mesh within 5e-4."""
    import optax

    cfg = get_config("tiny-llama")
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, CPU, torch.float32)
    b = _batch(1, cfg.vocab_size)
    mesh = hybrid_mesh({"dp": 2}, {"tp": 4}, virtual_devices(8, "cpu"))
    state = init_train_state(cfg, 0, sgd(1e-3), params=tree, mesh=mesh, dtype=torch.float32)
    _, m = make_train_step(cfg, remat=True, mesh=mesh)(
        state, {k: torch.tensor(v, dtype=torch.long if k != "mask" else torch.float32)
                for k, v in b.items()})
    assert np.isfinite(m["loss"])
    opt = optax.sgd(1e-3)
    jmesh = jax_hybrid_mesh({"dp": 2}, {"tp": 4}, jax.devices())
    jstate = JaxTrainState(step=jnp.asarray(0), params=jp, opt_state=opt.init(jp))
    _, jm = jax_train_step(jax_config("tiny-llama"), opt, mesh=jmesh, remat=True)(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=5e-4)


def test_sharded_engine_on_hybrid_mesh_matches_unsharded():
    cfg = get_config("tiny-llama")
    jp = jax_init(jax_config("tiny-llama"), jax.random.PRNGKey(2), dtype=jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, CPU, torch.float32)
    prompt = "hybrid mesh inference"
    want = JaxEngine(jax_config("tiny-llama"), jp, dtype=jnp.float32, max_seq=128).generate(
        prompt, JaxSampling(max_new_tokens=10, ignore_eos=True)).token_ids
    mesh = hybrid_mesh({"dp": 1}, {"tp": 2}, virtual_devices(2, "cpu"))
    eng = Engine(cfg, tree, dtype=torch.float32, max_seq=128, mesh=mesh)
    assert eng.generate(prompt, SamplingParams(max_new_tokens=10, ignore_eos=True)
                        ).token_ids == want


def test_pod_env_detection(monkeypatch):
    """The JAX cases, with torch's launcher markers in the places of
    ``TPU_WORKER_HOSTNAMES`` (``WORLD_SIZE``) and the coordinator markers
    (``TORCHELASTIC_RUN_ID``): no markers or a one-process launch is not a
    multi-process environment; several processes, an elastic agent or
    ``LLMC_DISTRIBUTED`` is."""
    for v in ("LLMC_DISTRIBUTED", "MEGASCALE_COORDINATOR_ADDRESS",
              "CLOUD_TPU_CLUSTER_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(v, raising=False)
    cases = [({}, {}, False), ({"TPU_WORKER_HOSTNAMES": "localhost"}, {"WORLD_SIZE": "1"}, False),
             ({"TPU_WORKER_HOSTNAMES": "host-0,host-1"}, {"WORLD_SIZE": "2"}, True),
             ({"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
              {"TORCHELASTIC_RUN_ID": "run-1"}, True)]
    for jax_env, torch_env, want in cases:
        for k, v in jax_env.items():
            monkeypatch.setenv(k, v)
        assert jax_pod_env() is want
        assert _pod_env(environ=torch_env) is want
        for k in jax_env:
            monkeypatch.delenv(k)
    monkeypatch.setenv("LLMC_DISTRIBUTED", "1")
    assert jax_pod_env() is True
    assert _pod_env(force=knobs.distributed_settings()["force"], environ={}) is True


_DP_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel import virtual_devices
    from llm_consensus_tpu_torch.parallel import distributed, multicontroller as mc
    from llm_consensus_tpu_torch.parallel.distributed import hybrid_mesh
    from llm_consensus_tpu_torch.train.step import init_train_state, make_train_step, sgd

    port, rank = sys.argv[1], int(sys.argv[2])
    assert distributed.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=60)
    cfg = get_config("tiny-llama")
    tree = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
    mask = torch.ones(4, 16); mask[:, -1] = 0; mask[1, 5:] = 0
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1), "mask": mask}
    mesh = hybrid_mesh({"dp": 2}, {"tp": 2}, mc.global_devices(virtual_devices(2, "cpu")))
    state = init_train_state(cfg, 0, sgd(1e-2), params=tree, mesh=mesh, dtype=torch.float32)
    _, m = make_train_step(cfg, remat=False, mesh=mesh)(state, batch)
    local = [i for i, d in enumerate(mesh.devices.flat) if d.process_index == rank]
    wq = state.shards[local[0]]["layers"]["wq"].detach()
    print(json.dumps({"loss": m["loss"], "grad_norm": m["grad_norm"], "pos": local[0],
                      "wq_sum": float(wq.double().sum())}))
    distributed.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dp_step_matches_one_process(tmp_path):
    """dp across two gloo processes (a hybrid mesh: dp over processes, tp over
    two virtual positions each): the gradient all-reduce through the group
    gives the one-process dp 2 x tp 2 step's loss, norm and update."""
    worker = tmp_path / "dp_worker.py"
    worker.write_text(_DP_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(worker), str(port), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("two-process dp step timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    from llm_consensus_tpu_torch.models.transformer import init_params
    from llm_consensus_tpu_torch.parallel import make_mesh

    cfg = get_config("tiny-llama")
    tree = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
    mask = torch.ones(4, 16)
    mask[:, -1] = 0
    mask[1, 5:] = 0
    mesh = make_mesh({"dp": 2, "tp": 2}, virtual_devices(4, "cpu"))
    state = init_train_state(cfg, 0, sgd(1e-2), params=tree, mesh=mesh, dtype=torch.float32)
    _, m = make_train_step(cfg, remat=False, mesh=mesh)(
        state, {"tokens": tokens, "targets": torch.roll(tokens, -1, 1), "mask": mask})
    for o in outs:
        np.testing.assert_allclose(o["loss"], m["loss"], rtol=1e-6)
        np.testing.assert_allclose(o["grad_norm"], m["grad_norm"], rtol=1e-5)
        wq = state.shards[o["pos"]]["layers"]["wq"].detach()
        np.testing.assert_allclose(o["wq_sum"], float(wq.double().sum()), rtol=1e-6)
