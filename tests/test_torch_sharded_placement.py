"""Sharded engines and the GPU provider's placement (``providers/gpu.py``
``prepare`` over ``parallel/mesh.py`` ``plan_panel``), held to
``tests/test_sharded_placement.py`` case by case: placements equal the JAX
provider's and planner's by device id (the JAX side on its 8-device virtual
CPU mesh, the port on ``virtual_devices(8, "cpu")``), sharded engines' greedy
tokens equal the JAX engine's from the same numpy weights. Beyond the JAX
file: the re-placement rung of the retry ladder, disaggregation's role
split over several positions, and the refusals that stay (JAX's own: a
model drafter on a multi-device mesh, the shared prefix on an sp mesh)."""

from __future__ import annotations

import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.parallel.mesh import plan_panel as jax_plan_panel
from llm_consensus_tpu.parallel.sharding import abstract_param_bytes as jax_abstract_bytes
from llm_consensus_tpu.providers.tpu import TPUProvider
from llm_consensus_tpu_torch.consensus import Judge
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, forward, forward_sharded, init_kv_cache, params_from_numpy)
from llm_consensus_tpu_torch.parallel import make_mesh, param_specs, plan_panel, shard_pytree
from llm_consensus_tpu_torch.parallel.mesh import Device
from llm_consensus_tpu_torch.parallel.sharding import abstract_param_bytes
from llm_consensus_tpu_torch.providers.gpu import GPUProvider
from llm_consensus_tpu_torch.providers.registry import Registry
from llm_consensus_tpu_torch.runner import Runner
from llm_consensus_tpu_torch.utils.context import Context

PROMPT = "Summarize the tradeoffs of tensor parallel inference."
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread beside other xdist workers (restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _devs(n=8, hosts=1):
    """``n`` positions on the CPU, split evenly over ``hosts`` processes."""
    per = n // hosts
    return [Device(i, i // per, CPU) for i in range(n)]


def _trees(preset, seed):
    jp = jax_init(jax_config(preset), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(preset), CPU,
                                 torch.float32)


def _greedy(engine, n, prompt=PROMPT):
    r = engine.generate(prompt, SamplingParams(max_new_tokens=n, ignore_eos=True))
    assert len(r.token_ids) == n
    return r.token_ids


def _jax_greedy(preset, jp, n, prompt=PROMPT, **kw):
    return JaxEngine(jax_config(preset), jp, dtype=jnp.float32, **kw).generate(
        prompt, JaxSampling(max_new_tokens=n, ignore_eos=True)).token_ids


def _ids(mesh):
    return [d.id for d in mesh.devices.flat]


def _tp2(devs=None):
    return make_mesh({"dp": 1, "tp": 2}, devs or _devs(2))


def test_sharded_engine_matches_unsharded():
    jp, tree = _trees("tiny-llama", 7)
    eng = Engine(get_config("tiny-llama"), tree, dtype=torch.float32, mesh=_tp2(),
                 stream_interval=4)
    assert _greedy(eng, 12) == _jax_greedy("tiny-llama", jp, 12, stream_interval=4)


def test_sharded_flash_prefill_matches_xla(monkeypatch):
    """The kernels' route on each shard's head slice (on the CPU their plain
    versions) against the JAX engine's XLA path: equal tokens, and each of
    the two shards runs its own prefill and decode attention over its one
    KV head."""
    import llm_consensus_tpu_torch.models.transformer as tr

    seen = []
    for name in ("flash_attention", "decode_attention"):
        real = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda q, k, *a, _r=real, _n=name, **kw: (
            seen.append((_n, q.shape[2], (k["q8"] if isinstance(k, dict) else k).shape[-2]))
            or _r(q, k, *a, **kw)))
    jp, tree = _trees("tiny-llama", 3)
    cfg = get_config("tiny-llama")
    eng = Engine(cfg, tree, dtype=torch.float32, mesh=_tp2(), stream_interval=4)
    assert _greedy(eng, 12) == _jax_greedy("tiny-llama", jp, 12, stream_interval=4,
                                           attn_impl="xla")
    heads = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
    flash = [s for s in seen if s[0] == "flash_attention"]
    assert len(flash) == 2 * cfg.n_layers and all(s[1:] == heads for s in flash)
    assert {s[1:] for s in seen if s[0] == "decode_attention"} == {heads}


def test_sharded_flash_gating_rejects_non_tp_meshes(monkeypatch):
    """On a mesh with a real dp axis the kernels never run (the JAX gate):
    stubbed to raise, and the sharded forward still matches the unsharded one."""
    import llm_consensus_tpu_torch.models.transformer as tr

    def boom(*a, **k):
        raise AssertionError("kernel invoked on a non-tp-only mesh")

    _jp, tree = _trees("tiny-llama", 3)
    cfg = get_config("tiny-llama")
    mesh = make_mesh({"dp": 2, "tp": 2}, _devs(4))
    specs = param_specs(cfg, mesh)
    group = ShardGroup(cfg, mesh, shard_pytree(tree, specs, mesh), specs)
    tokens = torch.ones((2, 16), dtype=torch.long)
    ref, _ = forward(tree, cfg, tokens, init_kv_cache(cfg, 2, 64, device=CPU,
                                                      dtype=torch.float32), 0)
    monkeypatch.setattr(tr, "flash_attention", boom)
    monkeypatch.setattr(tr, "decode_attention", boom)
    logits = forward_sharded(group, tokens, group.new_caches(2, 64, torch.float32, None), 0,
                             attn_impl="flash")
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=0)


def test_sharded_moe_engine_runs():
    jp, tree = _trees("tiny-mixtral", 0)
    eng = Engine(get_config("tiny-mixtral"), tree, dtype=torch.float32, mesh=_tp2(),
                 stream_interval=4)
    assert _greedy(eng, 8) == _jax_greedy("tiny-mixtral", jp, 8, stream_interval=4)


def _placements(prov, models):
    return {m: _ids(prov.placement(m)) for m in models}


def test_prepare_places_panel_and_judge_on_disjoint_slices():
    panel, judge = ["gpu:tiny-llama", "gpu:tiny-mistral"], "gpu:tiny-mixtral"
    prov = GPUProvider(devices=_devs())
    prov.prepare(panel, judge)
    got = _placements(prov, panel + [judge])
    jprov = TPUProvider()
    jprov.prepare([m.replace("gpu:", "tpu:") for m in panel], judge.replace("gpu:", "tpu:"))
    want = {m: [d.id for d in jprov.placement(m.replace("gpu:", "tpu:")).devices.flat]
            for m in got}
    assert got == want
    assert len(got[judge]) >= 2
    names = list(got)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not set(got[a]) & set(got[b])


def test_consensus_run_on_sharded_slices():
    prov = GPUProvider(devices=_devs(), ignore_eos=True, stream_interval=4)
    panel, judge_model = ["gpu:tiny-llama", "gpu:tiny-mistral"], "gpu:tiny-gemma"
    prov.prepare(panel, judge_model)
    registry = Registry()
    for m in panel + [judge_model]:
        registry.register(m, prov)
    result = Runner(registry, timeout=300.0, max_tokens=8).run(Context.background(), panel,
                                                               PROMPT)
    assert len(result.responses) == 2 and not result.failed_models
    assert Judge(prov, judge_model, max_tokens=8).synthesize_stream(
        Context.background(), PROMPT, result.responses, lambda _c: None)
    for m in panel + [judge_model]:
        assert prov._engines[m.split(":", 1)[1]].mesh is prov.placement(m)
    assert prov.placement(judge_model).size == 4  # tiny-gemma's tp 4 judge slice


def test_prepare_same_layout_keeps_cached_engine():
    prov = GPUProvider(devices=_devs(), ignore_eos=True, stream_interval=4)
    prov.prepare(["gpu:tiny-llama"], None)
    engine = prov._engine_for("gpu:tiny-llama")
    prov.prepare(["gpu:tiny-llama"], None)
    assert prov._engine_for("gpu:tiny-llama") is engine


def test_prepare_layout_change_rebuilds_engine():
    prov = GPUProvider(devices=_devs(), ignore_eos=True, stream_interval=4)
    prov.prepare(["gpu:tiny-llama", "gpu:tiny-mistral"], None)
    engine = prov._engine_for("gpu:tiny-llama")
    prov.prepare(["gpu:tiny-mistral"], "gpu:tiny-llama")
    assert prov._engine_for("gpu:tiny-llama") is not engine


def test_prepare_evicts_presets_absent_from_new_plan():
    prov = GPUProvider(devices=_devs(), ignore_eos=True, stream_interval=4)
    prov.prepare(["gpu:tiny-llama", "gpu:tiny-mistral"], None)
    prov._engine_for("gpu:tiny-llama")
    prov.prepare(["gpu:tiny-mistral"], None)
    assert prov.placement("gpu:tiny-llama") is None
    assert "tiny-llama" not in prov._engines


def test_prepare_scopes_to_given_devices():
    devices = _devs()[:4]
    prov = GPUProvider(devices=_devs())
    prov.prepare(["gpu:tiny-llama"], "gpu:tiny-mistral", devices=devices)
    used = set()
    for m in ("gpu:tiny-llama", "gpu:tiny-mistral"):
        used |= set(_ids(prov.placement(m)))
    assert used <= {d.id for d in devices}


def test_one_device_plans_what_one_card_ran():
    """A provider of one device places every preset on it, tp 1: its engines
    are the classic single-device ones."""
    prov = GPUProvider(device="cpu", ignore_eos=True, stream_interval=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one device always time-multiplexed: no warning
        prov.prepare(["gpu:tiny-llama", "gpu:tiny-mistral"], "gpu:tiny-gemma")
    for m in ("gpu:tiny-llama", "gpu:tiny-mistral", "gpu:tiny-gemma"):
        assert prov.placement(m).size == 1
    eng = prov._engine_for("gpu:tiny-gemma")
    assert eng._groups is None and eng.device == CPU and eng.params is not None


def test_cli_prepare_called_once_per_provider(monkeypatch):
    from llm_consensus_tpu_torch.cli.main import main
    from llm_consensus_tpu_torch.providers.base import Provider, Response

    calls = []

    class Fake(Provider):
        def prepare(self, models, judge):
            calls.append((tuple(models), judge))

        def query(self, ctx, req):
            return Response(model=req.model, content="ans", provider="fake")

        def query_stream(self, ctx, req, callback):
            resp = self.query(ctx, req)
            if callback:
                callback(resp.content)
            return resp

    fake = Fake()
    monkeypatch.setenv("LLMC_CONFIG", "0")
    rc = main(["--models", "a,b", "--judge", "j", "--no-save", "--quiet", "p"],
              factory=lambda model: fake, stdout=io.StringIO(), stderr=io.StringIO(),
              install_signal_handlers=False)
    assert rc == 0
    assert calls == [(("a", "b"), "j")]


def test_sharded_chunked_prefill_matches_unsharded():
    jp, tree = _trees("tiny-llama", 7)
    eng = Engine(get_config("tiny-llama"), tree, dtype=torch.float32, mesh=_tp2(),
                 stream_interval=4, prefill_chunk=16)
    long_prompt = PROMPT * 4
    assert _greedy(eng, 12, long_prompt) == _jax_greedy(
        "tiny-llama", jp, 12, long_prompt, stream_interval=4, prefill_chunk=0)


# -- multi-host placement ----------------------------------------------------------------


def _jax_hosts(n_hosts, per_host):
    devs = jax.devices()
    return [list(devs[h * per_host:(h + 1) * per_host]) for h in range(n_hosts)]


def _both_plans(panel, judge, n_hosts, per_host, **kw):
    devs = _devs(n_hosts * per_host, n_hosts)
    hosts = [devs[h * per_host:(h + 1) * per_host] for h in range(n_hosts)]
    plan = plan_panel([(n, get_config(p)) for n, p in panel],
                      (judge[0], get_config(judge[1])) if judge else None, devices=devs, **kw)
    jhosts = _jax_hosts(n_hosts, per_host)
    jplan = jax_plan_panel([(n, jax_config(p)) for n, p in panel],
                           (judge[0], jax_config(judge[1])) if judge else None,
                           devices=sum(jhosts, []), hosts=jhosts)
    got = {p.model: (p.role, _ids(p.mesh)) for p in plan.placements}
    want = {p.model: (p.role, [d.id for d in p.mesh.devices.flat]) for p in jplan.placements}
    assert got == want
    host_of = {d.id: h for h, g in enumerate(hosts) for d in g}
    return plan, host_of


def test_multihost_panel_spreads_across_hosts():
    plan, host_of = _both_plans([("m0", "tiny-llama"), ("m1", "tiny-mistral")],
                                ("j", "tiny-gemma"), 2, 4)
    used = {p.model: {host_of[i] for i in _ids(p.mesh)} for p in plan.placements}
    assert all(len(h) == 1 for h in used.values())
    assert set().union(*used.values()) == {0, 1}


def test_multihost_three_hosts_three_panels():
    plan, host_of = _both_plans([(f"m{i}", "tiny-llama") for i in range(3)],
                                ("j", "tiny-llama"), 4, 2)
    used = {p.model: {host_of[i] for i in _ids(p.mesh)} for p in plan.placements}
    panel_hosts = [next(iter(used[f"m{i}"])) for i in range(3)]
    assert len(set(panel_hosts)) == 3
    assert used["j"].isdisjoint(set(panel_hosts))


def test_multihost_no_judge_uses_all_hosts():
    plan, host_of = _both_plans([(f"m{i}", "tiny-llama") for i in range(2)], None, 2, 4)
    assert {host_of[_ids(p.mesh)[0]] for p in plan.placements} == {0, 1}


def test_multihost_consensus_run_end_to_end():
    """The serving path (prepare → runner → judge) over two hosts' positions:
    each model's slice stays inside one host."""
    devs = _devs(8, 2)
    prov = GPUProvider(devices=devs, ignore_eos=True, stream_interval=4)
    panel = ["gpu:tiny-llama", "gpu:tiny-mistral"]
    prov.prepare(panel, "gpu:tiny-gemma")
    for m in panel + ["gpu:tiny-gemma"]:
        assert len({d.process_index for d in prov.placement(m).devices.flat}) == 1
    registry = Registry()
    for m in panel + ["gpu:tiny-gemma"]:
        registry.register(m, prov)
    result = Runner(registry, timeout=600.0, max_tokens=4).run(
        Context.background(), panel, "multi host dry run")
    assert len(result.responses) == 2
    assert Judge(prov, "gpu:tiny-gemma", max_tokens=4).synthesize_stream(
        Context.background(), "multi host dry run", result.responses, lambda _c: None)


def test_single_explicit_host_group_restricts_devices():
    subset = _devs()[:4]
    plan = plan_panel([("m0", get_config("tiny-llama")), ("m1", get_config("tiny-llama"))],
                      ("j", get_config("tiny-llama")), hosts=[subset])
    for p in plan.placements:
        assert set(_ids(p.mesh)) <= {d.id for d in subset}, p.model


def test_70b_judge_abstract_sharding():
    cfg = get_config("llama-3-70b")
    mesh = make_mesh({"dp": 1, "tp": 8}, _devs())
    total, sharded = abstract_param_bytes(cfg, mesh)
    from jax.sharding import Mesh as JaxMesh

    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(1, 8), ("dp", "tp"))
    assert (total, sharded) == jax_abstract_bytes(jax_config("llama-3-70b"), jmesh)
    assert total > 120e9
    assert sharded / total > 0.95
    assert (sharded / 8 + (total - sharded)) / 2 < 16e9


def test_multihost_biggest_model_gets_biggest_host_regardless_of_role():
    devs = _devs(6, 1)
    hosts = [[Device(i, 0, CPU) for i in range(4)], [Device(i, 1, CPU) for i in range(4, 6)]]
    panel = [("big-panel", "llama-3-70b"), ("small-panel", "llama-3.2-1b")]
    plan = plan_panel([(n, get_config(p)) for n, p in panel], ("judge", get_config("llama-3-8b")),
                      hosts=hosts)
    jd = jax.devices()
    jplan = jax_plan_panel([(n, jax_config(p)) for n, p in panel],
                           ("judge", jax_config("llama-3-8b")), hosts=[jd[:4], jd[4:6]])
    assert {p.model: _ids(p.mesh) for p in plan.placements} == {
        p.model: [d.id for d in p.mesh.devices.flat] for p in jplan.placements}
    host_of = {d.id: h for h, g in enumerate(hosts) for d in g}
    used = {p.model: {host_of[i] for i in _ids(p.mesh)} for p in plan.placements}
    assert used["big-panel"] == {0} and used["judge"] == {1}
    del devs


def test_multihost_heterogeneous_five_model_panel():
    panel = [("llama8b", "llama-3-8b"), ("mistral", "mistral-7b"), ("gemma", "gemma-7b"),
             ("qwen", "qwen2-7b"), ("llama3b", "llama-3.2-3b")]
    plan, host_of = _both_plans(panel, ("mixtral", "mixtral-8x7b"), 2, 4)
    assert len(plan.placements) == 6
    weights = {p.model: p.cfg.n_params(active_only=True) for p in plan.placements}
    by_host: dict = {}
    for p in plan.placements:
        spans = {host_of[i] for i in _ids(p.mesh)}
        assert len(spans) == 1
        by_host.setdefault(next(iter(spans)), []).append(p)
    for group in by_host.values():
        group = sorted(group, key=lambda p: -weights[p.model])
        for heavy, light in zip(group, group[1:]):
            assert heavy.mesh.size >= light.mesh.size


def test_plan_panel_warns_on_wrap_sharing():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = plan_panel([(f"m{i}", get_config("tiny-llama")) for i in range(4)], None,
                          devices=_devs(2))
    assert len(plan.placements) == 4
    assert any("time-multiplex" in str(c.message) for c in caught)


# -- beyond the JAX file --------------------------------------------------------------------


def test_replace_engine_moves_a_twice_failed_model(monkeypatch):
    """The ladder's third rung: a generate that fails on the engine and on its
    rebuild re-places the model on positions no placement uses, with a
    warning, and the failed positions stay out of later plans."""
    prov = GPUProvider(devices=_devs(), ignore_eos=True, stream_interval=4)
    prov.prepare(["gpu:tiny-llama"], None)
    first = set(_ids(prov.placement("gpu:tiny-llama")))
    real = GPUProvider._generate

    def flaky(self, engine, *a, **k):
        if set(_ids(engine.mesh)) & first:
            raise RuntimeError("wedged device")
        return real(self, engine, *a, **k)

    monkeypatch.setattr(GPUProvider, "_generate", flaky)
    from llm_consensus_tpu_torch.providers.base import Request

    with pytest.warns(RuntimeWarning, match="re-placing tiny-llama"):
        resp = prov.query(Context.background(), Request(model="gpu:tiny-llama", prompt="hi",
                                                        max_tokens=4))
    assert resp.content is not None
    now = set(_ids(prov.placement("gpu:tiny-llama")))
    assert not now & first
    prov.prepare(["gpu:tiny-llama"], None)
    assert not set(_ids(prov.placement("gpu:tiny-llama"))) & first


def test_disagg_splits_roles_over_positions_and_replans():
    """Under disaggregation a preset's slice splits into a prefill and a
    decode role on disjoint positions, each on its planned mesh (tp 2 here,
    the JAX planner's carving): the decode engine and the handoff's prefill
    engine are sharded over them; replan_disagg re-carves the prefill share,
    keeps the decode role and closes the stale handoff."""
    prov = GPUProvider(devices=_devs(4), disagg=True, batch_streams=2, kv_pool=True,
                       prefill_chunk=16, ignore_eos=True, stream_interval=4)
    prov.prepare(["gpu:tiny-gemma"], None)
    dmesh, pmesh = prov.placement("gpu:tiny-gemma"), prov._prefill_meshes["tiny-gemma"]
    jplan = jax_plan_panel([("tiny-gemma", jax_config("tiny-gemma"))], None,
                           devices=jax.devices()[:4], disagg_fraction=0.5)
    jp = jplan.placements[0]
    assert (_ids(dmesh), _ids(pmesh)) == (
        [d.id for d in jp.mesh.devices.flat], [d.id for d in jp.prefill_mesh.devices.flat])
    assert _ids(dmesh) == [0, 1] and _ids(pmesh) == [2, 3]
    engine = prov._engine_for("gpu:tiny-gemma")
    handoff = prov._handoff_for("tiny-gemma", engine)
    assert handoff is not None and engine.sharded and handoff._pe.sharded
    snap = handoff.snapshot()
    assert (snap["prefill_devices"], snap["decode_devices"]) == (2, 2)
    out = prov.replan_disagg("tiny-gemma", 0.25)
    assert out["changed"] is True and out["decode_devices"] == [0, 1]
    assert out["prefill_devices"] == [3]
    assert prov._handoffs.get("tiny-gemma") is None  # the stale handoff closed
    assert prov.replan_disagg("tiny-gemma", 0.5)["prefill_devices"] == [3]
    prov.release()


def test_sharded_engine_refuses_what_it_does_not_serve_yet():
    """What stays refused over a sharded engine is JAX's own: a model
    drafter whose target or draft sits on a mesh of more than one position
    raises ValueError (a buffer drafter rides it), and on a mesh with sp > 1
    the batcher shares no prefix and admits one row at a time (each keeps
    its ring prefill); on a tp mesh the prefix is on and waves batch."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
    from llm_consensus_tpu_torch.engine.speculative import PromptLookupDrafter, SpeculativeEngine

    _jp, tree = _trees("tiny-llama", 1)
    cfg = get_config("tiny-llama")
    eng = Engine(cfg, tree, dtype=torch.float32, mesh=_tp2(), stream_interval=4)
    single = Engine(cfg, tree, dtype=torch.float32, device="cpu")
    for target, draft in ((eng, single), (single, eng)):
        with pytest.raises(ValueError, match="single-device mesh"):
            SpeculativeEngine(target, draft)
    assert SpeculativeEngine(eng, PromptLookupDrafter(3)).draft is None
    tp_pool = ContinuousBatcher(eng, max_batch=2)
    try:
        assert tp_pool._prefix_enabled and not tp_pool._one_by_one
    finally:
        tp_pool.close()
    sp = Engine(cfg, tree, dtype=torch.float32, stream_interval=4,
                mesh=make_mesh({"sp": 2}, _devs(2)))
    b = ContinuousBatcher(sp, max_batch=2)
    waves = []
    real = b._admit_batch
    b._admit_batch = lambda *a, **k: waves.append(1) or real(*a, **k)
    try:
        assert not b._prefix_enabled and b._one_by_one
        s = SamplingParams(max_new_tokens=6, ignore_eos=True)
        prompts = [PROMPT, PROMPT + " Again."]
        futs = [b.submit(p, s) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=300).token_ids == sp.generate(p, s).token_ids
        assert waves == [] and b.snapshot()["admitted"] == 2
    finally:
        b.close()
