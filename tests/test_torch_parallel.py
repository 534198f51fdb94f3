"""The port's ``parallel/`` mesh and sharding layer held to ``tests/test_parallel.py``
case by case: the JAX side on its 8-device virtual CPU mesh (tests/conftest.py),
the port on ``virtual_devices(8, "cpu")``, from the same numpy weights
(``params_from_numpy``).

Tolerances, the JAX file's: a tensor-, expert- or data-parallel forward's
float32 logits within 2e-4 (relative and absolute) of the unsharded JAX
forward; greedy tokens equal; spec trees equal leaf for leaf; placements
equal by device id.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import forward as jax_forward
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.models.config import get_config as jax_config
from llm_consensus_tpu.parallel import best_tp as jax_best_tp
from llm_consensus_tpu.parallel import carve_slices as jax_carve
from llm_consensus_tpu.parallel import make_mesh as jax_make_mesh
from llm_consensus_tpu.parallel import param_specs as jax_param_specs
from llm_consensus_tpu.parallel import plan_panel as jax_plan_panel
from llm_consensus_tpu.parallel.sharding import cache_specs as jax_cache_specs
from llm_consensus_tpu.parallel.sharding import opt_moment_specs as jax_moment_specs
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, forward_sharded, init_kv_cache, params_from_numpy)
from llm_consensus_tpu_torch.parallel import (
    best_tp, cache_specs, carve_slices, make_mesh, make_shard_fn, param_specs, plan_panel,
    shard_pytree, virtual_devices)
from llm_consensus_tpu_torch.parallel.sharding import (
    all_gather, all_reduce_sum, gather_tree, opt_moment_specs)

CPU = torch.device("cpu")
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _devs(n: int = 8):
    return virtual_devices(n, "cpu")


def _trees(preset: str, seed: int):
    jp = jax_init(jax_config(preset), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(preset), CPU,
                                 torch.float32)


def _tokens(preset: str, b: int = 2, t: int = 16) -> np.ndarray:
    return np.random.default_rng(1).integers(0, get_config(preset).vocab_size, (b, t))


def _sharded_logits(preset: str, tree: dict, axes: dict, tokens: np.ndarray) -> np.ndarray:
    cfg = get_config(preset)
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, _devs(n))
    specs = param_specs(cfg, mesh)
    group = ShardGroup(cfg, mesh, shard_pytree(tree, specs, mesh), specs)
    with torch.no_grad():
        return forward_sharded(group, torch.tensor(tokens)).numpy()


def _jax_logits(preset: str, jp: dict, tokens: np.ndarray) -> np.ndarray:
    logits, _ = jax_forward(jp, jax_config(preset), jnp.asarray(tokens, jnp.int32))
    return np.asarray(logits, np.float32)


def _spec_tuple(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _ids(mesh) -> list:
    return [d.id for d in mesh.devices.flat]


# -- mesh topology -----------------------------------------------------------------


def test_make_mesh_shapes():
    for axes in ({"dp": 2, "tp": 4}, {"dp": -1, "tp": 2}):
        mesh, jmesh = make_mesh(axes, _devs()), jax_make_mesh(axes)
        assert mesh.shape == dict(jmesh.shape)
        assert _ids(mesh) == [d.id for d in jmesh.devices.flat]
    assert make_mesh({"dp": -1, "tp": 2}, _devs()).shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError):
        make_mesh({"dp": 3, "tp": 4}, _devs())


def test_carve_slices_disjoint():
    slices = carve_slices(_devs(), [4, 2, 2])
    assert [len(s) for s in slices] == [4, 2, 2]
    assert [[d.id for d in s] for s in slices] == [
        [d.id for d in s] for s in jax_carve(jax.devices(), [4, 2, 2])]
    assert len({d.id for s in slices for d in s}) == 8
    with pytest.raises(ValueError):
        carve_slices(_devs(), [8, 1])


def test_best_tp_respects_gqa():
    for preset, n in (("tiny-llama", 8), ("tiny-llama", 1), ("tiny-gemma", 8)):
        assert best_tp(get_config(preset), n) == jax_best_tp(jax_config(preset), n)
    assert best_tp(get_config("tiny-llama"), 8) == 2
    assert best_tp(get_config("tiny-gemma"), 8) == 4


def test_plan_panel_disjoint_slices():
    names = ("a", "b", "c")
    plan = plan_panel([(n, get_config("tiny-llama")) for n in names],
                      ("j", get_config("tiny-gemma")), devices=_devs())
    jplan = jax_plan_panel([(n, jax_config("tiny-llama")) for n in names],
                           ("j", jax_config("tiny-gemma")))
    assert [p.role for p in plan.placements] == ["panel"] * 3 + ["judge"]
    for p, jp in zip(plan.placements, jplan.placements):
        assert (p.model, p.role, _ids(p.mesh), p.mesh.shape) == (
            jp.model, jp.role, [d.id for d in jp.mesh.devices.flat], dict(jp.mesh.shape))
    judge_devs = set(_ids(plan.for_model("j").mesh))
    for name in names:
        assert not judge_devs & set(_ids(plan.for_model(name).mesh))


# -- specs --------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-qwen2", "tiny-gemma", "tiny-mixtral"])
@pytest.mark.parametrize("axes", [{"dp": 1, "tp": 2}, {"dp": 2, "tp": 4}, {"dp": 1, "ep": 4, "tp": 2},
                                  {"dp": 2, "tp": 2, "sp": 2}, {"dp": 8}])
def test_spec_trees_equal_the_jax_trees(preset, axes):
    """param_specs, opt_moment_specs and cache_specs equal the JAX trees leaf for
    leaf (the degrade-to-replicated rule and the 3-axis vocab rule included)."""
    n = int(np.prod(list(axes.values())))
    mesh, jmesh = make_mesh(axes, _devs(n)), jax_make_mesh(axes, jax.devices()[:n])
    cfg, jcfg = get_config(preset), jax_config(preset)
    assert param_specs(cfg, mesh) == _spec_tuple(jax_param_specs(jcfg, jmesh))
    assert param_specs(cfg) == _spec_tuple(jax_param_specs(jcfg))
    assert opt_moment_specs(cfg, mesh) == _spec_tuple(jax_moment_specs(jcfg, jmesh))
    for batch in (1, 2):
        assert cache_specs(cfg, mesh, batch) == _spec_tuple(jax_cache_specs(jcfg, jmesh, batch))


# -- TP / EP numerical equivalence ----------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-qwen2", "tiny-gemma"])
def test_tp_forward_matches_unsharded(preset):
    jp, tree = _trees(preset, 0)
    tokens = _tokens(preset)
    tp = best_tp(get_config(preset), 4)
    got = _sharded_logits(preset, tree, {"dp": 2, "tp": tp}, tokens)
    np.testing.assert_allclose(got, _jax_logits(preset, jp, tokens), rtol=TOL, atol=TOL)


def test_ep_moe_forward_matches_unsharded():
    jp, tree = _trees("tiny-mixtral", 0)
    tokens = _tokens("tiny-mixtral")
    got = _sharded_logits("tiny-mixtral", tree, {"dp": 1, "ep": 4, "tp": 2}, tokens)
    np.testing.assert_allclose(got, _jax_logits("tiny-mixtral", jp, tokens), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("preset,axes", [("tiny-llama", {"tp": 4}), ("tiny-mixtral", {"tp": 2}),
                                         ("tiny-llama", {"dp": 2, "tp": 2, "sp": 2})])
def test_non_dividing_and_replicated_layouts_match_unsharded(preset, axes):
    """tp = 4 cuts tiny-llama's 2 KV heads (attention replicated, the
    projections gathered); experts over tp without an ep axis; the 3-axis
    mesh's replicated vocabulary."""
    jp, tree = _trees(preset, 2)
    tokens = _tokens(preset)
    got = _sharded_logits(preset, tree, axes, tokens)
    np.testing.assert_allclose(got, _jax_logits(preset, jp, tokens), rtol=TOL, atol=TOL)


def test_param_specs_degrade_when_indivisible():
    mesh, jmesh = make_mesh({"dp": 1, "tp": 8}, _devs()), jax_make_mesh({"dp": 1, "tp": 8})
    tiny = get_config("tiny-llama", vocab_size=510)
    specs = param_specs(tiny, mesh)
    assert specs["embed"] == (None, None)
    assert specs == _spec_tuple(jax_param_specs(jax_config("tiny-llama", vocab_size=510), jmesh))


def test_shards_round_trip_and_own_their_storage():
    """shard_pytree gives each position its block on its device, owning its
    storage (a KV shard is a contiguous tensor of its heads); gather_tree
    joins them back."""
    cfg = get_config("tiny-gemma")
    _jp, tree = _trees("tiny-gemma", 1)
    mesh = make_mesh({"dp": 2, "tp": 4}, _devs())
    specs = param_specs(cfg, mesh)
    shards = shard_pytree(tree, specs, mesh)
    assert shards[0]["layers"]["wq"].shape[-1] == tree["layers"]["wq"].shape[-1] // 4
    back = gather_tree(shards, specs, mesh)
    for k in tree["layers"]:
        assert torch.equal(back["layers"][k], tree["layers"][k])
    cache = init_kv_cache(cfg, 1, 32, device=CPU, dtype=torch.float32)
    cache["k"].normal_()
    kv = make_shard_fn(cfg, mesh)(cache)
    assert kv[1]["k"].shape[3] == cfg.n_kv_heads // 4 and kv[1]["k"].is_contiguous()
    assert kv[1]["k"].untyped_storage().data_ptr() != cache["k"].untyped_storage().data_ptr()
    assert torch.equal(kv[1]["k"], cache["k"][:, :, :, 1:2])
    # The collectives over one axis: every position ends with the sum or the
    # concatenation, on its own device.
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert [t.tolist() for t in all_reduce_sum(parts)] == [[6.0, 6.0]] * 4
    assert [t.tolist() for t in all_gather(parts, 0)] == [[0.0, 0.0, 1.0, 1.0, 2.0, 2.0,
                                                           3.0, 3.0]] * 4


# -- sharded decode through the Engine --------------------------------------------------


def _jax_tokens(preset: str, jp: dict, prompt: str, n: int, **kw) -> list:
    eng = JaxEngine(jax_config(preset), jp, dtype=jnp.float32, **kw)
    return eng.generate(prompt, JaxSampling(max_new_tokens=n)).token_ids


def test_sharded_engine_matches_unsharded_tokens():
    jp, tree = _trees("tiny-llama", 3)
    want = _jax_tokens("tiny-llama", jp, "consensus", 12)
    mesh = make_mesh({"dp": 1, "tp": 2}, _devs(2))
    got = Engine(get_config("tiny-llama"), tree, dtype=torch.float32, mesh=mesh)
    res = got.generate("consensus", SamplingParams(max_new_tokens=12))
    assert res.token_ids == want


def test_cache_specs_match_cache_tree():
    cfg = get_config("tiny-llama")
    mesh = make_mesh({"dp": 1, "tp": 2}, _devs(2))
    cache = init_kv_cache(cfg, batch=1, max_seq=64, device=CPU, dtype=torch.float32)
    shards = shard_pytree(cache, cache_specs(cfg, mesh), mesh)
    assert cache_specs(cfg, mesh) == _spec_tuple(
        jax_cache_specs(jax_config("tiny-llama"), jax_make_mesh({"dp": 1, "tp": 2},
                                                               jax.devices()[:2])))
    assert [s["k"].shape for s in shards] == [(cfg.n_layers, 1, 64, 1, cfg.head_dim)] * 2


def test_two_engines_on_disjoint_slices():
    """Panel semantics: two sharded engines coexist and agree with the JAX
    unsharded baselines."""
    slices = carve_slices(_devs(), [2, 2])
    out = {}
    for preset, seed, devs in (("tiny-llama", 1, slices[0]), ("tiny-qwen2", 2, slices[1])):
        jp, tree = _trees(preset, seed)
        eng = Engine(get_config(preset), tree, dtype=torch.float32,
                     mesh=make_mesh({"dp": 1, "tp": 2}, devs))
        out[preset] = (eng, _jax_tokens(preset, jp, "hello", 8))
    for preset, (eng, want) in out.items():
        assert eng.generate("hello", SamplingParams(max_new_tokens=8)).token_ids == want
