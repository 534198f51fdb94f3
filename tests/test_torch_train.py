"""The port's training layer (``train/loss.py``, ``train/step.py`` and the
distillation step of ``flywheel/distill.py``) held to ``tests/test_train.py``
case by case, on one device (the CPU), and to the JAX step itself.

The JAX file's mesh cases (``test_sharded_matches_single_device``,
``test_moe_with_expert_axis``, ``test_dp1_vs_dp2_gradient_parity``,
``test_opt_state_dp_sharded``) run over ``virtual_devices(8, "cpu")``
against the JAX results.

Tolerances, stated once: a loss is held to the JAX step's within 1e-5
relative; parameters after one to three steps within 5 % of one step's
largest update (``TOL_UPDATE``), in float32 on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_consensus_tpu.flywheel.distill import init_distill_state as jax_init_distill
from llm_consensus_tpu.flywheel.distill import make_distill_step as jax_distill_step
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.train import cross_entropy_loss as jax_ce
from llm_consensus_tpu.train import distill_loss as jax_distill_loss
from llm_consensus_tpu.train import make_train_step as jax_train_step
from llm_consensus_tpu.train.step import TrainState as JaxTrainState
from llm_consensus_tpu.train.step import default_optimizer as jax_default_optimizer
from llm_consensus_tpu_torch.flywheel.distill import init_distill_state, make_distill_step
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.train import (
    cross_entropy_loss, default_optimizer, distill_loss, init_train_state, make_train_step)
from llm_consensus_tpu_torch.train.step import sgd

PRESET = "tiny-llama"
CPU = torch.device("cpu")
RTOL_LOSS = 1e-5
TOL_UPDATE = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_np(seed: int, vocab: int, batch: int = 2, seq: int = 16) -> dict:
    """The JAX file's ``_batch`` (tokens, targets rolled by one, last mask
    position dead), drawn with numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": mask}


def _torch_batch(b: dict) -> dict:
    return {"tokens": torch.tensor(b["tokens"], dtype=torch.long),
            "targets": torch.tensor(b["targets"], dtype=torch.long),
            "mask": torch.tensor(b["mask"])}


def _jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _trees(seed: int):
    jp = jax_init(jax_config(PRESET), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(PRESET), CPU,
                                 torch.float32)


@pytest.fixture(scope="module")
def trees():
    return {0: _trees(0), 7: _trees(7)}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _hold_params(port_params, jax_params, before):
    """Every leaf within TOL_UPDATE of the largest single-leaf update."""
    jflat = dict(_flat(jax.tree.map(np.asarray, jax_params)))
    bflat = dict(_flat(jax.tree.map(np.asarray, before)))
    pflat = {k: v.detach().numpy() for k, v in _flat(port_params)}
    assert set(pflat) == set(jflat)
    step = max(float(np.abs(jflat[k] - bflat[k]).max()) for k in jflat)
    assert step > 0
    worst = max(float(np.abs(pflat[k] - jflat[k]).max()) for k in jflat)
    assert worst <= TOL_UPDATE * step, (worst, step)


# -- cross-entropy (TestCrossEntropy) ---------------------------------------------------------


def test_uniform_logits_give_log_vocab():
    v = 64
    got = float(cross_entropy_loss(torch.zeros(1, 8, v), torch.zeros(1, 8, dtype=torch.long)))
    np.testing.assert_allclose(got, np.log(v), rtol=1e-5)
    assert abs(got - float(jax_ce(jnp.zeros((1, 8, v)), jnp.zeros((1, 8), jnp.int32)))) < 1e-5


def test_perfect_prediction_near_zero():
    targets = torch.arange(8)[None, :]
    logits = torch.nn.functional.one_hot(targets, 32).float() * 100.0
    assert float(cross_entropy_loss(logits, targets)) < 1e-3


def test_mask_excludes_positions():
    logits = torch.zeros(1, 4, 16)
    logits[0, 0, 0] = 100.0
    mask = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    assert float(cross_entropy_loss(logits, torch.zeros(1, 4, dtype=torch.long), mask)) < 1e-3


def test_cross_entropy_matches_jax_on_random_logits():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 32)).astype(np.float32) * 3
    targets = rng.integers(0, 32, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = float(cross_entropy_loss(torch.tensor(logits), torch.tensor(targets),
                                       None if m is None else torch.tensor(m)))
        want = float(jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                            None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)


# -- the train step (TestTrainStep, single device) --------------------------------------------


def test_loss_decreases_single_device(trees):
    cfg = get_config(PRESET)
    state = init_train_state(cfg, optimizer=default_optimizer(lr=1e-2), params=trees[0][1])
    step = make_train_step(cfg, remat=False)
    batch = _torch_batch(_batch_np(1, cfg.vocab_size))
    state, first = step(state, batch)
    for _ in range(10):
        state, metrics = step(state, batch)
    assert metrics["loss"] < first["loss"]
    assert state.step == 11


def test_remat_matches_no_remat(trees):
    """Per-layer activation checkpointing changes memory, not math: one SGD
    step's loss and parameters equal the plain forward's."""
    cfg = get_config(PRESET)
    batch = _torch_batch(_batch_np(1, cfg.vocab_size))
    out = []
    for remat in (False, True):
        state = init_train_state(cfg, optimizer=sgd(1e-2), params=trees[0][1])
        state, metrics = make_train_step(cfg, remat=remat)(state, batch)
        out.append((state, metrics["loss"]))
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-6)
    for (name, a), (_n, b) in zip(_flat(out[0][0].params), _flat(out[1][0].params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_the_train_state_copies_an_adopted_tree(trees):
    """Training updates its own copy: the tree it was given is untouched."""
    cfg = get_config(PRESET)
    before = trees[0][1]["embed"].clone()
    state = init_train_state(cfg, optimizer=sgd(1e-1), params=trees[0][1])
    make_train_step(cfg, remat=False)(state, _torch_batch(_batch_np(1, cfg.vocab_size)))
    assert torch.equal(trees[0][1]["embed"], before)
    assert not torch.equal(state.params["embed"], before)


def test_three_adamw_steps_follow_the_jax_step(trees):
    """The default optimizer (clip 1.0, AdamW b1 0.9 b2 0.95 wd 0.1), three
    steps in float32: losses and gradient norms within 1e-5 relative of the
    JAX step's, parameters within 5 % of one step's largest update."""
    cfg, jcfg = get_config(PRESET), jax_config(PRESET)
    jp, tp = trees[0]
    b = _batch_np(1, cfg.vocab_size)
    opt = jax_default_optimizer(lr=1e-2)
    jp = jax.tree.map(jnp.array, jp)  # the JAX step donates its state: a copy
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                           opt_state=jax.jit(opt.init)(jp))
    jstep = jax_train_step(jcfg, opt, remat=False)
    state = init_train_state(cfg, optimizer=default_optimizer(lr=1e-2), params=tp)
    step = make_train_step(cfg, remat=True)
    for _ in range(3):
        prev = jax.tree.map(np.asarray, jstate.params)
        jstate, jm = jstep(jstate, _jax_batch(b))
        state, m = step(state, _torch_batch(b))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=RTOL_LOSS)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=RTOL_LOSS)
    _hold_params(state.params, jstate.params, prev)


# -- the distillation loss (TestDistillLoss) ----------------------------------------------------


def _logits(seed: int, b: int = 2, t: int = 8, v: int = 32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, v)).astype(np.float32),
            rng.standard_normal((b, t, v)).astype(np.float32))


def test_alpha_mixes_kl_and_ce():
    s, tch = (torch.tensor(x) for x in _logits(0))
    targets = torch.zeros(2, 8, dtype=torch.long)
    loss, aux = distill_loss(s, tch, targets, alpha=0.3)
    np.testing.assert_allclose(float(loss), 0.3 * float(aux["kl"]) + 0.7 * float(aux["ce"]),
                               rtol=1e-5)
    pure_kl, _ = distill_loss(s, tch, targets, alpha=1.0)
    np.testing.assert_allclose(float(pure_kl), float(aux["kl"]), rtol=1e-5)
    pure_ce, _ = distill_loss(s, tch, targets, alpha=0.0)
    np.testing.assert_allclose(float(pure_ce), float(aux["ce"]), rtol=1e-5)


def test_matching_teacher_zero_kl():
    s = torch.tensor(_logits(1)[0])
    for temp in (1.0, 2.0, 4.0):
        _loss, aux = distill_loss(s, s, torch.zeros(2, 8, dtype=torch.long), temperature=temp)
        assert abs(float(aux["kl"])) < 1e-5, (temp, aux)


def test_mask_gates_both_halves():
    s, tch = (torch.tensor(x) for x in _logits(2, b=1, t=4))
    targets = torch.zeros(1, 4, dtype=torch.long)
    s[0, 1:, :] = 0.0
    s[0, 1:, 1] = 100.0
    tch[0, 1:, :] = 0.0
    tch[0, 1:, 2] = 100.0
    mask = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    masked, aux_m = distill_loss(s, tch, targets, mask)
    only_first, aux_f = distill_loss(s[:, :1, :], tch[:, :1, :], targets[:, :1])
    np.testing.assert_allclose(float(masked), float(only_first), rtol=1e-5)
    np.testing.assert_allclose(float(aux_m["kl"]), float(aux_f["kl"]), rtol=1e-5)


def test_temperature_softens_kl():
    s, tch = (torch.tensor(x) * 10.0 for x in _logits(3))
    targets = torch.zeros(2, 8, dtype=torch.long)
    _l1, aux1 = distill_loss(s, tch, targets, temperature=1.0)
    _l4, aux4 = distill_loss(s, tch, targets, temperature=4.0)
    assert float(aux1["kl"]) > 0 and float(aux4["kl"]) > 0
    assert 0.1 < float(aux1["kl"]) / float(aux4["kl"]) < 10.0


def test_teacher_logits_carry_no_gradient():
    s, tch = (torch.tensor(x) for x in _logits(4))
    tch.requires_grad_(True)
    s.requires_grad_(True)
    loss, _ = distill_loss(s, tch, torch.zeros(2, 8, dtype=torch.long), alpha=1.0)
    loss.backward()
    assert tch.grad is None and s.grad is not None and float(s.grad.abs().sum()) > 0


@pytest.mark.parametrize("temperature,alpha", [(2.0, 0.5), (1.0, 0.3), (4.0, 1.0)])
def test_distill_loss_matches_jax(temperature, alpha):
    s, tch = _logits(5)
    targets = np.random.default_rng(6).integers(0, 32, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[:, :3] = 0.0
    loss, aux = distill_loss(torch.tensor(s), torch.tensor(tch), torch.tensor(targets),
                             torch.tensor(mask), temperature=temperature, alpha=alpha)
    jl, jaux = jax_distill_loss(jnp.asarray(s), jnp.asarray(tch), jnp.asarray(targets),
                                jnp.asarray(mask), temperature=temperature, alpha=alpha)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL_LOSS)
    for k in ("kl", "ce"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=RTOL_LOSS)


# -- the distillation step (TestDistillStep, one device) ----------------------------------------


def test_distill_step_follows_the_jax_step(trees):
    """One SGD step of the distillation objective (the JAX test's
    stateless optimizer, so parity is unclouded by moments), student seed 0
    and teacher seed 7: loss, KL, CE and gradient norm within 1e-5
    relative; parameters within 5 % of the step's largest update."""
    cfg, jcfg = get_config(PRESET), jax_config(PRESET)
    b = _batch_np(1, cfg.vocab_size, batch=4)
    jstate = jax_init_distill(jcfg, jax.random.PRNGKey(0), optax.sgd(1e-2), dtype=jnp.float32,
                              params=jax.tree.map(jnp.array, trees[0][0]))  # donated
    jstate, jm = jax_distill_step(jcfg, jcfg, optax.sgd(1e-2), remat=False, alpha=0.5)(
        jstate, trees[7][0], _jax_batch(b))
    state = init_distill_state(cfg, optimizer=sgd(1e-2), dtype=torch.float32,
                               params=trees[0][1])
    state, m = make_distill_step(cfg, cfg, remat=True, alpha=0.5)(
        state, trees[7][1], _torch_batch(b))
    for k in ("loss", "kl", "ce", "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=RTOL_LOSS, err_msg=k)
    _hold_params(state.params, jstate.params, trees[0][0])


def test_distill_loss_and_kl_decrease(trees):
    """Pure KL (alpha 1): nine steps of the default optimizer lower both
    the loss and the KL on one batch (the JAX test's, on one device)."""
    cfg = get_config(PRESET)
    state = init_distill_state(cfg, optimizer=default_optimizer(lr=1e-2), dtype=torch.float32,
                               params=trees[0][1])
    step = make_distill_step(cfg, cfg, alpha=1.0)
    batch = _torch_batch(_batch_np(2, cfg.vocab_size, batch=4))
    state, first = step(state, trees[7][1], batch)
    for _ in range(8):
        state, metrics = step(state, trees[7][1], batch)
    assert metrics["loss"] < first["loss"] and metrics["kl"] < first["kl"]


# -- the mesh cases (TestTrainStep / TestDistillStep over a mesh) ---------------------------


def _vdevs(axes: dict):
    from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

    return make_mesh(axes, virtual_devices(int(np.prod(list(axes.values()))), "cpu"))


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 4}, {"dp": 2, "tp": 2, "sp": 2}, {"dp": 8}])
def test_sharded_matches_single_device(trees, axes):
    """One SGD step over a mesh of virtual CPU positions (tp-sharded params,
    dp rows whose gradients all-reduce): the loss within the JAX file's 5e-4
    of the JAX single-device step's, the gathered parameters within 5 % of
    its largest update."""
    cfg, jcfg = get_config(PRESET), jax_config(PRESET)
    b = _batch_np(1, cfg.vocab_size, batch=4)
    opt = optax.sgd(1e-2)
    jp = jax.tree.map(jnp.array, trees[0][0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=opt.init(jp))
    jstate, jm = jax_train_step(jcfg, opt, remat=False)(jstate, _jax_batch(b))
    mesh = _vdevs(axes)
    state = init_train_state(cfg, optimizer=sgd(1e-2), params=trees[0][1], mesh=mesh,
                             dtype=torch.float32)
    state, m = make_train_step(cfg, remat=False, mesh=mesh)(state, _torch_batch(b))
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=5e-4)
    _hold_params(state.tree(), jstate.params, trees[0][0])


def test_moe_with_expert_axis():
    """tiny-mixtral over dp 2 x ep 4 (experts over ep, the router whole on
    every position): the first step's loss equals the JAX single-device
    step's within 5e-4, and six steps of the default optimizer lower it."""
    from llm_consensus_tpu_torch.train.step import default_optimizer as port_default

    cfg, jcfg = get_config("tiny-mixtral"), jax_config("tiny-mixtral")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, CPU, torch.float32)
    b = _batch_np(1, cfg.vocab_size)
    opt = jax_default_optimizer(lr=1e-2)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=opt.init(jp))
    _, jm = jax_train_step(jcfg, opt, remat=False)(jstate, _jax_batch(b))
    mesh = _vdevs({"dp": 2, "ep": 4})
    state = init_train_state(cfg, optimizer=port_default(lr=1e-2), params=tree, mesh=mesh,
                             dtype=torch.float32)
    step = make_train_step(cfg, mesh=mesh)
    state, first = step(state, _torch_batch(b))
    np.testing.assert_allclose(first["loss"], float(jm["loss"]), rtol=5e-4)
    for _ in range(5):
        state, metrics = step(state, _torch_batch(b))
    assert metrics["loss"] < first["loss"]
    assert np.isfinite(metrics["grad_norm"])


def test_dp1_vs_dp2_gradient_parity(trees):
    """The distillation step over dp 2 x tp 4 against the JAX step on one
    device (the JAX file's tolerances: loss 2e-3, gradient norm 5e-3, the
    first parameter leaf 2e-3 / 5e-4)."""
    cfg, jcfg = get_config(PRESET), jax_config(PRESET)
    b = _batch_np(1, cfg.vocab_size, batch=4)
    jstate = jax_init_distill(jcfg, jax.random.PRNGKey(0), optax.sgd(1e-2), dtype=jnp.float32,
                              params=jax.tree.map(jnp.array, trees[0][0]))
    jstate, jm = jax_distill_step(jcfg, jcfg, optax.sgd(1e-2), remat=False, alpha=0.5)(
        jstate, trees[7][0], _jax_batch(b))
    mesh = _vdevs({"dp": 2, "tp": 4})
    state = init_distill_state(cfg, optimizer=sgd(1e-2), dtype=torch.float32,
                               params=trees[0][1], mesh=mesh)
    state, m = make_distill_step(cfg, cfg, remat=False, alpha=0.5, mesh=mesh)(
        state, trees[7][1], _torch_batch(b))
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=2e-3)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=5e-3)
    got = dict(_flat({k: v.detach() for k, v in _flat(state.tree())}))
    want = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
    first = sorted(want)[0]
    np.testing.assert_allclose(got[first].numpy(), want[first], rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 4}, {"dp": 2, "tp": 2, "sp": 2}])
def test_opt_state_dp_sharded(axes):
    """AdamW's moments take their parameters' specs widened over dp (ZeRO-1):
    the spec trees equal the JAX optimizer state's mu/nu shardings leaf for
    leaf, and the 2-D+ moments carry "dp"."""
    from llm_consensus_tpu.flywheel.distill import opt_state_shardings as jax_shardings
    from llm_consensus_tpu.models import init_params
    from llm_consensus_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from llm_consensus_tpu_torch.flywheel.distill import opt_state_shardings
    from llm_consensus_tpu_torch.train.step import default_optimizer as port_default

    cfg = get_config(PRESET)
    n = int(np.prod(list(axes.values())))
    got = opt_state_shardings(port_default(), cfg, _vdevs(axes))
    assert set(got) == {"mu", "nu"}
    jmesh = jax_make_mesh(axes, jax.devices()[:n])
    params = jax.eval_shape(lambda: init_params(jax_config(PRESET), jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(
        jax_shardings(optax.adamw(1e-3), params, jax_config(PRESET), jmesh))[0]
    for moment in ("mu", "nu"):
        want = {}
        for path, sh in flat:
            names = [getattr(e, "name", None) for e in path]
            if moment in names:
                keys = [getattr(e, "key", None) for e in path[names.index(moment) + 1:]]
                want["/".join(keys)] = tuple(sh.spec)
        mine = {k: v for k, v in _flat(got[moment])}
        assert mine == want, moment
        assert any("dp" in spec for k, spec in mine.items() if len(spec) >= 2)
    assert opt_state_shardings(sgd(1e-2), cfg, _vdevs(axes)) == {}
