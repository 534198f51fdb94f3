"""The port's GPipe pipeline (``parallel/pipeline.py``) held to
``tests/test_pipeline.py`` case by case: the same numpy weights and tokens
through the JAX plain forward (and its gradients) and the port's pipelined
forward over ``virtual_devices(n, "cpu")``. Tolerances, the JAX file's:
logits within 1e-4, gradients within 1e-3 relative / 1e-4 absolute."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import forward as jax_forward
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.train.loss import cross_entropy_loss as jax_ce
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import param_leaves, params_from_numpy
from llm_consensus_tpu_torch.parallel import make_mesh, pipeline_forward, virtual_devices
from llm_consensus_tpu_torch.parallel.pipeline import dryrun_pipeline
from llm_consensus_tpu_torch.train.loss import cross_entropy_loss

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread beside other xdist workers (restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n_layers=4, batch=8, seq=16, name="tiny-llama"):
    jcfg = jax_config(name, n_layers=n_layers)
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), get_config(name, n_layers=n_layers),
                             CPU, torch.float32)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (batch, seq))
    return jcfg, jp, get_config(name, n_layers=n_layers), tree, tokens


def _mesh(pp):
    return make_mesh({"pp": pp}, virtual_devices(pp, "cpu"))


def _jax_logits(jcfg, jp, tokens):
    return np.asarray(jax_forward(jp, jcfg, jnp.asarray(tokens, jnp.int32))[0])


@pytest.mark.parametrize("pp,microbatches", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_matches_plain_forward(pp, microbatches):
    jcfg, jp, cfg, tree, tokens = _setup()
    with torch.no_grad():
        out = pipeline_forward(tree, cfg, torch.tensor(tokens), _mesh(pp),
                               microbatches=microbatches)
    np.testing.assert_allclose(out.numpy(), _jax_logits(jcfg, jp, tokens), rtol=1e-4, atol=1e-4)


def test_gemma_family():
    jcfg, jp, cfg, tree, tokens = _setup(name="tiny-gemma")
    with torch.no_grad():
        out = pipeline_forward(tree, cfg, torch.tensor(tokens), _mesh(2), microbatches=2)
    np.testing.assert_allclose(out.numpy(), _jax_logits(jcfg, jp, tokens), rtol=1e-4, atol=1e-4)


def test_gradients_match():
    """Gradients flow through the stage-to-stage copies: the pipelined loss's
    gradients equal the JAX plain forward's."""
    jcfg, jp, cfg, tree, tokens = _setup()
    targets = np.roll(tokens, -1, axis=1)
    leaves = [w.requires_grad_(True) for _n, w in param_leaves(tree)]
    loss = cross_entropy_loss(pipeline_forward(tree, cfg, torch.tensor(tokens), _mesh(2),
                                               microbatches=4), torch.tensor(targets))
    loss.backward()
    g_ref = jax.grad(lambda p: jax_ce(jax_forward(p, jcfg, jnp.asarray(tokens, jnp.int32))[0],
                                      jnp.asarray(targets, jnp.int32)))(jp)
    ref = dict(param_leaves(params_from_numpy(jax.tree.map(np.asarray, g_ref), cfg, CPU,
                                              torch.float32)))
    assert all(w.grad is not None for w in leaves)
    for name, w in param_leaves(tree):
        np.testing.assert_allclose(w.grad.numpy(), ref[name].numpy(), rtol=1e-3, atol=1e-4)


def test_rejects_bad_divisibility():
    _jcfg, _jp, cfg, tree, tokens = _setup(n_layers=4, batch=6)
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(tree, cfg, torch.tensor(tokens), mesh, microbatches=4)
    _j, _p, cfg3, tree3, _t = _setup(n_layers=3)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_forward(tree3, cfg3, torch.tensor(tokens[:8]), mesh)
    with pytest.raises(ValueError, match="resident per stage"):
        pipeline_forward(tree, cfg, torch.tensor(tokens), mesh, microbatches=3)


def test_stage_sharded_boundary_queues():
    """v2's layout: microbatch g waits on stage g % S and its output lands
    there (each stage holds 1/S of the batch at each end); a wrong round
    trip would permute whole microbatches, so row-for-row parity pins it."""
    jcfg, jp, cfg, tree, tokens = _setup()
    mesh = make_mesh({"pp": 4}, virtual_devices(4, "cpu"))
    with torch.no_grad():
        out = pipeline_forward(tree, cfg, torch.tensor(tokens), mesh, microbatches=8)
    np.testing.assert_allclose(out.numpy(), _jax_logits(jcfg, jp, tokens), rtol=1e-4, atol=1e-4)


def test_dryrun(capsys):
    dryrun_pipeline(8, devices=virtual_devices(8, "cpu"))
    assert "pipeline pp=" in capsys.readouterr().out
