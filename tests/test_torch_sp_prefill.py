"""Sequence-parallel (ring attention) prefill through the port's Engine, held to
``tests/test_sp_prefill.py`` case by case: the JAX engine (unsharded, or on
its sp mesh where the JAX test builds one) and the port's engine on
``virtual_devices(n, "cpu")`` from the same numpy weights; greedy tokens
equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.models.config import get_config as jax_config
from llm_consensus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import (
    ShardGroup, forward_ring_prefill, params_from_numpy)
from llm_consensus_tpu_torch.parallel import make_mesh, param_specs, shard_pytree, virtual_devices

PROMPT = "Explain the difference between data and tensor parallelism. " * 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread beside other xdist
    workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(preset: str, seed: int):
    jp = jax_init(jax_config(preset), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), get_config(preset), CPU,
                                 torch.float32)


def _mesh(axes: dict):
    return make_mesh(axes, virtual_devices(int(np.prod(list(axes.values()))), "cpu"))


def _port(preset, tree, axes, n=12, prompt=PROMPT, **kw):
    kw.setdefault("max_seq", 256)
    eng = Engine(get_config(preset), tree, dtype=torch.float32, mesh=_mesh(axes), **kw)
    r = eng.generate(prompt, SamplingParams(max_new_tokens=n, ignore_eos=True))
    assert len(r.token_ids) == n
    return r.token_ids, eng


def _jax(preset, jp, n=12, prompt=PROMPT, **kw):
    kw.setdefault("max_seq", 256)
    r = JaxEngine(jax_config(preset), jp, dtype=jnp.float32, **kw).generate(
        prompt, JaxSampling(max_new_tokens=n, ignore_eos=True))
    return r.token_ids


@pytest.fixture(scope="module")
def llama11():
    jp, tree = _trees("tiny-llama", 11)
    return tree, _jax("tiny-llama", jp)


def test_sp_prefill_matches_unsharded(llama11, monkeypatch):
    tree, want = llama11
    calls = []
    import llm_consensus_tpu_torch.engine.engine as eng_mod

    real = eng_mod.forward_ring_prefill
    monkeypatch.setattr(eng_mod, "forward_ring_prefill",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = _port("tiny-llama", tree, {"sp": 2})
    assert got == want
    assert calls == [1]  # the prompt prefilled by ring attention


def test_sp_tp_prefill_matches_unsharded(llama11):
    """sp x tp compose: the ring over sp with heads split over tp."""
    tree, want = llama11
    assert _port("tiny-llama", tree, {"sp": 2, "tp": 2})[0] == want


def test_sp_prefill_with_int8_kv_cache():
    """The int8 cache under ring prefill: the port's tokens equal the JAX sp
    engine's (both write the ring's fresh K/V as codes and scales)."""
    jp, tree = _trees("tiny-llama", 0)
    got, _ = _port("tiny-llama", tree, {"sp": 2}, n=8, kv_quant="int8")
    want = _jax("tiny-llama", jp, n=8, kv_quant="int8",
                mesh=jax_make_mesh({"sp": 2}, jax.devices()[:2]))
    assert len(got) == 8 and got == want


def test_sp_prefill_sliding_window_model():
    jp, tree = _trees("tiny-mistral", 13)
    assert _port("tiny-mistral", tree, {"sp": 2})[0] == _jax("tiny-mistral", jp)


def test_ring_forward_rejects_bad_call():
    cfg = get_config("tiny-llama")
    _jp, tree = _trees("tiny-llama", 0)
    mesh = _mesh({"sp": 2})
    specs = param_specs(cfg, mesh)
    shards = shard_pytree(tree, specs, mesh)
    groups = [ShardGroup(cfg, mesh, shards, specs, {"sp": s}) for s in range(2)]
    caches = groups[0].new_caches(1, 64, torch.float32, None)
    with pytest.raises(ValueError, match="ring"):
        forward_ring_prefill(groups, torch.ones((1, 15), dtype=torch.long), caches)


def test_sp_falls_back_when_bucket_not_divisible(monkeypatch):
    """max_seq 250 at sp 4: a long prompt's bucket clamps to 250, which does
    not split over sp, so the engine takes the replicated path and still
    matches the unsharded engine."""
    jp, tree = _trees("tiny-llama", 17)
    prompt = "y" * 200
    import llm_consensus_tpu_torch.engine.engine as eng_mod

    monkeypatch.setattr(eng_mod, "forward_ring_prefill",
                        lambda *a, **k: pytest.fail("ring prefill on a non-dividing bucket"))
    got, _ = _port("tiny-llama", tree, {"sp": 4}, n=6, prompt=prompt, max_seq=250,
                   prefill_chunk=0)
    assert got == _jax("tiny-llama", jp, n=6, prompt=prompt, max_seq=250, prefill_chunk=0)


def test_sp_with_non_dividing_tp_replicates_heads():
    """tiny-llama has 2 KV heads; tp 4 cannot split them, so the ring runs with
    the heads whole on each sp position."""
    cfg = get_config("tiny-llama")
    assert cfg.n_kv_heads % 4 != 0
    jp, tree = _trees("tiny-llama", 19)
    got, eng = _port("tiny-llama", tree, {"sp": 2, "tp": 4}, n=8)
    assert not eng._groups[0].heads
    assert got == _jax("tiny-llama", jp, n=8)
