"""The port's ``Engine.generate_batch`` against the JAX engine's on the same
float32 weights: the seven cases of ``tests/test_batch.py``, each holding
the port's greedy tokens exactly equal to the JAX engine's (and, where the
JAX test does, to each prompt's solo run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llm_consensus_tpu_torch.engine import Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.parallel import make_mesh, virtual_devices

PROMPTS = [
    "short prompt",
    "a somewhat longer prompt about tensor parallelism on TPU pods",
    "mid-length prompt about consensus",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models, many small ops: one intra-op thread avoids oversubscribing
    the CPU when test files run in parallel workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_prefix_reuse(monkeypatch):
    # Solo runs compare fresh prefills (prefix reuse has its own tests).
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")


def _weights(seed=0):
    jcfg, tcfg = jax_config("tiny-llama"), get_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, torch.device("cpu"),
                           torch.float32)
    return jcfg, jp, tcfg, tp


def _pair(max_seq=128, seed=0, **kw):
    """The JAX and the port's engine on the same float32 weights."""
    jcfg, jp, tcfg, tp = _weights(seed)
    je = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=max_seq, **kw)
    te = Engine(tcfg, params=tp, dtype=torch.float32, max_seq=max_seq, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(results):
    return [r.token_ids for r in results]


def test_batch_matches_solo_runs(pair):
    """Right-aligned batching with row offsets is an execution-strategy
    change only: each row's greedy tokens equal its solo run and the JAX
    engine's batch row."""
    je, te = pair
    batch = te.generate_batch(PROMPTS, SamplingParams(max_new_tokens=10, ignore_eos=True))
    ref = je.generate_batch(PROMPTS, JaxSampling(max_new_tokens=10, ignore_eos=True))
    assert _ids(batch) == _ids(ref)
    for prompt, r, j in zip(PROMPTS, batch, ref):
        solo = te.generate(prompt, SamplingParams(max_new_tokens=10, ignore_eos=True))
        assert r.token_ids == solo.token_ids, prompt
        assert r.prompt_tokens == solo.prompt_tokens == j.prompt_tokens
        assert (r.text, r.finish_reason) == (j.text, j.finish_reason)


def test_batch_of_one_matches_generate(pair):
    je, te = pair
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    [r] = te.generate_batch([PROMPTS[0]], s)
    [j] = je.generate_batch([PROMPTS[0]], JaxSampling(max_new_tokens=8, ignore_eos=True))
    assert r.token_ids == te.generate(PROMPTS[0], s).token_ids == j.token_ids


def test_batch_with_int8_kv_cache():
    je, te = _pair(kv_quant="int8")
    results = te.generate_batch(PROMPTS[:2], SamplingParams(max_new_tokens=6, ignore_eos=True))
    ref = je.generate_batch(PROMPTS[:2], JaxSampling(max_new_tokens=6, ignore_eos=True))
    assert all(len(r.token_ids) == 6 for r in results)
    assert _ids(results) == _ids(ref)


def test_batch_with_weight_quant_and_sharding():
    """Over a tp 2 mesh the batch equals the unsharded engine's, in both
    packages, and the two packages agree."""
    jcfg, jp, tcfg, tp = _weights(seed=3)
    je = JaxEngine(jcfg, jp, dtype=jnp.float32, max_seq=128,
                   mesh=jax_make_mesh({"dp": 1, "tp": 2}, jax.devices()[:2]))
    te = Engine(tcfg, tp, dtype=torch.float32, max_seq=128,
                mesh=make_mesh({"dp": 1, "tp": 2}, virtual_devices(2, "cpu")))
    base = Engine(tcfg, tp, dtype=torch.float32, max_seq=128, device="cpu")
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    sharded = te.generate_batch(PROMPTS[:2], s)
    assert _ids(sharded) == _ids(base.generate_batch(PROMPTS[:2], s))
    assert _ids(sharded) == _ids(je.generate_batch(
        PROMPTS[:2], JaxSampling(max_new_tokens=8, ignore_eos=True)))


def test_batch_empty_list_and_bos_only_prompt(pair):
    je, te = pair
    assert te.generate_batch([]) == []
    # "" encodes to [BOS], a valid 1-token prompt, as in generate().
    s = SamplingParams(max_new_tokens=4, ignore_eos=True)
    [r] = te.generate_batch([""], s)
    [j] = je.generate_batch([""], JaxSampling(max_new_tokens=4, ignore_eos=True))
    assert r.token_ids == te.generate("", s).token_ids == j.token_ids


def test_batch_respects_max_new(pair):
    je, te = pair
    results = te.generate_batch(PROMPTS, SamplingParams(max_new_tokens=3, ignore_eos=True))
    for r in results:
        assert len(r.token_ids) == 3
        assert r.finish_reason == "length"
    assert _ids(results) == _ids(je.generate_batch(
        PROMPTS, JaxSampling(max_new_tokens=3, ignore_eos=True)))


def test_batch_chunked_prefill_matches_one_shot():
    """Long buckets prefill in chunks (row-aligned); results identical to
    the one-shot path, to solo runs and to the JAX engine's chunked batch."""
    je, e_chunk = _pair(max_seq=256, prefill_chunk=16)
    e_shot = Engine(e_chunk.cfg, params=e_chunk.params, dtype=torch.float32, max_seq=256,
                    prefill_chunk=0, device="cpu")
    long_prompts = [
        "a " * 40,                       # ~81 ids
        "the quick brown fox " * 6,      # ~121 ids
    ]
    s = SamplingParams(max_new_tokens=8, ignore_eos=True)
    chunked = e_chunk.generate_batch(long_prompts, s)
    oneshot = e_shot.generate_batch(long_prompts, s)
    assert _ids(chunked) == _ids(oneshot)
    assert _ids(chunked) == _ids(je.generate_batch(
        long_prompts, JaxSampling(max_new_tokens=8, ignore_eos=True)))
    for p, r in zip(long_prompts, chunked):
        assert r.token_ids == e_shot.generate(p, s).token_ids
