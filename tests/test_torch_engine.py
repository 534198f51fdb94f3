"""The port's Engine against the JAX Engine on the same float32 weights.

Greedy tokens must be identical on the one-shot prefill path and on the
chunked one (a prompt longer than ``prefill_chunk``), with the JAX
engine's own test settings (tiny-llama, float32, max_seq 128). Also the
engine's host contract: prompt truncation, finish reasons, streamed text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.engine import Engine as JaxEngine
from llm_consensus_tpu.engine import SamplingParams as JaxSampling
from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu_torch.engine import ByteTokenizer, Engine, SamplingParams
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models.transformer import params_from_numpy
from llm_consensus_tpu_torch.utils.context import Context

SHORT = "the quick brown fox jumps over the lazy dog"
LONG = "a long prompt that spans several prefill chunks: " + "tokens " * 12


@pytest.fixture(autouse=True)
def _no_prefix_reuse(monkeypatch):
    # Each JAX generate a fresh prefill: these tests compare single
    # generates (prefix reuse is held to JAX in test_torch_prefix_reuse.py).
    monkeypatch.setenv("LLMC_PREFIX_CACHE", "0")


def _engines(head_dim=None, prefill_chunk=512, max_seq=128, preset="tiny-llama",
             overrides=None, edit=None, **kw):
    """The JAX and the port's engine on the same float32 weights; ``edit``
    may change the JAX tree first."""
    over = dict(overrides or {})
    if head_dim is not None:
        over["head_dim"] = head_dim
    jcfg, tcfg = jax_config(preset, **over), get_config(preset, **over)
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if edit is not None:
        jp = edit(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, torch.device("cpu"),
                           torch.float32)
    je = JaxEngine(jcfg, params=jp, dtype=jnp.float32, max_seq=max_seq,
                   prefill_chunk=prefill_chunk, **kw)
    te = Engine(tcfg, params=tp, dtype=torch.float32, max_seq=max_seq,
                prefill_chunk=prefill_chunk, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def port_engine():
    return Engine(get_config("tiny-llama"), dtype=torch.float32, max_seq=128, device="cpu")


@pytest.mark.parametrize("head_dim", [None, 128])
@pytest.mark.parametrize("prompt,chunk", [(SHORT, 512), (LONG, 32)],
                         ids=["one-shot", "chunked"])
def test_greedy_tokens_identical_to_jax(head_dim, prompt, chunk):
    je, te = _engines(head_dim, prefill_chunk=chunk)
    n_prompt = len(te.tokenizer.encode(prompt))
    assert (n_prompt > chunk) == (chunk == 32)  # the long case takes the chunked path
    a = je.generate(prompt, JaxSampling(max_new_tokens=40, ignore_eos=True))
    b = te.generate(prompt, SamplingParams(max_new_tokens=40, ignore_eos=True))
    assert b.token_ids == a.token_ids
    assert b.text == a.text
    assert (b.finish_reason, b.prompt_tokens) == (a.finish_reason, a.prompt_tokens)


@pytest.mark.parametrize("prompt,chunk", [(SHORT, 512), (LONG, 32)],
                         ids=["one-shot", "chunked"])
def test_gemma_head_dim_256_greedy_tokens_identical_to_jax(monkeypatch, prompt, chunk):
    """tiny-gemma at gemma-7b's head width (256): 16 greedy tokens equal the
    JAX engine's (its Pallas kernels in interpret mode), one-shot and
    chunked; the port's one-shot prefill takes the flash route and every
    T = 1 step the decode kernel's (their plain versions on the CPU), a
    chunked prefill the plain op, as in JAX."""
    import llm_consensus_tpu_torch.models.transformer as tr

    calls = {"flash_attention": [], "decode_attention": []}
    for name, seen in calls.items():
        real = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda q, *a, _r=real, _s=seen, **k: (
            _s.append(tuple(q.shape)), _r(q, *a, **k))[1])
    je, te = _engines(prefill_chunk=chunk, preset="tiny-gemma", overrides={"head_dim": 256})
    a = je.generate(prompt, JaxSampling(max_new_tokens=16, ignore_eos=True))
    b = te.generate(prompt, SamplingParams(max_new_tokens=16, ignore_eos=True))
    assert b.token_ids == a.token_ids and len(b.token_ids) == 16
    n_layers = te.cfg.n_layers
    flash = calls["flash_attention"]
    assert len(flash) == (n_layers if chunk == 512 else 0)
    assert all(shape[3] == 256 for shape in flash + calls["decode_attention"])
    assert len(calls["decode_attention"]) >= 15 * n_layers


def test_stream_interval_one_equals_sixteen():
    _, te = _engines()
    te1 = Engine(te.cfg, params=te.params, dtype=torch.float32, max_seq=128,
                 stream_interval=1, device="cpu")
    sp = SamplingParams(max_new_tokens=20, ignore_eos=True)
    assert te1.generate(SHORT, sp).token_ids == te.generate(SHORT, sp).token_ids


def test_prompt_truncated_middle_out_like_jax():
    je, te = _engines()
    prompt = "start-marker " + "filler words here " * 40 + " end-marker"
    ids = te.tokenizer.encode(prompt)
    assert te._budget_prompt(ids, 8) == je._budget_prompt(ids, 8)
    result = te.generate(prompt, SamplingParams(max_new_tokens=8))
    assert result.truncated_prompt and result.prompt_tokens < 128
    assert not te.generate("hi", SamplingParams(max_new_tokens=4)).truncated_prompt


def test_finish_reason_eos_matches_jax():
    """Make the 5th greedy token the EOS id: both engines stop before it."""
    je, te = _engines()
    sp = dict(max_new_tokens=30, ignore_eos=True)
    ref = te.generate(SHORT, SamplingParams(**sp)).token_ids
    eos = ref[4]
    stop = ref.index(eos)
    for eng in (je, te):
        tok = ByteTokenizer()
        tok.eos_id = eos
        eng.tokenizer = tok
    a = je.generate(SHORT, JaxSampling(max_new_tokens=30))
    b = te.generate(SHORT, SamplingParams(max_new_tokens=30))
    assert b.finish_reason == a.finish_reason == "eos"
    assert b.token_ids == a.token_ids == ref[:stop]


def test_finish_reason_length(port_engine):
    r = port_engine.generate_ids(port_engine.tokenizer.encode("a"),
                                 SamplingParams(max_new_tokens=8, ignore_eos=True))
    assert r.finish_reason == "length" and len(r.token_ids) == 8


def test_finish_reason_deadline(port_engine):
    ctx = Context.background().with_timeout(0.0)
    r = port_engine.generate_ids(port_engine.tokenizer.encode("hello"),
                                 SamplingParams(max_new_tokens=64), ctx=ctx)
    assert r.finish_reason == "deadline"


def test_finish_reason_cancelled(port_engine):
    ctx = Context.background().with_cancel()
    seen = []

    def on_token(t):
        seen.append(t)
        if len(seen) == 4:
            ctx.cancel()

    r = port_engine.generate_ids(port_engine.tokenizer.encode("hello"),
                                 SamplingParams(max_new_tokens=64, ignore_eos=True),
                                 ctx=ctx, on_token=on_token)
    assert r.finish_reason == "cancelled"
    assert 4 <= len(r.token_ids) < 64


def test_streamed_text_equals_result(port_engine):
    chunks = []
    r = port_engine.generate("hi there", SamplingParams(max_new_tokens=24),
                             on_text=chunks.append)
    assert "".join(chunks) == r.text


def test_prompt_errors(port_engine):
    with pytest.raises(ValueError, match="empty prompt"):
        port_engine.generate_ids([], SamplingParams())
    with pytest.raises(ValueError, match="exceeds max sequence length"):
        port_engine.generate_ids(list(range(200)), SamplingParams())


def test_sampled_generation_is_seeded(port_engine):
    sp = SamplingParams(max_new_tokens=12, temperature=0.8, top_k=50, seed=7)
    ids = port_engine.tokenizer.encode("a")
    assert (port_engine.generate_ids(ids, sp).token_ids
            == port_engine.generate_ids(ids, sp).token_ids)


def test_decode_width_buckets_match_jax():
    je, te = _engines(max_seq=4096)
    for frontier in (1, 100, 128, 129, 700, 4000, 4095):
        assert te._decode_width(frontier) == je._decode_width(frontier)


# -- quantized engines -----------------------------------------------------------

QUANT_MODES = [
    {"kv_quant": "int8"},
    {"quant": "int8"},
    {"quant": "int8", "kv_quant": "int8"},
]


@pytest.mark.parametrize("modes", QUANT_MODES, ids=["kv-int8", "w-int8", "both"])
@pytest.mark.parametrize("prompt,chunk", [(SHORT, 512), (LONG, 32)],
                         ids=["one-shot", "chunked"])
def test_quantized_greedy_tokens_identical_to_jax(modes, prompt, chunk):
    """tiny-llama at head_dim 128 in float32, the JAX Engine given the same
    modes: int8 KV (the decode kernel's int8 variant, plain here), int8
    weights, both; one-shot and chunked prefill."""
    je, te = _engines(128, prefill_chunk=chunk, **modes)
    assert (te.quant, te.kv_quant) == (je.quant, je.kv_quant)
    a = je.generate(prompt, JaxSampling(max_new_tokens=40, ignore_eos=True))
    b = te.generate(prompt, SamplingParams(max_new_tokens=40, ignore_eos=True))
    assert b.token_ids == a.token_ids
    assert b.text == a.text


def test_w8a8_greedy_tokens_identical_to_jax(monkeypatch):
    """int8 x int8 matmuls: the JAX Engine takes LLMC_W8A8 from the
    environment, the port's Engine the argument."""
    monkeypatch.setenv("LLMC_W8A8", "1")
    je, te = _engines(128, quant="int8", kv_quant="int8")
    monkeypatch.delenv("LLMC_W8A8")
    te = Engine(te.cfg, params=te.params, dtype=torch.float32, max_seq=128, device="cpu",
                quant="int8", kv_quant="int8", w8a8=True)
    assert je.w8a8 and te.w8a8
    sp = dict(max_new_tokens=24, ignore_eos=True)
    assert (te.generate(SHORT, SamplingParams(**sp)).token_ids
            == je.generate(SHORT, JaxSampling(**sp)).token_ids)


def test_quant_modes_resolve_like_jax(monkeypatch):
    import llm_consensus_tpu_torch.engine.engine as engine_mod

    cfg = get_config("tiny-llama", head_dim=128)  # GQA group 2

    def no_build(*a, **k):
        raise AssertionError("a bad mode must fail before any parameter is built")

    monkeypatch.setattr(engine_mod, "init_params", no_build)
    with pytest.raises(ValueError, match="unknown quant mode 'int3'"):
        Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", quant="int3")
    with pytest.raises(ValueError, match="unknown kv_quant mode 'int4'"):
        Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", kv_quant="int4")
    monkeypatch.undo()
    for off in ("bf16", "none"):
        e = Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", quant=off, kv_quant=off)
        assert e.quant is None and e.kv_quant is None
    # W8A8 holds only with int8 weights; decode W8A8 only with the int8
    # cache and a GQA group of 2 to 4.
    assert not Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", w8a8=True).w8a8
    assert not Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", quant="int4",
                      w8a8=True).w8a8
    e = Engine(cfg, dtype=torch.float32, max_seq=64, device="cpu", quant="int8", w8a8=True,
               decode_w8a8=True)
    assert e.w8a8 and not e.decode_w8a8
    e = Engine(cfg, params=e.params, dtype=torch.float32, max_seq=64, device="cpu",
               kv_quant="int8", decode_w8a8=True)
    assert e.decode_w8a8 and e.params["layers"]["wq"]["q8"].dtype == torch.int8
    mha = get_config("tiny-llama", head_dim=128, n_kv_heads=4)
    assert not Engine(mha, dtype=torch.float32, max_seq=64, device="cpu", kv_quant="int8",
                      decode_w8a8=True).decode_w8a8


def test_int8_engine_uses_the_int8_cache_and_quantized_weights():
    te = Engine(get_config("tiny-llama", head_dim=128), dtype=torch.float32, max_seq=128,
                device="cpu", quant="int8", kv_quant="int8")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert te.params["layers"][name]["q8"].dtype == torch.int8
    assert te.params["lm_head"]["q8"].dtype == torch.int8
    assert te.params["embed"].dtype == torch.float32
    _, cache = te._prefill_ids(te.tokenizer.encode(SHORT))
    assert cache["k"]["q8"].dtype == torch.int8 and cache["v"]["s"].shape == (
        te.cfg.n_layers, 1, te.cfg.n_kv_heads, 128)
    r = te.generate(SHORT, SamplingParams(max_new_tokens=12, ignore_eos=True))
    assert len(r.token_ids) == 12


# -- mixture of experts ------------------------------------------------------------


def _zero_router(jp):
    """Every router logit 0: all choices tie, so every token picks experts
    0 and 1 (the lower index first), and with 8 experts each holds half
    the tokens of a prefill: the rest are dropped."""
    layers = dict(jp["layers"])
    layers["w_router"] = jnp.zeros_like(layers["w_router"])
    return {**jp, "layers": layers}


@pytest.mark.parametrize("case", [
    ({}, None), ({"n_experts": 8}, None), ({"n_experts": 8}, _zero_router),
], ids=["e4", "e8", "e8-ties-drops"])
@pytest.mark.parametrize("modes", [{}, {"quant": "int8", "kv_quant": "int8"}],
                         ids=["f32", "int8-int8"])
@pytest.mark.parametrize("prompt,chunk", [(SHORT, 512), (LONG, 32)],
                         ids=["one-shot", "chunked"])
def test_mixtral_greedy_tokens_identical_to_jax(case, modes, prompt, chunk):
    """tiny-mixtral through both engines: the same routing, capacity and
    drop order (pad tokens of the prompt's bucket included) give the same
    greedy tokens, in float32 and with int8 weights and cache."""
    over, edit = case
    je, te = _engines(prefill_chunk=chunk, preset="tiny-mixtral", overrides=over, edit=edit,
                      **modes)
    a = je.generate(prompt, JaxSampling(max_new_tokens=32, ignore_eos=True))
    b = te.generate(prompt, SamplingParams(max_new_tokens=32, ignore_eos=True))
    assert b.token_ids == a.token_ids
    assert b.text == a.text
