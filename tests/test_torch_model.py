"""The port's transformer (models/transformer.py) against the JAX one.

The same float32 parameters (the JAX ``init_params`` tree carried across by
``params_from_numpy``) and the same tokens go through both forwards:
full-sequence logits, a cache prefill followed by decode steps, and a
one-shot prefill whose padded rows decode overwrites. Tolerance 1e-4
(atol and rtol) on logits: two layers of float32 matmuls summed in another
order. The JAX side runs both its XLA attention and its Pallas kernels in
interpret mode; the port runs its kernels' plain versions and its plain
attention op.
"""

from dataclasses import asdict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import config as jconfig
from llm_consensus_tpu.models import transformer as jtf
from llm_consensus_tpu.utils import flops as jflops
from llm_consensus_tpu_torch.models import config as tconfig
from llm_consensus_tpu_torch.models import transformer as ttf
from llm_consensus_tpu_torch.ops import quant as tq
from llm_consensus_tpu_torch.utils import flops as tflops

TOL = dict(atol=1e-4, rtol=1e-4)
TOL8 = dict(atol=1e-3, rtol=1e-3)  # through the int8 cache's quantizer (see its test)
CPU = torch.device("cpu")
# Every tiny family of the reference (tests/test_models.py FAMILIES): gemma's
# norm offset, embedding scale and tied head, qwen2's qkv biases (drawn
# non-zero), mistral's window and mixtral's experts each held against JAX.
FAMILIES = ["tiny-gemma", "tiny-qwen2", "tiny-mistral", "tiny-mixtral"]
CONFIGS = [("tiny-llama", {}), ("tiny-llama", {"head_dim": 128})] + [
    (name, {}) for name in FAMILIES]
# And tiny-gemma at head width 256, gemma-7b's: both kernels' routes there,
# in float32 and with quantized weights. (The int8-cache tests below keep
# CONFIGS: their 1e-3 is derived from a code off by one on tiny-llama's
# widths, and a 256-wide head's scores sum twice the codes.)
WIDE = CONFIGS + [("tiny-gemma", {"head_dim": 256})]


def _with_biases(jp, jcfg, seed):
    """Non-zero qkv biases (the reference initializes them to zero)."""
    if not jcfg.qkv_bias:
        return jp
    rng = np.random.default_rng(seed + 100)
    layers = dict(jp["layers"])
    for name in ("bq", "bk", "bv"):
        layers[name] = jnp.asarray(
            rng.standard_normal(layers[name].shape).astype(np.float32) * 0.1,
            layers[name].dtype)
    return {**jp, "layers": layers}


def _pair(name, overrides, seed=0):
    jcfg = jconfig.get_config(name, **overrides)
    tcfg = tconfig.get_config(name, **overrides)
    jp = _with_biases(jtf.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32),
                      jcfg, seed)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, CPU, torch.float32)
    return jcfg, tcfg, jp, tp


def _tokens(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n)).astype(np.int32)


def test_presets_equal_the_jax_table():
    assert set(tconfig.MODEL_PRESETS) == set(jconfig.MODEL_PRESETS)
    for name, cfg in tconfig.MODEL_PRESETS.items():
        assert asdict(cfg) == asdict(jconfig.MODEL_PRESETS[name]), name
        assert cfg.n_params() == jconfig.MODEL_PRESETS[name].n_params()
        assert tflops.flops_per_token(cfg, 300) == jflops.flops_per_token(
            jconfig.MODEL_PRESETS[name], 300)


@pytest.mark.parametrize("name,overrides", WIDE)
def test_params_from_numpy_carries_the_jax_tree(name, overrides):
    _, _, jp, tp = _pair(name, overrides)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {f"layers/{k}": v for k, v in tp["layers"].items()}
    flat_t.update({k: v for k, v in tp.items() if k != "layers"})
    assert set(flat_j) == set(flat_t)
    for key, arr in flat_j.items():
        assert flat_t[key].dtype == torch.float32
        np.testing.assert_array_equal(flat_t[key].numpy(), arr)


def test_init_params_draws_in_the_working_dtype():
    cfg = tconfig.get_config("tiny-llama")
    a = ttf.init_params(cfg, 3, device=CPU)
    b = ttf.init_params(cfg, 3, device=CPU)
    for name, w in a["layers"].items():
        assert w.dtype == torch.bfloat16 and w.shape[0] == cfg.n_layers
        assert torch.equal(w, b["layers"][name])
    assert a["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    assert not torch.equal(a["embed"], ttf.init_params(cfg, 4, device=CPU)["embed"])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_expert_leaves_draw_layer_by_layer_the_same_with_quant(mode):
    """tiny-mixtral: the experts' [L, E, D, F] leaves and the router have
    the reference's shapes, and the streamed quantized init gives exactly
    the codes of quantizing the unquantized init (the draws do not depend
    on ``quant``); the router stays in the working dtype."""
    cfg = tconfig.get_config("tiny-mixtral")
    plain = ttf.init_params(cfg, 5, device=CPU)
    streamed = ttf.init_params(cfg, 5, device=CPU, quant=mode)
    want = tq.quantize_params(plain, mode)
    for name, shape in ttf._layer_shapes(cfg).items():
        assert tuple(plain["layers"][name].shape) == shape, name
        got = streamed["layers"][name]
        if name in tq.QUANT_KEYS:
            for key, codes in want["layers"][name].items():
                assert torch.equal(got[key], codes), (name, key)
        else:
            assert torch.equal(got, plain["layers"][name]), name
    assert streamed["layers"]["w_router"].dtype == torch.bfloat16
    jshapes = jax.eval_shape(lambda: jtf.init_params(
        jconfig.get_config("tiny-mixtral"), jax.random.PRNGKey(0)))["layers"]
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == ttf._layer_shapes(cfg)


@pytest.mark.parametrize("name,overrides", WIDE)
def test_full_sequence_logits_match_jax(name, overrides):
    jcfg, tcfg, jp, tp = _pair(name, overrides)
    toks = _tokens(1, 24, jcfg.vocab_size)
    with jax.default_matmul_precision("highest"):
        want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_impl", ["xla", "flash"])
@pytest.mark.parametrize("name,overrides", WIDE)
def test_cache_prefill_then_decode_matches_jax(name, overrides, jax_impl):
    """Prefill 16 tokens at start 0, then 4 single-token steps at a running
    start; the port through its kernels' plain versions (and, for the
    steps, the decode kernel where dh allows), JAX through XLA attention or
    its Pallas kernels in interpret mode."""
    jcfg, tcfg, jp, tp = _pair(name, overrides)
    toks = _tokens(2, 20, jcfg.vocab_size)
    jcache = jtf.init_kv_cache(jcfg, 1, 64, dtype=jnp.float32)
    tcache = ttf.init_kv_cache(tcfg, 1, 64, device=CPU, dtype=torch.float32)
    with jax.default_matmul_precision("highest"):
        want, jcache = jtf.forward(jp, jcfg, jnp.asarray(toks[:, :16]), jcache,
                                   start_pos=0, attn_impl=jax_impl)
        got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, :16]).long(),
                                  tcache, start_pos=0, attn_impl="flash")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i in range(16, 20):
            want, jcache = jtf.forward(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jcache,
                                       start_pos=jnp.int32(i), attn_impl=jax_impl,
                                       kv_width=64)
            got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                                      tcache, start_pos=torch.tensor(i, dtype=torch.int32),
                                      attn_impl="flash", kv_width=64)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(tcache[side].numpy(), np.asarray(jcache[side]), **TOL)


@pytest.mark.parametrize("name,overrides", WIDE)
def test_plain_attention_path_matches_kernel_path(name, overrides):
    """attn_impl="torch" (the plain op everywhere) and "flash" agree."""
    _, tcfg, _, tp = _pair(name, overrides)
    toks = torch.from_numpy(_tokens(3, 17, tcfg.vocab_size)).long()
    outs = {}
    for impl in ("torch", "flash"):
        cache = ttf.init_kv_cache(tcfg, 1, 64, device=CPU, dtype=torch.float32)
        first, cache = ttf.forward(tp, tcfg, toks[:, :16], cache, 0, attn_impl=impl)
        step, _ = ttf.forward(tp, tcfg, toks[:, 16:], cache, torch.tensor(16), attn_impl=impl)
        outs[impl] = (first, step)
    for a, b in zip(outs["torch"], outs["flash"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("name,overrides", WIDE)
def test_padded_prefill_rows_overwritten_by_decode(name, overrides):
    """A one-shot prefill over a 16-token bucket holding 11 real tokens
    writes junk k/v at slots 11..15; decode from slot 11 overwrites them
    before its frontier reaches them. Logits follow JAX throughout."""
    jcfg, tcfg, jp, tp = _pair(name, overrides)
    real = _tokens(4, 11, jcfg.vocab_size)
    padded = np.concatenate([real, np.zeros((1, 5), np.int32)], axis=1)
    steps = _tokens(5, 6, jcfg.vocab_size)
    jcache = jtf.init_kv_cache(jcfg, 1, 64, dtype=jnp.float32)
    tcache = ttf.init_kv_cache(tcfg, 1, 64, device=CPU, dtype=torch.float32)
    with jax.default_matmul_precision("highest"):
        want, jcache = jtf.forward(jp, jcfg, jnp.asarray(padded), jcache, start_pos=0,
                                   logits_index=jnp.asarray([10]))
        got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(padded).long(), tcache, 0,
                                  attn_impl="flash", logits_index=torch.tensor([10]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for j in range(6):
            pos = 11 + j
            want, jcache = jtf.forward(jp, jcfg, jnp.asarray(steps[:, j:j + 1]), jcache,
                                       start_pos=jnp.int32(pos), kv_width=64)
            got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(steps[:, j:j + 1]).long(),
                                      tcache, torch.tensor(pos, dtype=torch.int32),
                                      attn_impl="flash", kv_width=64)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- quantized weights and the int8 cache --------------------------------------


def _quantized_pair(name, overrides, mode="int8", seed=0):
    """A tree quantized by the JAX package's quantize_params, carried into
    the port as it is (codes and scales)."""
    from llm_consensus_tpu.ops.quant import quantize_params

    jcfg = jconfig.get_config(name, **overrides)
    tcfg = tconfig.get_config(name, **overrides)
    jp = quantize_params(_with_biases(
        jtf.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32), jcfg, seed),
        mode=mode)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, CPU, torch.float32)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name,overrides", WIDE)
def test_quantized_jax_tree_gives_the_jax_logits(name, overrides, mode):
    jcfg, tcfg, jp, tp = _quantized_pair(name, overrides, mode)
    code = "q4" if mode == "int4" else "q8"
    for key in ("wq", "w_down"):
        np.testing.assert_array_equal(tp["layers"][key][code].numpy(),
                                      np.asarray(jp["layers"][key][code]))
    toks = _tokens(6, 24, jcfg.vocab_size)
    with jax.default_matmul_precision("highest"):
        want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_w8a8_forward_matches_jax_scope():
    """int8 x int8 matmuls (W8A8) through the whole model: the port's
    matmul with ``w8a8=True`` against the JAX forward under its W8A8 scope."""
    from llm_consensus_tpu.ops.quant import w8a8_scope

    jcfg, tcfg, jp, tp = _quantized_pair("tiny-llama", {"head_dim": 128})
    toks = _tokens(7, 20, jcfg.vocab_size)
    with jax.default_matmul_precision("highest"), w8a8_scope(True):
        want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks).long(),
                         mm=partial(tq.qmatmul, w8a8=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("jax_impl", ["xla", "flash"])
@pytest.mark.parametrize("name,overrides", CONFIGS)
def test_int8_cache_prefill_then_decode_matches_jax(name, overrides, jax_impl):
    """The int8 cache: a one-shot prefill (fresh k/v round-tripped through
    the quantizer) then decode steps over the codes, the port's kernels'
    plain versions against JAX's XLA path or its Pallas kernels in
    interpret mode. Tolerance 1e-3 (TOL8): k/v differ from JAX's by float32
    summation order (~1e-7), which now and then moves a value across a
    rounding boundary of the quantizer; that code then differs by one, a
    step of its row's scale (max|row| / 127), which moves logits by up to
    ~3e-4 on tiny-llama. At most 0.1 % of the codes may differ, by one."""
    jcfg, tcfg, jp, tp = _pair(name, overrides)
    toks = _tokens(8, 20, jcfg.vocab_size)
    jcache = jtf.init_kv_cache(jcfg, 1, 64, dtype=jnp.float32, quant="int8")
    tcache = ttf.init_kv_cache(tcfg, 1, 64, device=CPU, dtype=torch.float32, quant="int8")
    with jax.default_matmul_precision("highest"):
        want, jcache = jtf.forward(jp, jcfg, jnp.asarray(toks[:, :16]), jcache,
                                   start_pos=0, attn_impl=jax_impl)
        got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, :16]).long(),
                                  tcache, start_pos=0, attn_impl="flash")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL8)
        for i in range(16, 20):
            want, jcache = jtf.forward(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jcache,
                                       start_pos=jnp.int32(i), attn_impl=jax_impl,
                                       kv_width=64)
            got, tcache = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                                      tcache, start_pos=torch.tensor(i, dtype=torch.int32),
                                      attn_impl="flash", kv_width=64)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL8)
    for side in ("k", "v"):
        codes = tcache[side]["q8"].numpy()
        assert codes.dtype == np.int8 and codes[:, :, 20:].max() == 0
        diff = codes[:, :, :20].astype(np.int32) - np.asarray(jcache[side]["q8"])[:, :, :20]
        assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= diff.size // 1000
        np.testing.assert_allclose(tcache[side]["s"].numpy(), np.asarray(jcache[side]["s"]),
                                   **TOL)


@pytest.mark.parametrize("name,overrides", CONFIGS)
def test_int8_cache_plain_path_matches_kernel_path(name, overrides):
    """With the int8 cache, the plain op over kv_layer/kv_read (the chunked
    path) and the kernel path agree."""
    _, tcfg, _, tp = _pair(name, overrides)
    toks = torch.from_numpy(_tokens(9, 17, tcfg.vocab_size)).long()
    outs = {}
    for impl in ("torch", "flash"):
        cache = ttf.init_kv_cache(tcfg, 1, 64, device=CPU, dtype=torch.float32, quant="int8")
        first, cache = ttf.forward(tp, tcfg, toks[:, :16], cache, 0, attn_impl=impl)
        step, _ = ttf.forward(tp, tcfg, toks[:, 16:], cache, torch.tensor(16), attn_impl=impl)
        outs[impl] = (first, step)
    for a, b in zip(outs["torch"], outs["flash"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("tp", [1, 2])
def test_gemma_7b_routes_to_both_kernels_like_jax(tp):
    """gemma-7b's heads (16/16 at dh 256; 8/8 on a tp 2 shard): a one-shot
    prefill takes the flash route and a T = 1 step the decode kernel's, as
    the JAX gates send them to its Pallas kernels; a chunk past the first
    (start_pos > 0 on a cache) still takes flash at its offset."""
    from dataclasses import replace

    from llm_consensus_tpu.ops.pallas.decode_attention import decode_flash_supported
    from llm_consensus_tpu.ops.pallas.flash_attention import flash_supported

    cfg = tconfig.get_config("gemma-7b")
    shard = replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp)
    hq, hkv, dh = shard.n_heads, shard.n_kv_heads, shard.head_dim
    assert dh == 256 and flash_supported(512, hq, hkv) and decode_flash_supported(hq, hkv, dh)
    cache = {}
    assert ttf._routes("flash", cache, 0, 512, shard, None, None, None, True) == (0, False)
    assert ttf._routes("flash", cache, 0, 1, shard, None, None, None, True) == (None, True)
    assert ttf._routes("flash", cache, 512, 64, shard, None, None, None, True) == (512, False)
    assert ttf._routes("xla", cache, 0, 1, shard, None, None, None, True) == (None, False)
