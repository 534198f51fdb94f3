"""Quantization of the port (ops/quant.py) against the JAX package's.

The same numpy inputs go through both: int8 weight and KV codes must be
equal exactly and their scales equal to what the JAX package computes
under ``jit``, as its engine runs them (XLA turns ``max / 127`` into a
multiply by ``float32(1/127)``; op-by-op JAX divides, which moves float32
scales by an ulp and, in bfloat16, codes by one); products follow the JAX package's
own tolerances (``qeinsum`` rtol 1e-4 / atol 1e-5 as tests/test_quant.py,
the int4 nibble dot 2e-3); the int8 cache helpers (write, layer slice,
read) must give the JAX package's arrays. Also the mode resolution and the
port's copy of the knob parsing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.models import get_config as jax_config
from llm_consensus_tpu.models import init_params as jax_init
from llm_consensus_tpu.ops import quant as jq
from llm_consensus_tpu_torch.models import get_config
from llm_consensus_tpu_torch.models import transformer as ttf
from llm_consensus_tpu_torch.ops import quant as tq
from llm_consensus_tpu_torch.utils import knobs

CPU = torch.device("cpu")
# The cache write as the JAX engine runs it: inside its jitted forward.
_jax_write = jax.jit(jq.kv_write_rows)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(64, 32), (3, 256, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weight_codes_and_scales_equal_jax(shape, dtype):
    w = _rand(0, *shape)
    jw = jq._quantize_leaf(jnp.asarray(w, dtype=dtype))  # quantize_params' leaf
    tw = tq._quantize(_t(w).to(getattr(torch, dtype)))
    assert tw["q8"].dtype == torch.int8 and tw["s"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tw["q8"].numpy(), np.asarray(jw["q8"]))
    np.testing.assert_array_equal(tw["s"].float().numpy(),
                                  np.asarray(jw["s"].astype(jnp.float32)))


@pytest.mark.parametrize("mode,shape", [("int8", (4, 64, 24)), ("int4", (3, 256, 8))])
def test_stacked_leaf_quantizes_slice_by_slice_as_a_whole(mode, shape):
    w = _rand(1, *shape)
    want = (jq._quantize4_leaf if mode == "int4" else jq._quantize_leaf)(jnp.asarray(w))
    got = tq.quantize_weight(_t(w), mode)
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr))


def test_qmatmul_exact_on_representable_weights():
    """tests/test_quant.py's case: int8 multiples of the channel scale
    survive quantization bit for bit, and the product follows."""
    rng = np.random.default_rng(1)
    q_int = rng.integers(-127, 128, size=(16, 8)).astype(np.float32)
    q_int[0, :] = 127.0
    w = q_int * 0.01
    x = _rand(2, 4, 16)
    tw = tq._quantize(_t(w))
    np.testing.assert_array_equal(tw["q8"].numpy(), q_int.astype(np.int8))
    with jax.default_matmul_precision("highest"):
        want = jq.qeinsum("nd,df->nf", jnp.asarray(x), jq._quantize_leaf(jnp.asarray(w)))
    np.testing.assert_allclose(tq.qmatmul(_t(x), tw).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tq.qmatmul(_t(x), tw).numpy(), x @ w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_f32", [False, True])
def test_qmatmul_int8_matches_jax_qeinsum(out_f32):
    w, x = _rand(3, 64, 40, scale=0.2), _rand(4, 2, 5, 64)
    kw = {"preferred_element_type": jnp.float32} if out_f32 else {}
    with jax.default_matmul_precision("highest"):
        want = jq.qeinsum("btd,dk->btk", jnp.asarray(x), jq._quantize_leaf(jnp.asarray(w)), **kw)
    got = tq.qmatmul(_t(x), tq._quantize(_t(w)), torch.float32 if out_f32 else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_quantize_params_and_streamed_init_match():
    """quantize_params quantizes the JAX package's QUANT_KEYS and nothing
    else, leaf by leaf, to the codes and scales of the JAX package's
    ``quantize_params`` (its jitted leaf quantizer, as the JAX engine runs
    it), and init_params(quant=...) equals quantizing the plain init
    afterwards (same draws)."""
    jcfg, tcfg = jax_config("tiny-llama"), get_config("tiny-llama")
    jp = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, CPU, torch.float32)
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(tp)
    assert tq.QUANT_KEYS == jq.QUANT_KEYS
    for name, leaf in jqp["layers"].items():
        assert tq.is_quantized(tqp["layers"][name]) == jq.is_quantized(leaf), name
        if jq.is_quantized(leaf):
            for key in ("q8", "s"):
                np.testing.assert_array_equal(tqp["layers"][name][key].numpy(),
                                              np.asarray(leaf[key]))
    for key in ("q8", "s"):
        np.testing.assert_array_equal(tqp["lm_head"][key].numpy(),
                                      np.asarray(jqp["lm_head"][key]))
    assert not tq.is_quantized(tqp["embed"]) and not jq.is_quantized(jqp["embed"])
    assert tq.quantize_params(tqp)["layers"]["wq"] is tqp["layers"]["wq"]  # idempotent

    for mode in tq.WEIGHT_MODES:
        streamed = ttf.init_params(tcfg, 5, device=CPU, quant=mode)
        posthoc = tq.quantize_params(ttf.init_params(tcfg, 5, device=CPU), mode)
        for (na, a), (nb, b) in zip(ttf.param_leaves(streamed), ttf.param_leaves(posthoc)):
            assert na == nb and torch.equal(a, b), na


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equal_jax(dtype):
    x = _rand(5, 2, 7, 4, 128, scale=3.0)
    x[0, 0, 0] = 0.0  # an all-zero row: the tiny floor, codes 0
    jc, js = jax.jit(jq.quantize_kv)(jnp.asarray(x, dtype=dtype))  # as in the jitted forward
    tc, ts = tq.quantize_kv(_t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))
    assert ts.shape == (2, 7, 4, 1) and not tc[0, 0, 0].any()


def _int8_cache_pair(layers=3, b=2, s=16, h=2, dh=128):
    jcache = {"q8": jnp.zeros((layers, b, s, h, dh), jnp.int8),
              "s": jnp.zeros((layers, b, h, s), jnp.float32)}
    tcache = ttf.init_kv_cache(
        get_config("tiny-llama", n_layers=layers, n_kv_heads=h, head_dim=dh, n_heads=2 * h),
        b, s, device=CPU, dtype=torch.float32, quant="int8")["k"]
    return jcache, tcache


def test_kv_write_rows_host_start_and_device_slots_match_jax():
    jcache, tcache = _int8_cache_pair()
    assert tcache["q8"].shape == jcache["q8"].shape and tcache["s"].shape == jcache["s"].shape
    rows = _rand(6, 2, 5, 2, 128)
    jcache = _jax_write(jcache, jnp.asarray(rows), 1, 3)
    tq.kv_write_rows(tcache, _t(rows), 1, 3)
    step = _rand(7, 2, 1, 2, 128)
    jcache = _jax_write(jcache, jnp.asarray(step), 2, jnp.int32(8))
    tq.kv_write_rows(tcache, _t(step), 2, None, slots=torch.tensor([8]))
    for key in ("q8", "s"):
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
    assert tq.kv_seq_axis(tcache["q8"]) == jq.kv_seq_axis(jcache["q8"]) == 2
    assert tq.kv_seq_axis(tcache["s"]) == jq.kv_seq_axis(jcache["s"]) == 3
    assert tq.kv_capacity(tcache) == 16

    bf16 = torch.zeros(3, 2, 16, 2, 128)
    tq.kv_write_rows(bf16, _t(rows), 1, 3)
    np.testing.assert_array_equal(bf16[1, :, 3:8].numpy(), rows)


@pytest.mark.parametrize("width", [None, 9])
def test_kv_layer_and_kv_read_match_jax(width):
    jcache, tcache = _int8_cache_pair()
    rows = _rand(8, 2, 12, 2, 128, scale=2.0)
    jcache = _jax_write(jcache, jnp.asarray(rows), 2, 0)
    tq.kv_write_rows(tcache, _t(rows), 2, 0)
    jentry, tentry = jq.kv_layer(jcache, 2, width), tq.kv_layer(tcache, 2, width)
    for key in ("q8", "s"):
        np.testing.assert_array_equal(tentry[key].numpy(), np.asarray(jentry[key]))
    np.testing.assert_array_equal(tq.kv_read(tentry, torch.float32).numpy(),
                                  np.asarray(jq.kv_read(jentry, jnp.float32)))
    plain = _t(_rand(9, 3, 2, 16, 2, 128))
    assert torch.equal(tq.kv_read(tq.kv_layer(plain, 1, width), torch.float32),
                       plain[1, :, :width])


def test_int4_codes_unpack_and_nibble_dot_match_jax():
    w = _rand(10, 256, 64)
    jw, tw = jq._quantize4_leaf(jnp.asarray(w)), tq._quantize4(_t(w))
    for key in ("q4", "s"):
        np.testing.assert_array_equal(tw[key].numpy(), np.asarray(jw[key]))
    np.testing.assert_array_equal(tq._unpack4(tw, torch.float32).numpy(),
                                  np.asarray(jq._unpack4(jw, jnp.float32)))
    with jax.default_matmul_precision("highest"):
        for spec, x in (("nd,df->nf", _rand(11, 4, 256)), ("...d,df->...f", _rand(12, 2, 3, 256))):
            want = jq._int4_nibble_einsum(spec, jnp.asarray(x), jw)
            got = tq._int4_nibble_matmul(_t(x), tw, None)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
        # Above the row bound: the dequantized weight (qeinsum's prefill form).
        xl = _rand(13, 32, 256)
        want = jq.qeinsum("nd,df->nf", jnp.asarray(xl), jw)
        np.testing.assert_allclose(tq.qmatmul(_t(xl), tw).numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)
    y = tq.qmatmul(_t(_rand(14, 1, 256)).to(torch.bfloat16), tw, torch.float32)
    assert y.dtype == torch.float32
    # int4_nibble (int4_impl="nibble") forces the nibble dot at any row count.
    np.testing.assert_allclose(tq.qmatmul(_t(xl), tw, int4_nibble=True).numpy(),
                               tq.qmatmul(_t(xl), tw).numpy(), rtol=2e-3, atol=2e-3)


def test_quantize_rows_sym_and_w8a8_matmul_match_jax():
    x = _rand(15, 3, 4096, scale=2.0)
    x[1] = 0.0  # the 1e-30 floor
    jc, js = jax.jit(jq.quantize_rows_sym)(jnp.asarray(x))
    tc, ts = tq.quantize_rows_sym(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 0]) == np.float32(1e-30)

    w = _rand(16, 4096, 24, scale=0.05)
    jw, tw = jq._quantize_leaf(jnp.asarray(w)), tq._quantize(_t(w))
    want = jq._w8a8_einsum("nd,df->nf", jnp.asarray(x), jw)
    got = tq._w8a8_matmul(_t(x), tw, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(tq.qmatmul(_t(x), tw, w8a8=True), got)
    # The int32 accumulation is exact where a float32 sum of 4096
    # products of up to 127 * 127 is not.
    a = torch.full((1, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 8), 127, dtype=torch.int8)
    b[::2] = -127
    b[1] = 126
    exact = (a.long() @ b.long())
    assert torch.equal(tq._int8_mm(a, b).long(), exact)


def test_resolve_mode_and_knob_parsing(monkeypatch):
    for off in (None, "", "bf16", "none"):
        assert tq.resolve_mode(off, "quant", tq.WEIGHT_MODES) is None
    assert tq.resolve_mode("int4", "quant", tq.WEIGHT_MODES) == "int4"
    with pytest.raises(ValueError, match="unknown kv_quant mode 'int4'"):
        tq.resolve_mode("int4", "kv_quant", tq.KV_MODES)
    assert [tq.resolve_int4_impl(v) for v in (None, "", "auto", "nibble")] == [
        "auto", "auto", "auto", "nibble"]
    with pytest.raises(ValueError, match="unknown int4_impl 'nible'"):
        tq.resolve_int4_impl("nible")

    for name in ("LLMC_QUANT", "LLMC_KV_QUANT", "LLMC_W8A8", "LLMC_DECODE_W8A8",
                 "LLMC_DECODE_QSTRUCT", "LLMC_INT4_IMPL"):
        monkeypatch.delenv(name, raising=False)
    assert knobs.quant_modes() == {"quant": None, "kv_quant": None, "w8a8": False,
                                   "decode_w8a8": False, "int4_impl": "auto"}
    monkeypatch.setenv("LLMC_QUANT", " int8 ")
    monkeypatch.setenv("LLMC_KV_QUANT", "int8")
    monkeypatch.setenv("LLMC_W8A8", "yes")
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1")
    monkeypatch.setenv("LLMC_INT4_IMPL", "nibble")
    assert knobs.quant_modes() == {"quant": "int8", "kv_quant": "int8", "w8a8": True,
                                   "decode_w8a8": True, "int4_impl": "nibble"}
    for falsy in ("0", "false", "No", "OFF"):
        monkeypatch.setenv("LLMC_DECODE_QSTRUCT", falsy)
        assert knobs.quant_modes()["decode_w8a8"] is False
    monkeypatch.setenv("LLMC_DECODE_QSTRUCT", "")
    assert knobs.quant_modes()["decode_w8a8"] is True
