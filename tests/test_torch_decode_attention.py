"""Decode attention of the port (ops/kernels/decode_attention.py) against
the JAX Pallas kernel run in interpret mode, at head_dim 128.

The plain version must match the TPU kernel over the cases of
tests/test_decode_attention.py (row_start, window, softcap,
non-power-of-two widths, pos = 0), plus layer selection from a stack with
L > 1, NaN in unwritten slots, and B = 8 with ragged row_start, at
atol/rtol 1e-5 in float32. The int8-cache and W8A8 variants are held to
the TPU kernel on that file's int8 and W8A8 cases at atol/rtol 2e-4 (the
JAX file's own tolerance for them), with the same codes and scales given
to both, and must keep NaN scales and garbage codes past the frontier out
of the output. At head width 256 (gemma-7b's) every variant, and each with
``return_state``, is held to the TPU kernel the same way, with row starts and
a window. The CUDA kernels run only on a card: tests/test_torch_gpu.py
holds them to these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from llm_consensus_tpu.ops.quant import quantize_kv as jax_quantize_kv
from llm_consensus_tpu_torch.ops.kernels import build
from llm_consensus_tpu_torch.ops.kernels import decode_attention as da

CASES = [
    # (b, w, hq, hkv, pos, window, softcap, row_start)
    (1, 512, 8, 8, 300, None, None, None),    # MHA, mid-cache frontier
    (2, 512, 16, 8, 511, None, None, None),   # GQA g=2, full width
    (2, 300, 8, 2, 150, None, None, (0, 37)), # non-block-multiple width + pads
    (1, 512, 8, 1, 0, None, None, None),      # MQA, pos=0 (first decode step)
    (2, 512, 8, 8, 400, 128, 50.0, None),     # sliding window + softcap
    (4, 96, 8, 4, 95, None, None, (3, 0, 10, 90)),  # small ragged batch
    (1, 24, 4, 2, 20, 8, None, None),         # width below one kv block
]
DH = 128


def _inputs(seed, layers, b, w, hq, hkv, dh=DH):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, dh)).astype(np.float32)
    k = rng.standard_normal((layers, b, w, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((layers, b, w, hkv, dh)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, pos, layer=0, row_start=None, **kw):
    rs = None if row_start is None else jnp.asarray(row_start, jnp.int32)
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
            jnp.int32(layer), rs, interpret=True, **kw))


def _port(q, k, v, pos, layer=0, row_start=None, **kw):
    """The plain version on numpy inputs; k/v may be int8-cache dicts of
    torch tensors."""
    rs = None if row_start is None else torch.tensor(row_start, dtype=torch.int32)
    conv = (lambda x: x) if isinstance(k, dict) else torch.from_numpy
    return da.decode_attention_plain(
        torch.from_numpy(q), conv(k), conv(v),
        torch.tensor(pos, dtype=torch.int32), torch.tensor(layer, dtype=torch.int32),
        rs, **kw).numpy()


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_interpret(case):
    b, w, hq, hkv, pos, window, cap, rs = case
    q, k, v = _inputs(0, 1, b, w, hq, hkv)
    kw = dict(sliding_window=window, logit_softcap=cap)
    want = _jax(q, k, v, pos, 0, rs, **kw)
    got = _port(q, k, v, pos, 0, rs, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_layer_selection_from_the_stack():
    q, k, v = _inputs(1, 3, 2, 128, 8, 4)
    for layer in range(3):
        np.testing.assert_allclose(
            _port(q, k, v, 100, layer), _jax(q, k, v, 100, layer), atol=1e-5, rtol=1e-5)
    # A different layer gives a different answer (the index is honored).
    assert not np.allclose(_port(q, k, v, 100, 0), _port(q, k, v, 100, 2))


def test_kv_width_bounds_the_span():
    q, k, v = _inputs(2, 2, 1, 512, 16, 8)
    for pos, width in ((100, 128), (383, 384), (500, 512)):
        np.testing.assert_allclose(
            _port(q, k, v, pos, 1, kv_width=width),
            _jax(q, k, v, pos, 1, kv_width=width), atol=1e-5, rtol=1e-5)


def test_nan_past_pos_never_reaches_output():
    q, k, v = _inputs(3, 1, 1, 512, 8, 4)
    clean = _port(q, k, v, 100)
    k[:, :, 101:] = np.nan
    v[:, :, 101:] = np.nan
    got = _port(q, k, v, 100)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, clean, atol=1e-6)


def test_batch_of_eight_with_ragged_row_start():
    q, k, v = _inputs(4, 2, 8, 256, 16, 8)
    rs = (0, 3, 17, 64, 100, 128, 199, 250)
    pos = 250  # the last row attends exactly one slot
    np.testing.assert_allclose(
        _port(q, k, v, pos, 1, rs), _jax(q, k, v, pos, 1, rs), atol=1e-5, rtol=1e-5)


def test_row_with_nothing_valid_outputs_zero():
    q, k, v = _inputs(5, 1, 2, 64, 4, 2)
    got = _port(q, k, v, 10, 0, (0, 11))
    assert np.all(got[1] == 0.0)
    assert np.any(got[0] != 0.0)


def test_wrapper_on_cpu_takes_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernel")

    monkeypatch.setattr(build, "ensure_built", no_build)
    monkeypatch.setattr(da, "ensure_built", no_build)
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 2, 1, 256, 16, 8))
    before = da.LAUNCHES.count
    got = da.decode_attention(q, k, v, 200, 1, kv_width=256)
    want = da.decode_attention_plain(q, k, v, 200, 1, kv_width=256)
    assert torch.equal(got, want)
    assert da.LAUNCHES.count == before


@pytest.mark.parametrize("hkv", [1, 8])
@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("width", [1, 64, 384, 8192, 131072, 1536, 8064])
def test_split_plan_covers_the_width(width, b, hkv):
    """The decode kernel's split plan, over the bf16 and the int8 cache
    alike (1,536 and 8,064 are the int8 phases' widths): contiguous splits
    that cover the width, none shorter than MIN_SPLIT (so none under one
    128-slot ring chunk) unless the width is, at most one wave of CTAs
    unless the rows alone need more, and at least half an SM's worth where
    the width allows."""
    n = da.split_plan(width, b, hkv)
    bounds = da.split_bounds(width, n)
    assert 1 <= n <= da.MAX_SPLIT and len(bounds) == n
    assert bounds[0][0] == 0 and bounds[-1][1] == width
    assert all(end == start for (_, end), (start, _) in zip(bounds, bounds[1:]))
    assert all(end - start >= min(da.MIN_SPLIT, width) for start, end in bounds)
    assert da.MIN_SPLIT >= da.RING_CHUNK
    ctas = b * hkv * n
    assert ctas <= max(b * hkv, da.CTAS_PER_SM * da.H100_SMS)
    assert ctas >= min(da.H100_SMS // 2, b * hkv * max(1, width // da.MIN_SPLIT))


def test_split_plan_of_the_main_path():
    assert da.split_plan(384, 1, 8) == 1       # llama-3-8b at the slice's width: no merge
    assert da.split_plan(1536, 1, 8) == 6      # the chunked phase's width: 48 CTAs
    assert da.split_plan(8192, 1, 8) == 16     # full window: 128 CTAs
    assert da.split_plan(8192, 4, 8) == 4      # B 4: 128 CTAs, one wave
    assert da.split_plan(256, 4, 8) == 1       # the batched state shape
    assert da.split_plan(63, 1, 8) == 1        # below one chunk
    # The int8 cache takes the same plan (the quantized slice at 384, the
    # long-context phase at 8,064).
    assert da.split_plan(8064, 1, 8) == 16     # long context: 128 CTAs
    assert da.split_plan(8064, 1, 32) == 4     # a 32-kv-head model there: 128 CTAs
    # gemma-7b (16 kv heads at dh 256): no merge at the slice's width, 128
    # CTAs at the full window; MAX_SPLIT only on a card of that many SMs.
    assert da.split_plan(384, 1, 16) == 1
    assert da.split_plan(8192, 1, 16) == 8
    assert da.split_plan(131072, 1, 1, da.MAX_SPLIT) == da.MAX_SPLIT


def test_gate_is_the_kernel_shape_limit():
    assert da.decode_supported(32, 8, 128)      # llama-3-8b
    assert da.decode_supported(16, 8, 128)      # consensus-1b
    assert da.decode_supported(8, 1, 64)        # MQA
    assert not da.decode_supported(15, 8, 128)  # ragged GQA
    assert not da.decode_supported(64, 2, 128)  # group above the kernel's 16
    assert da.decode_supported(32, 8, 256)      # dh 256 has a build
    assert da.decode_supported(16, 16, 256)     # gemma-7b


# -- int8 cache and W8A8 scores ---------------------------------------------------

INT8_CASES = [
    # (b, w, hq, hkv, pos, window, row_start): tests/test_decode_attention.py
    (1, 512, 16, 8, 300, None, None),
    (2, 300, 8, 2, 150, None, (0, 37)),   # ragged width + row pads
    (2, 512, 8, 8, 400, 128, None),       # sliding window
    (1, 512, 8, 1, 0, None, None),        # MQA, first step
]
W8A8_CASES = [
    # (window, softcap, row_start) at b 4, w 256, Hq 16, Hkv 8, pos 200
    (None, None, None),
    (128, None, None),
    (None, 50.0, None),
    (None, None, (0, 37, 5, 90)),
]
TOL8 = dict(atol=2e-4, rtol=2e-4)


def _int8_stack(x):
    """[L, B, W, H, dh] float → the int8 cache form {"q8", "s" [L, B, H, W]}
    as numpy, quantized by the JAX package."""
    q8, s = jax_quantize_kv(jnp.asarray(x))
    return {"q8": np.array(q8), "s": np.array(jnp.swapaxes(s[..., 0], 2, 3))}


def _jax8(q, k8, v8, pos, layer=0, row_start=None, **kw):
    jk = {key: jnp.asarray(a) for key, a in k8.items()}
    jv = {key: jnp.asarray(a) for key, a in v8.items()}
    rs = None if row_start is None else jnp.asarray(row_start, jnp.int32)
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_decode(jnp.asarray(q), jk, jv, jnp.int32(pos), jnp.int32(layer),
                                     rs, interpret=True, **kw))


def _port8(q, k8, v8, pos, layer=0, row_start=None, **kw):
    tk = {key: torch.from_numpy(a) for key, a in k8.items()}
    tv = {key: torch.from_numpy(a) for key, a in v8.items()}
    return _port(q, tk, tv, pos, layer, row_start, **kw)


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_plain_matches_jax_interpret(case):
    b, w, hq, hkv, pos, window, rs = case
    q, k, v = _inputs(7, 1, b, w, hq, hkv)
    k8, v8 = _int8_stack(k), _int8_stack(v)
    want = _jax8(q, k8, v8, pos, 0, rs, sliding_window=window)
    got = _port8(q, k8, v8, pos, 0, rs, sliding_window=window)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL8)


@pytest.mark.parametrize("window,cap,rs", W8A8_CASES)
def test_w8a8_plain_matches_jax_interpret(monkeypatch, window, cap, rs):
    b, w, hq, hkv, pos = 4, 256, 16, 8, 200
    q, k, v = _inputs(9, 1, b, w, hq, hkv)
    k8, v8 = _int8_stack(k), _int8_stack(v)
    kw = dict(sliding_window=window, logit_softcap=cap)
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1")
    want = _jax8(q, k8, v8, pos, 0, rs, **kw)
    got = _port8(q, k8, v8, pos, 0, rs, w8a8=True, **kw)
    np.testing.assert_allclose(got, want, **TOL8)
    # The variant is real: without W8A8 the scores carry no q rounding.
    assert not np.allclose(_port8(q, k8, v8, pos, 0, rs, **kw), got, atol=1e-6, rtol=0)


def test_w8a8_plain_matches_jax_with_a_q_outlier(monkeypatch):
    """One q outlier of 127 per head, on a dimension where every K code is
    0, sets q's int8 scale to 1 without touching the scores: W8A8 then
    rounds the rest of q to integers, and its output moves far from the
    int8 variant's (the case the card holds both kernels to)."""
    b, w, hq, hkv, pos = 1, 384, 32, 8, 383
    q, k, v = _inputs(13, 1, b, w, hq, hkv)
    q[..., 0] = 127.0
    k8, v8 = _int8_stack(k), _int8_stack(v)
    k8["q8"][..., 0] = 0
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1")
    want = _jax8(q, k8, v8, pos)
    got = _port8(q, k8, v8, pos, w8a8=True)
    np.testing.assert_allclose(got, want, **TOL8)
    gap = np.abs(got - _port8(q, k8, v8, pos)).max()
    assert gap > 0.2 * np.abs(want).max()  # 4x the card's 5 % tolerance


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
def test_int8_layer_selection_and_width(monkeypatch, w8a8):
    q, k, v = _inputs(10, 3, 2, 512, 16, 8)
    k8, v8 = _int8_stack(k), _int8_stack(v)
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1" if w8a8 else "0")
    for layer, pos, width in ((2, 383, 384), (1, 100, 128)):
        np.testing.assert_allclose(
            _port8(q, k8, v8, pos, layer, kv_width=width, w8a8=w8a8),
            _jax8(q, k8, v8, pos, layer, kv_width=width), **TOL8)


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
def test_nan_scales_and_garbage_codes_past_pos_never_reach_output(w8a8):
    q, k, v = _inputs(11, 2, 2, 256, 16, 8)
    k8, v8 = _int8_stack(k), _int8_stack(v)
    clean = _port8(q, k8, v8, 100, 1, (0, 7), w8a8=w8a8)
    for side in (k8, v8):
        side["s"][:, :, :, 101:] = np.nan
        side["q8"][:, :, 101:] = 127
        side["s"][:, 1, :, :7] = np.nan  # row 1's slots before its row_start
    got = _port8(q, k8, v8, 100, 1, (0, 7), w8a8=w8a8)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)


def test_int8_wrapper_on_cpu_takes_plain_version_and_checks_w8a8(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernel")

    monkeypatch.setattr(da, "ensure_built", no_build)
    q, k, v = _inputs(12, 2, 1, 256, 16, 8)
    k8 = {key: torch.from_numpy(a) for key, a in _int8_stack(k).items()}
    v8 = {key: torch.from_numpy(a) for key, a in _int8_stack(v).items()}
    q = torch.from_numpy(q)
    counts = (da.LAUNCHES_INT8.count, da.LAUNCHES_W8A8.count)
    for w8a8 in (False, True):
        got = da.decode_attention(q, k8, v8, 200, 1, kv_width=256, w8a8=w8a8)
        want = da.decode_attention_plain(q, k8, v8, 200, 1, kv_width=256, w8a8=w8a8)
        assert torch.equal(got, want)
    assert (da.LAUNCHES_INT8.count, da.LAUNCHES_W8A8.count) == counts
    # W8A8 scores exist only over the int8 cache with a GQA group of 2 to 4.
    with pytest.raises(ValueError, match="W8A8"):
        da.decode_attention(q, torch.from_numpy(k), torch.from_numpy(v), 200, 1, w8a8=True)
    mha = {key: t[..., :1, :] if key == "q8" else t[:, :, :1] for key, t in k8.items()}
    with pytest.raises(ValueError, match="W8A8"):
        da.decode_attention(q[:, :, :1], mha, mha, 200, 1, w8a8=True)
    with pytest.raises(ValueError, match="int8 dicts"):
        da.decode_attention(q, k8, torch.from_numpy(v), 200, 1)
    assert da.w8a8_supported(32, 8) and da.w8a8_supported(16, 8)
    assert not da.w8a8_supported(8, 8) and not da.w8a8_supported(8, 1)


# -- head width 256 ---------------------------------------------------------------

DH256_CASES = [
    # (b, w, hq, hkv, pos, window, row_start): GQA group 2, so W8A8 applies
    (2, 384, 4, 2, 300, None, (0, 37)),
    (2, 512, 4, 2, 450, 128, (5, 0)),     # window, a ragged row
]


@pytest.mark.parametrize("state", [False, True], ids=["out", "state"])
@pytest.mark.parametrize("variant", ["bf16", "int8", "w8a8"])
@pytest.mark.parametrize("case", DH256_CASES)
def test_dh256_plain_matches_jax_interpret(monkeypatch, case, variant, state):
    """Each variant's plain version at dh 256 against the TPU kernel in
    interpret mode: bf16 at 1e-5, the int8 cache and W8A8 at 2e-4 (the
    tolerances above); with ``return_state`` its m and l at the same."""
    b, w, hq, hkv, pos, window, rs = case
    q, k, v = _inputs(14, 2, b, w, hq, hkv, dh=256)
    kw = dict(sliding_window=window, return_state=state)
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1" if variant == "w8a8" else "0")
    tol = dict(atol=1e-5, rtol=1e-5) if variant == "bf16" else TOL8
    if variant != "bf16":
        k, v = _int8_stack(k), _int8_stack(v)
    tk, tv, jk, jv = (
        (torch.from_numpy(k), torch.from_numpy(v), jnp.asarray(k), jnp.asarray(v))
        if variant == "bf16" else
        tuple({key: f(a) for key, a in side.items()}
              for f in (torch.from_numpy, jnp.asarray) for side in (k, v)))
    rs_t = torch.tensor(rs, dtype=torch.int32)
    got = da.decode_attention_plain(torch.from_numpy(q), tk, tv, pos, 1, rs_t,
                                    w8a8=variant == "w8a8", **kw)
    with jax.default_matmul_precision("highest"):
        want = jax_decode(jnp.asarray(q), jk, jv, jnp.int32(pos), jnp.int32(1),
                          jnp.asarray(rs, jnp.int32), interpret=True, **kw)
    got, want = (got, want) if state else ((got,), (want,))
    got = [x.numpy() for x in got]
    assert got[0].shape == (b, 1, hq, 256)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours, np.asarray(theirs), **tol)


def test_dh256_w8a8_quantizes_the_whole_head(monkeypatch):
    """A q whose largest value lies in dims 128-255 (on a dimension where
    every K code is 0): the per-head scale must come from all 256 dims. The
    plain version holds the TPU kernel's codes, and its output moves far
    from the int8 variant's (the case the card holds the kernel to)."""
    b, w, hq, hkv, pos = 1, 256, 4, 2, 255
    q, k, v = _inputs(15, 1, b, w, hq, hkv, dh=256)
    q[..., 200] = 127.0
    k8, v8 = _int8_stack(k), _int8_stack(v)
    k8["q8"][..., 200] = 0
    monkeypatch.setenv("LLMC_DECODE_W8A8", "1")
    want = _jax8(q, k8, v8, pos)
    got = _port8(q, k8, v8, pos, w8a8=True)
    np.testing.assert_allclose(got, want, **TOL8)
    gap = np.abs(got - _port8(q, k8, v8, pos)).max()
    assert gap > 0.2 * np.abs(want).max()
