"""The port's mixture-of-experts block (ops/moe.py) and its expert matmuls
(ops/quant.py, ``[E, C, K] @ [E, K, N]``) against the JAX package's.

The same seeded numpy inputs go through the JAX ``moe_block`` and the
port's. Routing is compared exactly (the JAX top-k indices and the port's,
ties included); outputs in float32 within 1e-5 absolute and relative (a
float32 sum of D products in another order), through int8 expert weights
within the JAX package's ``qeinsum`` tolerance (1e-4 relative, 1e-5
absolute), through int4 within the nibble dot's 2e-3, and through W8A8
within 1e-5. A dropped choice contributes exactly zero on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.ops import quant as jq
from llm_consensus_tpu.ops.moe import moe_block as jax_moe
from llm_consensus_tpu_torch.ops import quant as tq
from llm_consensus_tpu_torch.ops.moe import moe_block, route

TOL = dict(atol=1e-5, rtol=1e-5)
TOL8 = dict(atol=1e-5, rtol=1e-4)
TOL4 = dict(atol=2e-3, rtol=2e-3)
D, F = 64, 128


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, e, d=D, f=F):
    return (_rand(seed, d, e, scale=0.3), _rand(seed + 1, e, d, f, scale=d ** -0.5),
            _rand(seed + 2, e, d, f, scale=d ** -0.5), _rand(seed + 3, e, f, d, scale=f ** -0.5))


def _both(x, ws, top_k=2, cf=2.0, tws=None, jws=None):
    jws = jws or [jnp.asarray(w) for w in ws]
    tws = tws or [_t(w) for w in ws]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_moe(jnp.asarray(x), *jws, top_k=top_k, capacity_factor=cf))
    got = moe_block(_t(x), *tws, top_k=top_k, capacity_factor=cf).numpy()
    return got, want


def _dropped_rows(x, w_router, top_k, cf):
    """Tokens all of whose choices the reference's capacity rule drops."""
    n = x.shape[0] * x.shape[1]
    e = w_router.shape[-1]
    logits = x.reshape(n, -1) @ w_router
    idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), top_k)[1]).reshape(-1)
    cap = max(1, int(top_k * n * cf / e))
    seen = np.zeros(e, int)
    kept = np.zeros(n * top_k, bool)
    for i, ex in enumerate(idx):
        kept[i] = seen[ex] < cap
        seen[ex] += 1
    return ~kept.reshape(n, top_k).any(axis=1)


@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("cf", [8.0, 2.0, 0.5], ids=["ample", "default", "drops"])
@pytest.mark.parametrize("bt", [(1, 1), (2, 32), (3, 17)], ids=["decode", "2x32", "3x17"])
def test_moe_block_matches_jax(bt, cf, e):
    x = _rand(1, *bt, D)
    ws = _weights(10, e)
    got, want = _both(x, ws, cf=cf)
    np.testing.assert_allclose(got, want, **TOL)
    gone = _dropped_rows(x, ws[0], 2, cf)
    if cf == 0.5 and bt != (1, 1):
        assert gone.any()  # the case really drops tokens
    assert not got.reshape(-1, D)[gone].any() and not want.reshape(-1, D)[gone].any()


def test_routing_equals_jax_top_k_including_ties():
    """tests/test_models.py's all-ties case: x = ones, w_router = eye. Every
    logit ties; JAX takes the lower index first, and so does the port."""
    e, d, f = 4, 16, 32
    x = np.ones((1, 4, d), np.float32)
    wr = np.eye(d, e, dtype=np.float32)
    ws = (wr, np.full((e, d, f), 0.01, np.float32), np.full((e, d, f), 0.01, np.float32),
          np.full((e, f, d), 0.01, np.float32))
    _, want_idx = jax.lax.top_k(jnp.asarray(x.reshape(4, d) @ wr), 2)
    gates, idx = route(_t(x.reshape(4, d)), _t(wr), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert idx[:, 0].eq(0).all() and idx[:, 1].eq(1).all()
    np.testing.assert_allclose(gates.numpy(), 0.5)
    for cf in (0.01, 2.0):
        got, want = _both(x, ws, cf=cf)
        np.testing.assert_allclose(got, want, **TOL)
    # Capacity 1: only the first token keeps its choices.
    got, _ = _both(x, ws, cf=0.01)
    assert got[0, 0].any() and not got[0, 1:].any()


def test_moe_block_left_padded_rows_take_capacity_like_jax():
    """B > 1 with left-pad rows, as the batcher lays them out: each row's
    first positions hold the pad token's embedding, every one identical,
    and they take expert capacity in token order as in the reference."""
    x = _rand(2, 4, 12, D)
    pad = _rand(3, D)
    for row, n_pad in enumerate((0, 3, 7, 11)):
        x[row, :n_pad] = pad
    ws = _weights(20, 8)
    for cf in (2.0, 0.5):
        got, want = _both(x, ws, cf=cf)
        np.testing.assert_allclose(got, want, **TOL)


def test_moe_block_bf16_matches_jax():
    """bf16 activations and weights: the gates cast to bf16 before the
    combine, as the reference casts them. Tolerance: 2 bf16 ulps of the
    largest output."""
    x = _rand(4, 2, 9, D)
    ws = _weights(30, 8)
    jws = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    tws = [_t(w).to(torch.bfloat16) for w in ws]
    want = np.asarray(jax_moe(jnp.asarray(x, jnp.bfloat16), *jws, top_k=2).astype(jnp.float32))
    got = moe_block(_t(x).to(torch.bfloat16), *tws, top_k=2).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * 2 ** -8 * np.abs(want).max(), rtol=0)


def _quantized(ws, mode):
    leaf = jq._quantize4_leaf if mode == "int4" else jq._quantize_leaf
    jws = [jnp.asarray(ws[0])] + [leaf(jnp.asarray(w)) for w in ws[1:]]
    tws = [_t(ws[0])] + [{k: _t(v) for k, v in w.items()} for w in jws[1:]]
    return jws, tws


@pytest.mark.parametrize("mode,bt,tol", [
    ("int8", (1, 1), TOL8), ("int8", (2, 16), TOL8),
    ("int4", (1, 1), TOL4), ("int4", (2, 16), TOL4),
], ids=["int8-decode", "int8-prefill", "int4-decode", "int4-prefill"])
def test_moe_block_quantized_experts_match_jax(mode, bt, tol):
    """Expert weights from JAX's own quantizers. int4 at decode (E·C = 8
    rows: the nibble dot) and at prefill (E·C = 64 > 16: the dequantized
    weight), as the reference's qeinsum counts rows."""
    x = _rand(5, *bt, D)
    ws = _weights(40, 4, d=128, f=256) if mode == "int4" else _weights(40, 4)
    if mode == "int4":
        x = _rand(5, *bt, 128)
    jws, tws = _quantized(ws, mode)
    got, want = _both(x, ws, jws=jws, tws=tws)
    np.testing.assert_allclose(got, want, **tol)


def test_moe_block_w8a8_experts_match_jax():
    x = _rand(6, 2, 8, D)
    ws = _weights(50, 8)
    jws, tws = _quantized(ws, "int8")
    with jax.default_matmul_precision("highest"), jq.w8a8_scope(True):
        want = np.asarray(jax_moe(jnp.asarray(x), *jws, top_k=2))
    from functools import partial

    got = moe_block(_t(x), *tws, top_k=2, mm=partial(tq.qmatmul, w8a8=True)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = moe_block(_t(x), *tws, top_k=2).numpy()
    assert not np.allclose(plain, got, atol=1e-7, rtol=0)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4", "w8a8"])
def test_expert_matmul_matches_jax_qeinsum(mode):
    """``qmatmul`` in its expert form against ``qeinsum("ecd,edf->ecf")``,
    with empty (zero) slots among the rows."""
    e, c, d, f = 4, 3, 256, 24
    x = _rand(7, e, c, d)
    x[1, 2] = 0.0
    x[3] = 0.0
    w = _rand(8, e, d, f, scale=0.05)
    if mode == "bf16":
        jw, tw = jnp.asarray(w), _t(w)
    else:
        leaf = jq._quantize4_leaf if mode == "int4" else jq._quantize_leaf
        jw = leaf(jnp.asarray(w))
        tw = {k: _t(v) for k, v in jw.items()}
    with jax.default_matmul_precision("highest"), jq.w8a8_scope(mode == "w8a8"):
        want = np.asarray(jq.qeinsum("ecd,edf->ecf", jnp.asarray(x), jw))
    got = tq.qmatmul(_t(x), tw, w8a8=mode == "w8a8").numpy()
    np.testing.assert_allclose(got, want, **(TOL4 if mode == "int4" else TOL8))
    assert not got[3].any()
    if mode == "int4":
        # E·C = 12 rows: the nibble dot; forced at more rows it agrees
        # with the dequantized weight.
        xl = _t(_rand(9, e, 8, d))
        np.testing.assert_allclose(tq.qmatmul(xl, tw, int4_nibble=True).numpy(),
                                   tq.qmatmul(xl, tw).numpy(), **TOL4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_expert_leaf_quantizes_slice_by_slice_as_a_whole(mode):
    """A stacked expert leaf [L, E, D, F] quantized one [D, F] slice at a
    time equals the JAX quantizer over the whole leaf."""
    w = _rand(11, 2, 3, 256, 16)
    want = (jq._quantize4_leaf if mode == "int4" else jq._quantize_leaf)(jnp.asarray(w))
    got = tq.quantize_weight(_t(w), mode)
    for key, arr in want.items():
        assert got[key].shape == arr.shape
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr))
