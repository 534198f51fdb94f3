"""The port's ring attention (``parallel/ring.py``) held to ``tests/test_ring.py``
case by case: the same numpy q/k/v through the JAX reference (the plain causal
attention the JAX tests hold their ring to) and the port's ring over
``virtual_devices(n, "cpu")``. Tolerances, the JAX file's: float32 within
1e-5, bf16 within 5e-2 (relative and absolute)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.ops.attention import attention as jax_attention
from llm_consensus_tpu.ops.attention import make_attention_mask as jax_mask
from llm_consensus_tpu_torch.ops.attention import attention, make_attention_mask
from llm_consensus_tpu_torch.parallel import make_mesh, ring_attention, virtual_devices

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread beside other xdist workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b=2, s=32, hq=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))


def _jax_reference(q, k, v, sliding_window=None, logit_softcap=None, dtype=jnp.float32):
    b, s = q.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :], (b, s))
    mask = jax_mask(pos, pos, None, sliding_window)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = jax_attention(*args, mask, logit_softcap=logit_softcap)
    return np.asarray(out, np.float32)


def _ring(q, k, v, sp, dtype=torch.float32, **kw):
    mesh = make_mesh({"sp": sp}, virtual_devices(sp, "cpu"))
    out = ring_attention(*(torch.tensor(x, dtype=dtype) for x in (q, k, v)), mesh, **kw)
    return out


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_matches_full_attention(sp):
    q, k, v = _qkv(0)
    np.testing.assert_allclose(_ring(q, k, v, sp).numpy(), _jax_reference(q, k, v),
                               rtol=TOL, atol=TOL)


def test_sliding_window():
    q, k, v = _qkv(1, s=64)
    np.testing.assert_allclose(_ring(q, k, v, 4, sliding_window=16).numpy(),
                               _jax_reference(q, k, v, sliding_window=16), rtol=TOL, atol=TOL)


def test_gqa_groups():
    q, k, v = _qkv(2, hq=8, hkv=2)
    np.testing.assert_allclose(_ring(q, k, v, 4).numpy(), _jax_reference(q, k, v),
                               rtol=TOL, atol=TOL)


def test_bf16_inputs():
    q, k, v = _qkv(3)
    out = _ring(q, k, v, 4, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _jax_reference(q, k, v, dtype=jnp.bfloat16),
                               rtol=5e-2, atol=5e-2)


def test_rejects_indivisible_sequence():
    q, k, v = _qkv(4, s=36)
    with pytest.raises(ValueError, match="not divisible"):
        _ring(q, k, v, 8)


def test_grad_through_the_ring():
    """The JAX file's ``test_jit_under_mesh`` holds the ring under a
    transformation (``jax.jit``); the port's counterpart is autograd: the
    ring's gradients equal the plain causal attention's."""
    q, k, v = _qkv(5)
    mesh = make_mesh({"sp": 4}, virtual_devices(4, "cpu"))
    a = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    b = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ring_attention(*a, mesh)
    np.testing.assert_allclose(out.detach().numpy(), _jax_reference(q, k, v), rtol=TOL, atol=TOL)
    pos = torch.arange(32)[None, :].expand(2, 32)
    ref = attention(*b, make_attention_mask(pos, pos, None, None))
    w = torch.tensor(np.random.default_rng(9).standard_normal(out.shape).astype(np.float32))
    (out * w).sum().backward()
    (ref * w).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_logit_softcap_matches_full_attention():
    q, k, v = _qkv(6)
    np.testing.assert_allclose(_ring(q, k, v, 4, logit_softcap=30.0).numpy(),
                               _jax_reference(q, k, v, logit_softcap=30.0), rtol=TOL, atol=TOL)


def test_head_axis_rings_per_head_shard():
    """``head_axis`` (tp inside sp): rings per head shard equal full attention;
    a head count the axis does not divide is refused."""
    q, k, v = _qkv(7, hq=8, hkv=4)
    mesh = make_mesh({"sp": 2, "tp": 2}, virtual_devices(4, "cpu"))
    out = ring_attention(*(torch.tensor(x) for x in (q, k, v)), mesh, head_axis="tp")
    np.testing.assert_allclose(out.numpy(), _jax_reference(q, k, v), rtol=TOL, atol=TOL)
    q, k, v = _qkv(8, hq=4, hkv=2)
    mesh = make_mesh({"sp": 2, "tp": 4}, virtual_devices(8, "cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(*(torch.tensor(x) for x in (q, k, v)), mesh, head_axis="tp")
