"""Flash prefill attention of the port (ops/kernels/flash_attention.py)
against the JAX Pallas kernel run in interpret mode.

The plain version must match the TPU kernel over the cases of
tests/test_flash_attention.py (q_offset, window, softcap, ragged S,
several kv blocks), and at head width 256, at atol/rtol 1e-5 in float32. The CUDA kernel itself
runs only on a card: tests/test_torch_gpu.py holds it to this plain
version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_consensus_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from llm_consensus_tpu.ops.pallas.flash_attention import flash_supported as jax_supported
from llm_consensus_tpu_torch.ops.kernels import build
from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa

CASES = [
    # (b, t, s, hq, hkv, dh, q_offset, window, softcap)
    (1, 64, 64, 4, 4, 32, 0, None, None),       # MHA, square
    (1, 64, 256, 4, 2, 32, 0, None, None),      # GQA, cache larger than T
    (2, 32, 128, 8, 2, 16, 0, None, None),      # batch + 4-way GQA
    (1, 32, 128, 4, 2, 32, 64, None, None),     # chunked prefill (q_offset > 0)
    (1, 64, 128, 4, 4, 32, 0, 24, None),        # sliding window
    (1, 64, 64, 4, 2, 32, 0, None, 5.0),        # logit softcap
    (1, 48, 96, 4, 2, 32, 16, 20, 8.0),         # everything at once, ragged S
    (1, 256, 256, 4, 2, 32, 0, None, None),     # multi-kv-block: online carry
    (1, 128, 512, 4, 2, 32, 128, 96, None),     # multi-block + offset + window
    # head width 256 (gemma-7b's)
    (1, 128, 128, 2, 1, 256, 0, None, None),    # GQA
    (1, 64, 192, 2, 2, 256, 128, None, None),   # q_offset
    (1, 128, 128, 2, 2, 256, 0, 48, None),      # sliding window
    (1, 64, 64, 2, 1, 256, 0, None, 20.0),      # logit softcap
]


def _qkv(seed, b, t, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, hq, dh)).astype(np.float32),
        rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
        rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
    )


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_interpret(case):
    b, t, s, hq, hkv, dh, off, window, cap = case
    q, k, v = _qkv(0, b, t, s, hq, hkv, dh)
    with jax.default_matmul_precision("highest"):
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
                         sliding_window=window, logit_softcap=cap, interpret=True)
    got = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_offset=off,
        sliding_window=window, logit_softcap=cap,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_takes_plain_version(monkeypatch):
    """CPU tensors reach the plain version: no build, no launch counted."""
    def no_build():
        raise AssertionError("CPU tensors must not build the CUDA kernel")

    monkeypatch.setattr(build, "ensure_built", no_build)
    monkeypatch.setattr(fa, "ensure_built", no_build)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 48, 96, 4, 2, 32))
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, q_offset=16, sliding_window=20, logit_softcap=8.0)
    want = fa.flash_attention_plain(q, k, v, q_offset=16, sliding_window=20,
                                    logit_softcap=8.0)
    assert torch.equal(got, want)
    assert fa.LAUNCHES.count == before


def test_never_reads_beyond_frontier():
    """NaN in cache slots past q_offset + T must not reach the output."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 32, 256, 4, 2, 32))
    k_clean, v_clean = k.clone(), v.clone()
    k[:, 32:] = float("nan")
    v[:, 32:] = float("nan")
    got = fa.flash_attention(q, k, v)
    assert not bool(torch.isnan(got).any())
    assert torch.allclose(got, fa.flash_attention(q, k_clean[:, :32], v_clean[:, :32]),
                          atol=1e-6)


def test_kv_must_cover_the_frontier():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 32, 40, 4, 2, 32))
    with pytest.raises(ValueError, match="causal frontier"):
        fa.flash_attention(q, k, v, q_offset=16)


@pytest.mark.parametrize("t,hq,hkv", [(64, 8, 2), (16, 4, 4), (1, 8, 2), (20, 8, 3),
                                      (6, 8, 2), (512, 32, 8), (48, 16, 8)])
def test_gate_copies_the_tpu_gate(t, hq, hkv):
    assert fa.flash_supported(t, hq, hkv) == jax_supported(t, hq, hkv)


def test_gate_adds_the_kernel_head_widths():
    assert fa.flash_supported(64, 32, 8, head_dim=128)
    assert fa.flash_supported(64, 4, 2, head_dim=32)
    assert fa.flash_supported(64, 4, 2, head_dim=256)
    assert fa.flash_supported(512, 16, 16, head_dim=256)  # gemma-7b's prefill
    assert not fa.flash_supported(64, 4, 2, head_dim=16)
