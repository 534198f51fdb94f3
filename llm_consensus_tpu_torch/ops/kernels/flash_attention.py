"""Causal GQA flash attention for prefill: CUDA kernel and its plain version.

The port of ``llm_consensus_tpu/ops/pallas/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) runs on CUDA tensors; :func:`flash_attention`
launches it, or raises, for CUDA tensors and uses
:func:`flash_attention_plain` only for tensors on the CPU. The plain
version repeats the TPU kernel's arithmetic step by step: blocks over the
causal frontier, an fp32 online softmax with the same ``NEG_INF``, p cast
to v's dtype before P.V, and l = 0 rows output as 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_consensus_tpu_torch.obs import roofline as _roofline
from llm_consensus_tpu_torch.ops.kernels.build import (
    LaunchCounter, check, ensure_built)

NEG_INF = -1e30  # the TPU kernel's mask value (ops/attention.py uses -2**30)

# Head widths the CUDA kernel is instantiated for (csrc/flash_attention.cu).
HEAD_DIMS = (32, 64, 128, 256)

LAUNCHES = LaunchCounter()


def _pow2_block(n: int, cap: int) -> int:
    """Largest power-of-two ≤ cap that divides n (n itself need not be pow2)."""
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


def flash_supported(t: int, n_heads: int, n_kv_heads: int,
                    head_dim: Optional[int] = None) -> bool:
    """Whether the kernel takes this shape (the caller routes to the plain
    attention op if not): the TPU gate, plus the Hopper kernel's head widths
    when ``head_dim`` is given."""
    ok = t > 1 and n_heads % n_kv_heads == 0 and _pow2_block(t, 128) >= 8
    return ok and (head_dim is None or head_dim in HEAD_DIMS)


def _check_shapes(q, k, v, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention wants q [B,T,Hq,dh], k/v [B,S,Hkv,dh]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if hq % k.shape[2]:
        raise ValueError(f"n_heads {hq} not a multiple of n_kv_heads {k.shape[2]}")
    if k.shape[1] < q_offset + t:
        raise ValueError(
            f"k/v hold {k.shape[1]} positions but the causal frontier is "
            f"q_offset + T = {q_offset + t}"
        )


def flash_attention_plain(
    q: torch.Tensor,  # [B, T, Hq, dh]
    k: torch.Tensor,  # [B, S, Hkv, dh]
    v: torch.Tensor,  # [B, S, Hkv, dh]
    *,
    q_offset: int = 0,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch → [B, T, Hq, dh]."""
    block_k = 256  # the TPU kernel's default kv block
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    s_eff = min(s, q_offset + t)
    bk = 1  # smallest power of two covering s_eff, capped at block_k
    while bk < s_eff and bk < block_k:
        bk *= 2
    n_blocks = -(-s_eff // bk)
    pad = n_blocks * bk - s_eff
    kt = torch.nn.functional.pad(k[:, :s_eff], (0, 0, 0, 0, 0, pad))
    vt = torch.nn.functional.pad(v[:, :s_eff], (0, 0, 0, 0, 0, pad))

    dev = q.device
    qg = q.reshape(b, t, hkv, g, dh).float()
    rows = q_offset + torch.arange(t, device=dev)
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, t, dh), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        k0 = j * bk
        if k0 > q_offset + t - 1:
            break  # wholly above the diagonal of the last row
        if sliding_window is not None and k0 + bk <= q_offset - sliding_window + 1:
            continue  # wholly below the window of the first row
        kb = kt[:, k0:k0 + bk].float()
        vb = vt[:, k0:k0 + bk]
        sc = torch.einsum("btkgd,bskd->bkgts", qg, kb) * scale
        if logit_softcap is not None:
            sc = logit_softcap * torch.tanh(sc / logit_softcap)
        cols = k0 + torch.arange(bk, device=dev)
        mask = cols[None, :] <= rows[:, None]
        if sliding_window is not None:
            mask = mask & (cols[None, :] > rows[:, None] - sliding_window)
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).float(), vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l[..., None]  # [B, Hkv, G, T, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, dh).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA flash attention → [B, T, Hq, dh].

    Query row r attends kv positions p with ``p <= q_offset + r`` (and
    ``p > q_offset + r - sliding_window`` when windowed). KV beyond
    ``q_offset + T`` is never read. CPU tensors take the plain version;
    CUDA tensors launch the kernel (bf16, contiguous) or raise. Under a
    roofline capture (obs/roofline.py) the call books its own work.
    """
    _check_shapes(q, k, v, q_offset)
    args = (q, k, v, q_offset, scale, sliding_window, logit_softcap)
    if _roofline.CAPTURING:
        cap = _roofline.current_capture()
        if cap is not None:
            with cap.kernel(*flash_work(q, k, q_offset, sliding_window)):
                return _flash(*args)
    return _flash(*args)


def flash_work(q: torch.Tensor, k: torch.Tensor, q_offset: int = 0,
               sliding_window: Optional[int] = None) -> tuple[float, float, float]:
    """(FLOPs, bytes, output bytes) of one call: QK^T and PV over the
    causal (and windowed) pairs; q, k and v read once, the output written
    once."""
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    s_eff = min(k.shape[1], q_offset + t)
    win = sliding_window or (q_offset + t)
    pairs = sum(min(q_offset + r + 1, win) for r in range(t))
    item = q.element_size()
    out_b = float(item * b * t * hq * dh)
    return 4.0 * b * hq * dh * pairs, out_b * 2 + 2.0 * item * b * s_eff * hkv * dh, out_b


def _flash(q, k, v, q_offset, scale, sliding_window, logit_softcap) -> torch.Tensor:
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_offset=q_offset, scale=scale,
            sliding_window=sliding_window, logit_softcap=logit_softcap,
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no build for head_dim {dh}")
    scale = dh ** -0.5 if scale is None else scale
    lib = ensure_built()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.llmc_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, s, min(s, q_offset + t), hq, hkv, dh, q_offset,
            sliding_window or 0, float(logit_softcap or 0.0), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(lib, err, "flash_attention")
    LAUNCHES.add()
    return out
