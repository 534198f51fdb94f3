"""Grouped-query attention with causal / sliding-window masking (port of
``llm_consensus_tpu/ops/attention.py``, the plain attention op).

GQA stays grouped (queries reshaped to [B, T, Hkv, G, dh] against the
shared KV heads, no repeated K/V), softmax in fp32. The model routes the
chunked-prefill path, batched admission and suffix prefill here, as the
JAX package routes them to XLA; the flash and decode kernels
(ops/kernels/) serve one-shot prefill and decode. ``prefix_attention`` and
``merge_attention_states`` are the shared-prefix decode path's two-source
softmax (plain PyTorch: the JAX package runs them in XLA too).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # large-negative mask value that survives bf16 softmax math


def make_attention_mask(
    q_positions: torch.Tensor,   # [B, Tq]
    kv_positions: torch.Tensor,  # [B, Skv]
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean attention mask [B, Tq, Skv] (True = may attend)."""
    causal = kv_positions[:, None, :] <= q_positions[:, :, None]
    if sliding_window is not None:
        in_window = kv_positions[:, None, :] > (q_positions[:, :, None] - sliding_window)
        causal = causal & in_window
    if kv_valid is not None:
        causal = causal & kv_valid[:, None, :]
    return causal


def attention(
    q: torch.Tensor,     # [B, T, Hq, dh]
    k: torch.Tensor,     # [B, S, Hkv, dh]
    v: torch.Tensor,     # [B, S, Hkv, dh]
    mask: torch.Tensor,  # [B, T, S] bool
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    return_state: bool = False,
):
    """Masked GQA attention → [B, T, Hq, dh].

    ``return_state=True`` also returns the softmax state ``(m, l)`` as fp32
    [B, T, Hq]: the max of the scaled (softcapped, masked) scores and the
    softmax denominator at that max, so two results over disjoint KV
    sources merge exactly (:func:`merge_attention_states`). A fully masked
    row subtracts against 0, so its ``l`` is 0 and the merge drops it.
    """
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, t, hkv, groups, dh)
    # scores [B, Hkv, G, T, S] in fp32 for a stable softmax
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    if not return_state:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
        return out.reshape(b, t, hq, dh)
    out, m, l = _normalized(scores, "bkgts,bskd->btkgd", v)
    return out.reshape(b, t, hq, dh), _to_bth(m, b, t, hq), _to_bth(l, b, t, hq)


def _normalized(scores: torch.Tensor, pv_eq: str, v: torch.Tensor):
    """Softmax state and normalized P.V of masked fp32 scores [B, Hkv, G,
    T, S]: ``(out [B, T, Hkv, G, dh] in v's dtype, m, l [B, Hkv, G, T])``.
    A fully masked row's max is ``NEG_INF``; it subtracts against 0
    instead, so its l is 0 (not S)."""
    m = scores.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum(pv_eq, p.to(v.dtype), v)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    # The division runs in out's dtype, as the JAX package casts l.
    out = out / safe_l.permute(0, 3, 1, 2)[..., None].to(out.dtype)
    return out, m, l


def _to_bth(a: torch.Tensor, b: int, t: int, hq: int) -> torch.Tensor:
    """[B, Hkv, G, T] → [B, T, Hq] (head-major within each kv group, the
    ordering of q's reshape)."""
    return a.permute(0, 3, 1, 2).reshape(b, t, hq)


def prefix_attention(
    q: torch.Tensor,     # [B, T, Hq, dh] (RoPE'd queries)
    pk: torch.Tensor,    # [P, Hkv, dh]: ONE shared prefix, no batch axis
    pv: torch.Tensor,    # [P, Hkv, dh]
    prefix_len,          # int or int32 scalar: valid prefix slots (<= P)
    active: Optional[torch.Tensor],  # [B] bool: rows that attend the prefix
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
):
    """Attention of every query against one shared prefix KV, with state.

    The prefix lies wholly in the past of every query, so the only mask is
    ``col < prefix_len`` and the per-row ``active`` flag; the scores are
    one batched matmul over the single [P, Hkv, dh] copy. Inactive rows
    return ``(m = NEG_INF, l = 0)``, which the merge treats as no
    contribution. Returns ``(out [B, T, Hq, dh], m [B, T, Hq], l [B, T, Hq])``.
    """
    b, t, hq, dh = q.shape
    p, hkv, _ = pk.shape
    groups = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, t, hkv, groups, dh)
    scores = torch.einsum("btkgd,skd->bkgts", qg.float(), pk.float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    valid = (torch.arange(p, device=q.device) < prefix_len)[None, :].expand(b, p)
    if active is not None:
        valid = valid & active.to(device=q.device, dtype=torch.bool)[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    out, m, l = _normalized(scores, "bkgts,skd->btkgd", pv)
    return out.reshape(b, t, hq, dh), _to_bth(m, b, t, hq), _to_bth(l, b, t, hq)


def merge_attention_states(
    o1: torch.Tensor,  # [B, T, Hq, dh]: normalized attention over source 1
    m1: torch.Tensor,  # [B, T, Hq] fp32
    l1: torch.Tensor,  # [B, T, Hq] fp32
    o2: torch.Tensor,
    m2: torch.Tensor,
    l2: torch.Tensor,
) -> torch.Tensor:
    """Exact combine of two attention results over disjoint KV sources:
    with m = max(m1, m2) and w_i = l_i exp(m_i - m), the full softmax is
    (w1 o1 + w2 o2) / (w1 + w2), in fp32, cast to ``o1``'s dtype. A source
    with nothing valid (l = 0) drops out."""
    m = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m)
    w2 = l2 * torch.exp(m2 - m)
    denom = w1 + w2
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = (o1.float() * (w1 / denom)[..., None]
           + o2.float() * (w2 / denom)[..., None])
    return out.to(o1.dtype)
