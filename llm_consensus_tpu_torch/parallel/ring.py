"""Ring attention: sequence parallelism over an ``sp`` axis (port of
``llm_consensus_tpu/parallel/ring.py``).

Each position keeps its query block resident and sees every KV block once,
the blocks travelling round the ring by copy (``.to(device)``: a
device-to-device copy between cards, nothing on one card or the CPU). At
hop ``h`` position ``s`` holds block ``(s - h) mod n``, the order JAX's
``ppermute`` ring gives, and blocks combine with the online-softmax
recurrence in float32 (running max ``m``, normalizer ``l``, unnormalized
accumulator). Causality rides on absolute positions carried with each
block, so masking needs no hop arithmetic and sliding windows compose.

JAX's ``_block_attention`` is an einsum, not a Pallas kernel: plain
PyTorch is the port. The engine's sequence-parallel prefill
(models/transformer.py ``forward_ring_prefill``) runs
:func:`ring_attention_blocks` per head shard.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from llm_consensus_tpu_torch.ops.attention import NEG_INF
from llm_consensus_tpu_torch.parallel.mesh import Mesh


def _block_attention(q, k, v, mask, scale: float, logit_softcap: Optional[float]):
    """One KV block's (scores max, exp-weighted sums): ``q`` [B, T, Hkv, G,
    dh], ``k``/``v`` [B, S, Hkv, dh], ``mask`` [B, T, S] bool."""
    scores = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    m = mask[:, None, None]
    scores = torch.where(m, scores, NEG_INF)
    block_max = scores.amax(dim=-1)                                   # [B, Hkv, G, T]
    p = torch.where(m, torch.exp(scores - block_max[..., None]), 0.0)
    block_sum = p.sum(dim=-1)
    block_out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)
    return block_max, block_sum, block_out


def ring_attention_blocks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], positions: Sequence[torch.Tensor],
                          scale: float, sliding_window: Optional[int] = None,
                          logit_softcap: Optional[float] = None) -> list:
    """Causal GQA attention of every query block over every KV block.

    ``qs[s]`` [B, Tb, Hq, dh], ``ks[s]``/``vs[s]`` [B, Tb, Hkv, dh] and
    ``positions[s]`` [B, Tb] (absolute) live on ring position ``s``'s
    device; returns each block's output [B, Tb, Hq, dh] in ``q``'s dtype on
    that device."""
    n = len(qs)
    outs = []
    for s in range(n):
        q = qs[s]
        b, tl, hq, dh = q.shape
        hkv = ks[s].shape[2]
        g = hq // hkv
        dev = q.device
        qg = q.reshape(b, tl, hkv, g, dh)
        q_pos = positions[s]
        out = torch.zeros((b, tl, hkv, g, dh), dtype=torch.float32, device=dev)
        m = torch.full((b, hkv, g, tl), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, tl), dtype=torch.float32, device=dev)
        for hop in range(n):
            src = (s - hop) % n
            k_blk, v_blk = ks[src].to(dev), vs[src].to(dev)
            kv_pos = positions[src].to(dev)
            causal = kv_pos[:, None, :] <= q_pos[:, :, None]
            if sliding_window is not None:
                causal = causal & (kv_pos[:, None, :] > q_pos[:, :, None] - sliding_window)
            blk_max, blk_sum, blk_out = _block_attention(qg, k_blk, v_blk, causal, scale,
                                                         logit_softcap)
            m_new = torch.maximum(m, blk_max)
            corr = torch.exp(m - m_new)
            blk_corr = torch.exp(blk_max - m_new)
            l = l * corr + blk_sum * blk_corr
            out = (out * corr.movedim(-1, 1)[..., None]
                   + blk_out.float() * blk_corr.movedim(-1, 1)[..., None])
            m = m_new
        out = out / l.movedim(-1, 1)[..., None].clamp_min(1e-30)
        outs.append(out.reshape(b, tl, hq, dh).to(q.dtype))
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = "sp", scale: Optional[float] = None,
                   sliding_window: Optional[int] = None,
                   logit_softcap: Optional[float] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Causal GQA attention of ``q`` [B, S, Hq, dh] over ``k``/``v`` [B, S,
    Hkv, dh] with the sequence split over ``axis_name``: each position gets
    its block of S / n on its device and no position ever holds the whole
    sequence's K/V at once. Equals the plain causal attention; S must
    divide by the axis size.

    ``head_axis`` also splits the heads (tensor parallelism inside the
    ring): rings then run per head shard, which never communicate; it
    must divide both head counts. The result comes back on ``q``'s device."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by {axis_name}={n}")
    nh = 1
    if head_axis is not None:
        nh = mesh.shape[head_axis]
        if q.shape[2] % nh or k.shape[2] % nh:
            raise ValueError(f"head counts {q.shape[2]}/{k.shape[2]} not divisible by "
                             f"{head_axis}={nh}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    b, s_len = q.shape[:2]
    tb = s_len // n
    pos = torch.arange(s_len, device=q.device)[None, :].expand(b, s_len)
    hq_l, hkv_l = q.shape[2] // nh, k.shape[2] // nh
    heads = []
    for j in range(nh):
        devs = [mesh.devices.flat[mesh.flat_index(**{axis_name: s, **(
            {head_axis: j} if head_axis else {})})].torch_device for s in range(n)]

        def block(t, s, h, d=devs):
            return t[:, s * tb:(s + 1) * tb, j * h:(j + 1) * h].to(d[s])

        outs = ring_attention_blocks(
            [block(q, s, hq_l) for s in range(n)], [block(k, s, hkv_l) for s in range(n)],
            [block(v, s, hkv_l) for s in range(n)],
            [pos[:, s * tb:(s + 1) * tb].to(devs[s]) for s in range(n)],
            scale, sliding_window, logit_softcap)
        heads.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return torch.cat(heads, dim=2)


__all__ = ["ring_attention", "ring_attention_blocks"]
