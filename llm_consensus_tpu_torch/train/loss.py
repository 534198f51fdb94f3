"""Next-token cross-entropy and the distillation loss (port of
``llm_consensus_tpu/train/loss.py``).

fp32 end to end: logits leave the model in fp32 (``unembed``) and the
log-softmax and the gather stay there.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy over masked positions (a 0-d fp32 tensor).

    ``logits`` [B, T, V]; ``targets`` [B, T] are already shifted (targets[t]
    follows inputs[t]); ``mask`` [B, T] is 1.0 where a position counts."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def distill_loss(logits: torch.Tensor, teacher_logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *, temperature: float = 2.0,
                 alpha: float = 0.5) -> tuple[torch.Tensor, dict]:
    """``alpha * KL(teacher || student) + (1 - alpha) * CE(targets)``.

    Both distributions soften at ``temperature`` and the KL term carries the
    ``T^2`` gradient-scale correction; the hard half is
    :func:`cross_entropy_loss` on the verdict tokens. ``mask`` gates both
    halves. The teacher's logits are detached: no gradient reaches them.
    Returns ``(loss, {"kl", "ce"})``."""
    t = float(temperature)
    logits = logits.float()
    teacher_logits = teacher_logits.detach().float()
    logp_s = torch.log_softmax(logits / t, dim=-1)
    logp_t = torch.log_softmax(teacher_logits / t, dim=-1)
    kl_tok = (logp_t.exp() * (logp_t - logp_s)).sum(dim=-1)  # [B, T]
    if mask is None:
        kl = kl_tok.mean()
    else:
        m = mask.float()
        kl = (kl_tok * m).sum() / m.sum().clamp_min(1.0)
    kl = kl * (t * t)
    ce = cross_entropy_loss(logits, targets, mask)
    a = float(alpha)
    return a * kl + (1.0 - a) * ce, {"kl": kl, "ce": ce}


__all__ = ["cross_entropy_loss", "distill_loss"]
