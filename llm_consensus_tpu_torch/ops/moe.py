"""Mixture-of-experts block, Mixtral-style top-k routing (port of
``llm_consensus_tpu/ops/moe.py``).

Same semantics as the JAX block, which dispatches tokens to per-expert
capacity buffers with one-hot einsums: each expert holds ``capacity`` slots,
a token's k choices claim slots in token order (token-major, then k), and a
choice past its expert's capacity is dropped (contributes zero). Each slot
holds at most one token, so the port gathers and scatters by (expert, slot)
index instead of the one-hot products; the results are the same. The three
expert products run dense over all ``E x capacity`` slots as batched
matmuls through ``mm`` (``ops/quant.qmatmul``, quantized weights included),
as the JAX package leaves them to XLA: no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llm_consensus_tpu_torch.ops.mlp import _activate
from llm_consensus_tpu_torch.ops.quant import qmatmul


def route(x2: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Router logits, float32 ``tokens @ w_router`` [N, E], and each
    token's ``top_k`` choices: (gates [N, k] — a softmax over the selected
    logits only — and expert indices [N, k]). Among equal logits the lower
    expert index comes first, as ``jax.lax.top_k`` orders them (a stable
    descending sort)."""
    logits = x2.float() @ w_router.float()
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[:, :top_k], idx[:, :top_k]
    return torch.softmax(top, dim=-1), idx


def moe_block(
    x: torch.Tensor,         # [B, T, D]
    w_router: torch.Tensor,  # [D, E]
    w_gate,                  # [E, D, F] (or quantized)
    w_up,                    # [E, D, F]
    w_down,                  # [E, F, D]
    top_k: int,
    capacity_factor: float = 2.0,
    activation: str = "silu",
    mm=qmatmul,              # the engine's matmul (W8A8 / int4 settings bound)
) -> torch.Tensor:
    b, t, d = x.shape
    e = w_router.shape[-1]
    n = b * t  # every row and position the forward sees, pads included
    tokens = x.reshape(n, d)
    gates, idx = route(tokens, w_router, top_k)

    capacity = max(1, int(top_k * n * capacity_factor / e))
    # Each choice's place in its expert's buffer: an exclusive cumulative
    # count over the flattened [N * k] choices, token-major then k.
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, e)
    place = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = place < capacity
    slot = torch.where(kept, flat * capacity + place, e * capacity)  # dropped → spare row

    expert_in = x.new_zeros(e * capacity + 1, d)
    expert_in[slot] = tokens.repeat_interleave(top_k, dim=0)
    expert_in = expert_in[:-1].reshape(e, capacity, d)
    h = _activate(mm(expert_in, w_gate), activation) * mm(expert_in, w_up)
    expert_out = mm(h, w_down).reshape(e * capacity, d)

    # Combine: each token's kept choices, weighted by their gates cast to
    # x's dtype (the JAX block's combine.astype(x.dtype)), summed in float32.
    g = torch.where(kept, gates.reshape(-1).to(x.dtype), 0).float()
    picked = expert_out[slot.clamp(max=e * capacity - 1)].float()
    out = (picked * g[:, None]).reshape(n, top_k, d).sum(dim=1)
    return out.to(x.dtype).reshape(b, t, d)
