"""Gated feed-forward blocks, SwiGLU / GeGLU (port of
``llm_consensus_tpu/ops/mlp.py``). Plain matmuls: a large matrix product
outside any kernel goes to ``torch.matmul`` (through ``ops/quant.qmatmul``,
which also takes quantized weights), as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llm_consensus_tpu_torch.ops.quant import qmatmul


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(x)
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def gated_mlp(
    x: torch.Tensor,       # [..., D]
    w_gate: torch.Tensor,  # [D, F]
    w_up: torch.Tensor,    # [D, F]
    w_down: torch.Tensor,  # [F, D]
    activation: str = "silu",
    mm=qmatmul,            # the engine's matmul (W8A8 / int4 settings bound)
) -> torch.Tensor:
    gate = _activate(mm(x, w_gate), activation)
    up = mm(x, w_up)
    return mm(gate * up, w_down)
