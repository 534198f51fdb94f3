"""FLOPs and bytes accounting: parameter counts, per-token FLOPs, device
peaks, decode MFU/MBU (the parts of ``llm_consensus_tpu/utils/flops.py``
the port needs, with NVIDIA peaks in place of TPU ones).

Counts follow the standard 2·N matmul FLOPs-per-token rule with the
attention quadratic term added explicitly; MoE counts only the experts a
token is routed through.
"""

from __future__ import annotations

from typing import Optional

from llm_consensus_tpu_torch.models.config import ModelConfig


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count for ``cfg`` (``active_only``: MoE experts
    a token visits, not the checkpoint's total)."""
    d, dh = cfg.d_model, cfg.head_dim
    q = d * cfg.n_heads * dh
    kv = 2 * d * cfg.n_kv_heads * dh
    o = cfg.n_heads * dh * d
    attn = q + kv + o
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
    mlp_one = 3 * d * cfg.d_ff  # gate + up + down
    if cfg.is_moe:
        n_mlp = cfg.experts_per_token if active_only else cfg.n_experts
        mlp = n_mlp * mlp_one + d * cfg.n_experts  # + router
    else:
        mlp = mlp_one
    norms = 2 * d
    per_layer = attn + mlp + norms
    embed = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return cfg.n_layers * per_layer + embed + head + d  # + final norm


def flops_per_token(cfg: ModelConfig, context_len: int = 0) -> float:
    """Forward-pass FLOPs for one token at the given KV-cache depth: 2 per
    weight (embedding lookup excluded, unembed included) plus the
    attention term 2·2·L·H·dh·S."""
    weights = param_count(cfg, active_only=True)
    if not cfg.tie_embeddings:
        weights -= cfg.vocab_size * cfg.d_model
    attn_quad = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * max(0, context_len)
    return 2.0 * weights + float(attn_quad)


def decode_bytes_per_token(cfg: ModelConfig, context_len: int = 0,
                           weight_bytes: float = 2, kv_bytes: float = 2) -> float:
    """Device-memory bytes streamed per decode step: active weights + the
    KV read."""
    weights = param_count(cfg, active_only=True)
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * max(0, context_len)
    return float(weights * weight_bytes + kv * kv_bytes)


# Published dense bf16 tensor-core FLOP/s and memory bytes/s per card
# (NVIDIA data sheets), matched by substring of torch.cuda.get_device_name;
# the PCIe part is listed before the SXM part it would otherwise match.
_PEAKS = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
    ("h200", 989e12, 4.8e12),
)


def device_peaks(device_name: str) -> Optional[tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of a card, or None when unknown (e.g. CPU)."""
    name = device_name.lower()
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
    return None


def decode_mfu(cfg: ModelConfig, tokens_per_sec: float, device_name: str,
               context_len: int = 0) -> Optional[float]:
    """Model FLOPs utilization of a decode stream, or None off-GPU."""
    peaks = device_peaks(device_name)
    if peaks is None or tokens_per_sec <= 0:
        return None
    return tokens_per_sec * flops_per_token(cfg, context_len) / peaks[0]


def decode_mbu(cfg: ModelConfig, tokens_per_sec: float, device_name: str,
               context_len: int = 0, weight_bytes: float = 2,
               kv_bytes: float = 2) -> Optional[float]:
    """Memory-bandwidth utilization of a decode stream, or None off-GPU."""
    peaks = device_peaks(device_name)
    if peaks is None or tokens_per_sec <= 0:
        return None
    per_tok = decode_bytes_per_token(cfg, context_len, weight_bytes, kv_bytes)
    return tokens_per_sec * per_tok / peaks[1]


def batched_decode_mbu(cfg: ModelConfig, tokens_per_sec: float, batch: int, device_name: str,
                       context_len: int = 0, weight_bytes: float = 2,
                       kv_bytes: float = 2) -> Optional[float]:
    """Memory-bandwidth utilization of a ``batch``-stream shared-frontier
    decode: the rows share one weight read a step and each reads its own
    KV, so bytes a step = weights + batch·kv at an aggregate step rate of
    ``tokens_per_sec / batch``. None off-GPU."""
    peaks = device_peaks(device_name)
    if peaks is None or tokens_per_sec <= 0 or batch <= 0:
        return None
    per_step = decode_bytes_per_token(cfg, batch * context_len, weight_bytes, kv_bytes)
    return (tokens_per_sec / batch) * per_step / peaks[1]
