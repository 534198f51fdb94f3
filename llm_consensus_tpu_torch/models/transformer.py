"""Generic decoder-only transformer in PyTorch (port of
``llm_consensus_tpu/models/transformer.py``).

One implementation serves every family of the catalog via static
``ModelConfig`` switches, Mixtral's mixture-of-experts layer included
(ops/moe.py in place of the gated MLP). Parameters are a plain dict of
tensors with the JAX package's layout — layers stacked on axis 0, experts
on axis 1 — so a JAX parameter tree carries across
through :func:`params_from_numpy` unchanged. The KV cache is the same
layer-stacked [L, B, S, Hkv, dh] pair; where the JAX package writes it
functionally (``dynamic_update_slice`` with buffer donation) the port
updates it **in place**. Matmul weights may be quantized (int8 or int4
dicts, ops/quant.py) and the cache may be int8 (codes plus seq-minor
scales); every projection goes through ``qmatmul`` and every cache access
through the ``kv_*`` helpers of ops/quant.py.

Attention routing mirrors the JAX package, decided before the call from
shapes alone: a one-shot prefill at a static start runs the flash kernel,
a T = 1 decode step runs the decode kernel over the full stack, and
everything else (the chunked prefill at a running start, batched rows at
per-row ``row_start`` offsets, suffix prefill against a shared prefix) runs
the plain attention op (ops/attention.py), as the JAX package runs XLA
there. There is no fallback from a kernel to the plain op: a kernel that
fails raises.

The continuous batcher's forms follow the JAX forward: ``row_start`` makes
positions row-relative (right-aligned rows at one shared frontier), and a
shared ``prefix`` KV ([L, 1, P, Hkv, dh], read once per step by every row
flagged in ``prefix_rows``) is merged into each row's own attention with
the exact two-source softmax: the decode kernel's ``return_state`` form at
T = 1, the plain op's for T > 1.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import replace
from typing import Callable, Optional, Union

import numpy as np
import torch

from llm_consensus_tpu_torch.models.config import ModelConfig
from llm_consensus_tpu_torch.ops.attention import (
    attention, make_attention_mask, merge_attention_states, prefix_attention)
from llm_consensus_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_supported)
from llm_consensus_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_supported)
from llm_consensus_tpu_torch.ops.mlp import gated_mlp
from llm_consensus_tpu_torch.ops.moe import moe_block
from llm_consensus_tpu_torch.ops.norms import rms_norm
from llm_consensus_tpu_torch.ops.quant import (
    KV_MODES, QUANT_KEYS, WEIGHT_MODES, is_quantized, kv_capacity, kv_layer, kv_read,
    kv_write_rows, qmatmul, quantize_kv, quantize_weight, stack_layers)
from llm_consensus_tpu_torch.ops.rope import apply_rope, rope_angles, rope_inv_freq
from llm_consensus_tpu_torch.parallel.sharding import gather, reduce_sum

Pos = Union[int, torch.Tensor]

ATTN_IMPLS = ("flash", "torch")  # kernels where the shape allows, or the plain op
_NO_SCOPE = nullcontext()  # around each layer when no layer_scope is given


def _layer_shapes(cfg: ModelConfig) -> dict:
    d, dh, hq, hkv, f, l = (
        cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
    )
    shapes = {
        "attn_norm": (l, d), "mlp_norm": (l, d),
        "wq": (l, d, hq * dh), "wk": (l, d, hkv * dh), "wv": (l, d, hkv * dh),
        "wo": (l, hq * dh, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(l, hq * dh), bk=(l, hkv * dh), bv=(l, hkv * dh))
    if cfg.is_moe:
        e = cfg.n_experts
        shapes.update(w_router=(l, d, e), w_gate=(l, e, d, f), w_up=(l, e, d, f),
                      w_down=(l, e, f, d))
    else:
        shapes.update(w_gate=(l, d, f), w_up=(l, d, f), w_down=(l, f, d))
    return shapes


# -- parameters ----------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *, device: torch.device,
                dtype: torch.dtype = torch.bfloat16, quant: Optional[str] = None) -> dict:
    """Random-init parameters on ``device`` (layers stacked on axis 0).

    Each weight is drawn straight into ``dtype`` on the device from one
    seeded ``torch.Generator``, leaf by leaf: no float32 copy of the tree
    (or of one 3.7 GB stacked leaf of an 8B model) ever exists. With
    ``quant`` ("int8" | "int4") each matmul weight is quantized as soon as
    it is drawn and its ``dtype`` source dropped, so the peak is the
    quantized tree plus one ``dtype`` leaf (the JAX package's
    ``init_params_quantized``). The experts' stacked leaves [L, E, D, F]
    are drawn layer by layer, each layer's slice quantized as it is drawn:
    a whole leaf of Mixtral's (30.1 GB in bf16) never exists, so the peak
    is the quantized tree plus one layer's slice. The draws are the same
    with and without ``quant``. The values differ from the JAX package's
    ``init_params`` for the same seed (another generator);
    :func:`params_from_numpy` carries exact weights across.
    """
    if quant not in (None, *WEIGHT_MODES):
        raise ValueError(f"unknown quant mode {quant!r}")
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, std):
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, std, generator=gen)

    def normal(shape, std, name=""):
        w = draw(shape, std)
        if quant is not None and name in QUANT_KEYS:
            return quantize_weight(w, quant)
        return w

    def per_layer(shape, std):
        """An expert leaf drawn one layer at a time (and quantized as drawn)."""
        return stack_layers(shape[0], lambda _: draw(shape[1:], std), quant)

    d, dh, hq, hkv, f, l = (
        cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
    )
    proj_std = d ** -0.5
    norm_fill = 0.0 if cfg.norm_offset else 1.0  # offset form stores (w - offset)
    layers = {
        "attn_norm": torch.full((l, d), norm_fill, dtype=dtype, device=device),
        "mlp_norm": torch.full((l, d), norm_fill, dtype=dtype, device=device),
        "wq": normal((l, d, hq * dh), proj_std, "wq"),
        "wk": normal((l, d, hkv * dh), proj_std, "wk"),
        "wv": normal((l, d, hkv * dh), proj_std, "wv"),
        "wo": normal((l, hq * dh, d), (hq * dh) ** -0.5, "wo"),
    }
    if cfg.is_moe:
        e = cfg.n_experts
        layers["w_router"] = normal((l, d, e), proj_std, "w_router")
        layers["w_gate"] = per_layer((l, e, d, f), proj_std)
        layers["w_up"] = per_layer((l, e, d, f), proj_std)
        layers["w_down"] = per_layer((l, e, f, d), f ** -0.5)
    else:
        layers["w_gate"] = normal((l, d, f), proj_std, "w_gate")
        layers["w_up"] = normal((l, d, f), proj_std, "w_up")
        layers["w_down"] = normal((l, f, d), f ** -0.5, "w_down")
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((l, hq * dh), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((l, hkv * dh), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((l, hkv * dh), dtype=dtype, device=device)
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": torch.full((d,), norm_fill, dtype=dtype, device=device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), proj_std, "lm_head")
    return params


def params_from_numpy(tree: dict, cfg: ModelConfig, device: torch.device,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX package's parameter tree (``init_params`` layout, layers
    stacked on axis 0), given as numpy arrays, as the port's parameters on
    ``device`` in ``dtype``. Shapes are checked against ``cfg``. A tree
    quantized by the JAX package's ``quantize_params`` carries across as
    it is: int8 leaves ``{"q8", "s"}`` keep their int8 codes, int4 leaves
    ``{"q4", "s"}`` their packed uint8 bytes, and the scales come over in
    ``dtype``, so both packages compute with the same quantized weights.
    MoE trees alike: the router stays in ``dtype`` (never quantized), the
    stacked experts are [L, E, ...]."""

    def conv(name: str, arr, shape):
        if isinstance(arr, dict):
            return conv_quantized(name, arr, shape)
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, {cfg.name} wants {shape}")
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    def conv_quantized(name: str, leaf: dict, shape) -> dict:
        *lead, c, o = shape
        if "q8" in leaf:
            codes, code_shape, scale_shape = "q8", (*lead, c, o), (*lead, 1, o)
            code_dtype = np.int8
        elif "q4" in leaf:
            g = np.asarray(leaf["q4"]).shape[-2] * 2
            codes, code_shape, scale_shape = "q4", (*lead, c // g, g // 2, o), (*lead, c // g, 1, o)
            code_dtype = np.uint8
        else:
            raise ValueError(f"{name}: quantized leaf without codes: {sorted(leaf)}")
        q = np.asarray(leaf[codes])
        if tuple(q.shape) != code_shape or q.dtype != code_dtype:
            raise ValueError(f"{name}.{codes}: {q.dtype} {q.shape}, wants {code_shape}")
        return {
            codes: torch.from_numpy(np.array(q)).to(device),
            "s": conv(f"{name}.s", leaf["s"], scale_shape),
        }

    d = cfg.d_model
    shapes = _layer_shapes(cfg)
    missing = set(shapes) - set(tree["layers"])
    if missing:
        raise ValueError(f"layer params missing: {sorted(missing)}")
    params = {
        "embed": conv("embed", tree["embed"], (cfg.vocab_size, d)),
        "final_norm": conv("final_norm", tree["final_norm"], (d,)),
        "layers": {
            name: conv(f"layers.{name}", tree["layers"][name], shape)
            for name, shape in shapes.items()
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = conv("lm_head", tree["lm_head"], (d, cfg.vocab_size))
    return params


def param_leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) for every leaf of a parameter dict."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from param_leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def cache_map(fn, *caches):
    """``fn`` over the leaves of KV caches of one layout ({"k", "v"}, each a
    tensor or an int8 {"q8", "s"} dict), as a cache of the results."""
    first = caches[0]
    if isinstance(first, dict):
        return {name: cache_map(fn, *(c[name] for c in caches)) for name in first}
    return fn(*caches)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: Optional[int] = None, *,
                  device: torch.device, dtype: torch.dtype = torch.bfloat16,
                  quant: Optional[str] = None) -> dict:
    """Static-shaped KV cache {"k", "v"}: [L, B, S, Hkv, dh] zeros.

    ``quant="int8"`` stores each side as ``{"q8": int8 [L, B, S, Hkv, dh],
    "s": [L, B, Hkv, S] in dtype}``, the scales seq-minor as the decode
    kernels read them: half the memory and the decode reads of bf16.
    """
    s = max_seq or cfg.max_seq_len
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    if quant is None:
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    if quant not in KV_MODES:
        raise ValueError(f"unknown kv cache quant mode {quant!r}")

    def entry():
        return {
            "q8": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s), dtype=dtype,
                             device=device),
        }

    return {"k": entry(), "v": entry()}


# -- forward -------------------------------------------------------------------


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(d) scale) → [B, T, D]."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # The scale rounded to x's dtype first, as the JAX package casts it.
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor, mm=qmatmul) -> torch.Tensor:
    """Final norm + LM head (+ final logit softcap) → fp32 logits [B, T, V]
    (bf16 inputs accumulate and land in fp32 on the card, the JAX package's
    ``preferred_element_type=float32``). ``mm`` is the engine's matmul
    (:func:`qmatmul` with its W8A8 and int4 settings)."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, cfg.norm_offset)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = mm(x, head, torch.float32)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _roundtrip(fresh: torch.Tensor) -> torch.Tensor:
    """Fresh k/v as an int8 cache would give them back: quantized and
    dequantized in their own dtype."""
    q8, s = quantize_kv(fresh)
    return q8.to(fresh.dtype) * s


def _project(cfg: ModelConfig, x: torch.Tensor, lp: dict, mm) -> tuple:
    """Normed ``x`` through this layer's q/k/v projections (+ biases):
    flat [B, T, H * dh] each, heads as many as ``lp``'s columns hold."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps, cfg.norm_offset)
    q, k, v = mm(h, lp["wq"]), mm(h, lp["wk"]), mm(h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def _attention(
    cfg: ModelConfig,
    x: torch.Tensor,          # [B, T, D]
    qkv: tuple,               # _project(...): flat q, k, v
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],  # [B, T, S]; None on the kernel paths
    cache: Optional[dict],    # FULL stacks {"k", "v"} [L, B, S, Hkv, dh] (or int8 dicts)
    start_pos: Pos,
    layer_idx: int,
    layer_t: Optional[torch.Tensor],  # layer_idx as a device int32 scalar
    row_start: Optional[torch.Tensor],  # [B] int32 device (decode kernel)
    slots: Optional[torch.Tensor],    # device write slots (decode), or None
    flash_offset: Optional[int],
    kv_width: Optional[int],
    decode_flash: bool,
    decode_w8a8: bool,
    prefix: Optional[dict] = None,   # shared-prefix KV stacks, or None
    prefix_len=None,                  # int or int32 scalar: valid prefix slots
    prefix_rows: Optional[torch.Tensor] = None,  # [B] bool: rows attending the prefix
) -> torch.Tensor:
    """Rope, the cache write and attention over ``cfg``'s heads (all of
    them, or a tensor-parallel shard's): the attention output [B, T,
    Hq * dh] before the output projection."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv
    q = apply_rope(q.reshape(b, t, hq, dh), cos, sin)
    k = apply_rope(k.reshape(b, t, hkv, dh), cos, sin)
    v = v.reshape(b, t, hkv, dh)

    if cache is not None:
        # In place, quantized on write for an int8 cache (the JAX package
        # updates the stacks functionally and lets XLA alias the buffer).
        kv_write_rows(cache["k"], k, layer_idx, start_pos, slots)
        kv_write_rows(cache["v"], v, layer_idx, start_pos, slots)
        if decode_flash:
            # The decode kernel reads the full stacks (codes and scales)
            # at layer_t itself.
            k_att, v_att = cache["k"], cache["v"]
        elif flash_offset == 0 and (kv_width is None or kv_width >= t):
            # One-shot prefill from position 0: the causal frontier IS this
            # chunk, so attention needs exactly the fresh k/v. An int8 cache
            # round-trips them through quantize/dequantize so attention sees
            # bit for bit what a cache read-back gives (greedy parity with
            # the other paths depends on it).
            if is_quantized(cache["k"]):
                k_att, v_att = _roundtrip(k), _roundtrip(v)
            else:
                k_att, v_att = k, v
        else:
            width = kv_width
            if flash_offset is not None:
                frontier = flash_offset + t
                width = frontier if width is None else min(width, frontier)
            k_att = kv_read(kv_layer(cache["k"], layer_idx, width), x.dtype)
            v_att = kv_read(kv_layer(cache["v"], layer_idx, width), x.dtype)
            if flash_offset is not None:
                k_att, v_att = k_att.contiguous(), v_att.contiguous()
    else:
        k_att, v_att = k, v

    scale = dh ** -0.5
    with_state = prefix is not None
    if flash_offset is not None:
        attn_out = flash_attention(
            q, k_att, v_att, q_offset=flash_offset, scale=scale,
            sliding_window=cfg.sliding_window, logit_softcap=cfg.attn_logit_softcap,
        )
    elif decode_flash:
        attn_out = decode_attention(
            q, k_att, v_att, start_pos, layer_t, row_start, scale=scale,
            sliding_window=cfg.sliding_window, logit_softcap=cfg.attn_logit_softcap,
            kv_width=kv_width, w8a8=decode_w8a8, return_state=with_state,
        )
        if with_state:
            attn_out, m2, l2 = attn_out
            m2, l2 = m2[:, None], l2[:, None]  # [B, Hq] → [B, T=1, Hq]
    else:
        attn_out = attention(
            q, k_att, v_att, mask, scale=scale, logit_softcap=cfg.attn_logit_softcap,
            return_state=with_state,
        )
        if with_state:
            attn_out, m2, l2 = attn_out
    if with_state:
        # Shared-prefix merge: every flagged row attends the ONE prefix
        # copy, merged exactly with its own window's attention; rows not in
        # prefix_rows contribute (m = NEG_INF, l = 0) and pass through.
        pk = kv_read(kv_layer(prefix["k"], layer_idx), x.dtype)[0]  # [P, Hkv, dh]
        pv = kv_read(kv_layer(prefix["v"], layer_idx), x.dtype)[0]
        o1, m1, l1 = prefix_attention(
            q, pk, pv, prefix_len, prefix_rows, scale=scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        attn_out = merge_attention_states(o1, m1, l1, attn_out, m2, l2)
    return attn_out.reshape(b, t, hq * dh)


def _mlp(cfg: ModelConfig, x: torch.Tensor, lp: dict, mm, expert_offset: int = 0
         ) -> torch.Tensor:
    """The normed MLP (or MoE) block's output, no residual: the whole of it,
    or a shard's partial sum when ``lp`` holds a slice of the hidden dim or
    of the experts."""
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps, cfg.norm_offset)
    if cfg.is_moe:
        return moe_block(h, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                         top_k=cfg.experts_per_token, activation=cfg.activation, mm=mm,
                         expert_offset=expert_offset)
    return gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.activation, mm=mm)


def _layer(
    cfg: ModelConfig,
    x: torch.Tensor,          # [B, T, D]
    lp: dict,                 # this layer's params (leading L axis removed)
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    cache: Optional[dict],
    start_pos: Pos,
    layer_idx: int,
    layer_t: Optional[torch.Tensor],
    row_start: Optional[torch.Tensor],
    slots: Optional[torch.Tensor],
    flash_offset: Optional[int],
    kv_width: Optional[int],
    decode_flash: bool,
    mm,                       # qmatmul with the engine's W8A8 / int4 settings
    decode_w8a8: bool,
    prefix: Optional[dict],
    prefix_len,
    prefix_rows: Optional[torch.Tensor],
) -> torch.Tensor:
    attn_out = _attention(cfg, x, _project(cfg, x, lp, mm), cos, sin, mask, cache, start_pos,
                          layer_idx, layer_t, row_start, slots, flash_offset, kv_width,
                          decode_flash, decode_w8a8, prefix, prefix_len, prefix_rows)
    x = x + mm(attn_out, lp["wo"])
    return x + _mlp(cfg, x, lp, mm)


def layer_views(params: dict) -> list[dict]:
    """Per-layer views of the stacked layer params (no copies); an engine
    computes them once and hands them to :func:`forward`."""
    layers = params["layers"]

    def take(w, i):
        return {k: v[i] for k, v in w.items()} if is_quantized(w) else w[i]

    n = layers["attn_norm"].shape[0]
    return [{name: take(w, i) for name, w in layers.items()} for i in range(n)]


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # [B, T] int
    cache: Optional[dict] = None,     # init_kv_cache(...) or None; updated in place
    start_pos: Pos = 0,               # first absolute position (int, or device scalar)
    attn_impl: str = "torch",         # "flash" (kernels) | "torch" (plain op)
    kv_width: Optional[int] = None,   # attend only cache[:, :kv_width] (host int)
    logits_index: Optional[torch.Tensor] = None,  # [B]: unembed only this position
    layers: Optional[list] = None,    # layer_views(params), precomputed
    *,
    mm: Callable = qmatmul,           # the matmul, its quantization modes bound
    decode_w8a8: bool = False,        # int8 x int8 decode scores (int8 cache)
    row_start: Optional[torch.Tensor] = None,  # [B] int32: first real slot per row
    prefix: Optional[dict] = None,    # shared-prefix KV {"k", "v"} [L, 1, P, Hkv, dh]
    prefix_len=None,                  # int or int32 scalar: valid prefix slots
    prefix_rows: Optional[torch.Tensor] = None,  # [B] bool: rows attending prefix
    layer_scope: Optional[Callable] = None,  # a roofline capture's Capture.layer
    kv_mask: Optional[torch.Tensor] = None,  # [B, S] bool: written-slot bitmap
    remat: bool = False,              # recompute each layer in the backward (cache-less)
) -> tuple[torch.Tensor, Optional[dict]]:
    """Run the model. Returns (logits [B, T, V] fp32, cache).

    Without a cache this is a plain forward over ``tokens``. With a cache it
    serves prefill (T = prompt chunk) and decode (T = 1): keys/values are
    written at ``start_pos`` and attention spans the cache with unwritten
    slots masked. ``attn_impl="flash"`` routes a one-shot prefill at an int
    ``start_pos`` through the flash kernel and T = 1 steps through the
    decode kernel where the gates admit the shape; ``"torch"`` (the JAX
    package's ``"xla"``) always takes the plain attention op. ``mm`` (e.g.
    ``partial(qmatmul, w8a8=True)``) and ``decode_w8a8`` are the engine's
    quantization settings (the JAX package threads them through a
    trace-time scope and its knobs).

    ``row_start`` (the continuous batcher's right-aligned rows) makes
    positions row-relative: row ``b``'s slot ``j`` holds position
    ``j - row_start[b]``, and slots below ``row_start[b]`` are masked (on
    CUDA the decode kernel takes it as an int32 device vector). ``prefix``
    with ``prefix_len`` merges attention over a shared-prefix KV into every
    row flagged in ``prefix_rows`` (all rows when None); those rows' own
    slots hold positions ``prefix_len`` further on. Neither composes with
    the flash prefill kernel, and ``prefix`` refuses a sliding window.
    ``kv_mask`` (the batched speculative pool's written-slot bitmap) is the
    whole per-(row, slot) validity: it replaces the ``row_start`` interval
    clamp, so rejected slots behind the frontier stay masked while valid
    slots below ``row_start`` (which absorbs hole counts) stay visible;
    positions are still measured from the current ``row_start``. It needs
    a cache and ``row_start``, refuses a sliding window (old slots' positions
    underestimate their write-time ones, harmless only for full attention)
    and never reaches a kernel. ``layer_scope(i)`` is entered around layer ``i`` when given (a roofline
    capture counts the first layer only, obs/roofline.py).

    The cache-less forward is the training forward (train/, flywheel/): it
    writes nothing in place and takes the plain attention op, so autograd
    runs through it. ``remat`` (the JAX package's per-layer
    ``jax.checkpoint``) runs each layer under ``torch.utils.checkpoint``:
    its activations are recomputed in the backward instead of kept.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if row_start is not None and cache is None:
        raise ValueError(
            "row_start (left-padded batching) requires a cache: the "
            "no-cache mask path has no kv_valid to exclude pad slots"
        )
    if prefix is not None:
        if cache is None:
            raise ValueError("a shared prefix requires a cache")
        if cfg.sliding_window is not None:
            raise ValueError("shared-prefix attention does not compose "
                             "with sliding_window")
        if prefix_len is None:
            raise ValueError("prefix requires prefix_len")
    if remat and cache is not None:
        raise ValueError("remat is the cache-less (training) forward's")
    if kv_mask is not None:
        if cache is None or row_start is None:
            raise ValueError("kv_mask requires a cache and row_start")
        if cfg.sliding_window is not None:
            raise ValueError("kv_mask (speculative holes) does not "
                             "compose with sliding_window")
    b, t = tokens.shape
    dev = tokens.device
    x = embed_tokens(params, cfg, tokens)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    flash_offset = (
        int(start_pos)
        if (
            attn_impl == "flash"
            and cache is not None
            and isinstance(start_pos, int)
            and row_start is None  # the kernel assumes one shared offset
            and prefix is None     # the prefill kernel has no merge-state form
            and kv_mask is None    # the kernels derive validity from positions alone
            and flash_supported(t, hq, hkv, dh)
        )
        else None
    )
    # T = 1 decode steps take the decode kernel over the full stack.
    decode_flash = (
        attn_impl == "flash"
        and cache is not None
        and t == 1
        and flash_offset is None
        and kv_mask is None  # the decode kernel has no bitmap form
        and decode_supported(hq, hkv, dh)
    )

    steps = torch.arange(t, dtype=torch.int32, device=dev)
    positions = (steps + start_pos)[None, :].expand(b, t)
    if row_start is not None:
        positions = positions - row_start.to(device=dev, dtype=torch.int32)[:, None]
    pos_offset = None
    if prefix is not None:
        # Suffix-resident rows: slot j holds ABSOLUTE position prefix_len +
        # (j - row_start); rows outside prefix_rows carry their whole prompt
        # in their own window and keep their positions.
        if prefix_rows is not None:
            pos_offset = prefix_len * prefix_rows.to(device=dev, dtype=torch.int32)
        else:
            pos_offset = torch.zeros(b, dtype=torch.int32, device=dev) + prefix_len
        positions = positions + pos_offset[:, None]
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_dict, device=dev)
    cos, sin = rope_angles(positions, inv_freq)
    slots = None if isinstance(start_pos, int) else (steps + start_pos).long()

    if flash_offset is not None or decode_flash:
        mask = None  # the kernels derive causality from pos / q_offset
    elif cache is not None:
        s = kv_capacity(cache["k"])
        if kv_width is not None:
            s = min(s, kv_width)
        kv_slots = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        kv_valid = kv_slots < (start_pos + t)
        kv_positions = kv_slots
        if row_start is not None:
            rs = row_start.to(device=dev, dtype=torch.int32)[:, None]
            kv_positions = kv_slots - rs
            if kv_mask is not None:
                # The bitmap replaces the interval clamp: slots it clears
                # are junk even below the frontier. This call's own write
                # window is marked valid by the caller before dispatch.
                kv_valid = kv_valid & kv_mask[:, :s].to(dev)
            else:
                kv_valid = kv_valid & (kv_slots >= rs)
        if pos_offset is not None:
            # The causal compare in the basis the query positions moved to.
            kv_positions = kv_positions + pos_offset[:, None]
        mask = make_attention_mask(positions, kv_positions, kv_valid, cfg.sliding_window)
    else:
        mask = make_attention_mask(positions, positions, None, cfg.sliding_window)

    layer_ids = None
    if decode_flash:
        # Device scalars for the decode kernel: the position, each layer's
        # index, and the rows' starts (a single stream's zeros, as the JAX
        # package passes). A host int becomes a device fill, not a copy.
        if isinstance(start_pos, int):
            start_pos = torch.full((), start_pos, dtype=torch.int32, device=dev)
            slots = (steps + start_pos).long()  # the cache write follows it
        else:
            start_pos = start_pos.to(device=dev, dtype=torch.int32)
        layer_ids = torch.arange(cfg.n_layers, dtype=torch.int32, device=dev)
        if row_start is None:
            row_start = torch.zeros(b, dtype=torch.int32, device=dev)
        else:
            row_start = row_start.to(device=dev, dtype=torch.int32).contiguous()
    if layers is None:
        layers = layer_views(params)
    decode_w8a8 = decode_w8a8 and decode_flash and is_quantized(cache["k"])
    for i, lp in enumerate(layers):
        with layer_scope(i) if layer_scope is not None else _NO_SCOPE:
            args = (cfg, x, lp, cos, sin, mask, cache, start_pos, i,
                    layer_ids[i] if layer_ids is not None else None, row_start, slots,
                    flash_offset, kv_width, decode_flash, mm, decode_w8a8,
                    prefix, prefix_len, prefix_rows)
            if remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(_layer, *args, use_reentrant=False)
            else:
                x = _layer(*args)

    if logits_index is not None:
        # Prefill samples one position: unembed only it.
        idx = logits_index.to(device=dev, dtype=torch.long)
        x = x.gather(1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    return unembed(params, cfg, x, mm), cache


# -- tensor, expert and sequence parallelism -------------------------------------


class ShardGroup:
    """One replica's tensor- and expert-parallel group of a sharded model:
    the mesh positions at fixed indices of the other axes (``replica``,
    e.g. ``{"dp": 0, "sp": 1}``), with the weight shard each holds
    (parallel/sharding.py ``shard_pytree``), as :func:`forward_sharded`
    runs them. It is JAX's GSPMD program made explicit: every shard's
    compute is issued on its own device and the partial sums are reduced
    here (parallel/sharding.py ``reduce_sum``, ``gather``).

    Attention: when ``tp`` divides both head counts each tp position runs
    its own head slice (the projections by column, the output projection
    by row, its own contiguous cache of Hkv / tp heads, its own kernel
    launch: JAX's ``shard_map`` round the kernels). Otherwise the
    projections follow their specs (a column split may cut through a head)
    and are gathered, and attention runs once, on the group's first
    device, over one replicated cache with the plain op: the reference's
    routing for a non-dividing degree (its ``qkv_pin`` pins the heads
    replicated before rope and the cache write, because GSPMD carrying a
    within-head split through them miscompiled on jax 0.4). The kernels
    run only on meshes whose every axis but ``tp`` has size 1, the JAX
    gate; elsewhere attention takes the plain op on each shard.

    MLP: the hidden dim splits by column and row over ``tp`` and the
    partials sum; MoE experts split over ``ep`` (or ``tp``), their hidden
    dim over ``tp`` too when both axes exist, the router whole on every
    shard. The vocabulary splits over ``tp``: the lookup is masked per shard
    and summed, the logits gathered.
    """

    def __init__(self, cfg: ModelConfig, mesh, shards: list, specs: dict,
                 replica: Optional[dict] = None):
        self.cfg, self.mesh = cfg, mesh
        self.replica = dict(replica or {})
        self.tp = mesh.shape.get("tp", 1)
        lspec = specs["layers"]

        def positions(*spec_entries) -> list:
            """Flat indices over the axes the specs split (others at the
            replica's index, or 0)."""
            axes = [a for a in ("ep", "tp") if any(
                a == e or (isinstance(e, tuple) and a in e)
                for spec in spec_entries for e in spec)]
            out = [dict(self.replica)]
            for a in axes:
                out = [{**c, a: i} for c in out for i in range(mesh.shape[a])]
            return [mesh.flat_index(**c) for c in out]

        self.root_pos = mesh.flat_index(**self.replica)
        self.heads = cfg.n_heads % self.tp == 0 and cfg.n_kv_heads % self.tp == 0
        self.lcfg = (replace(cfg, n_heads=cfg.n_heads // self.tp,
                             n_kv_heads=cfg.n_kv_heads // self.tp) if self.heads else cfg)
        self.q_pos = positions(lspec["wq"])
        self.kv_pos = positions(lspec["wk"])
        self.o_pos = positions(lspec["wo"])
        self.attn_pos = self.q_pos if self.heads else [self.root_pos]
        self.mlp_pos = positions(lspec["w_gate"], lspec["w_down"])
        self.vocab_pos = positions(specs["embed"])
        self.head_pos = positions(specs.get("lm_head", specs["embed"]))
        used = {self.root_pos, *self.q_pos, *self.kv_pos, *self.o_pos, *self.mlp_pos,
                *self.vocab_pos, *self.head_pos}
        self.params = {p: shards[p] for p in used}
        self.layers = {p: layer_views(shards[p]) for p in used}
        self.devs = {p: mesh.devices.flat[p].torch_device for p in used}
        self.root = self.devs[self.root_pos]
        # Each MLP position's first expert (its ep coordinate times the experts
        # a shard holds; 0 when the experts are whole).
        self.expert_offset = {}
        ep_entry = lspec["w_gate"][1] if cfg.is_moe else None
        if ep_entry is not None:
            per = cfg.n_experts // mesh.shape[ep_entry]
            self.expert_offset = {p: mesh.coords(p)[ep_entry] * per for p in self.mlp_pos}
        others = {a: n for a, n in mesh.shape.items() if a != "tp"}
        self.kernels = self.heads and all(n == 1 for n in others.values())

    def new_caches(self, batch: int, max_seq: int, dtype: torch.dtype,
                   quant: Optional[str]) -> list:
        """The group's KV caches: one contiguous cache of its heads per
        attention position, or one whole cache on the first device."""
        return [init_kv_cache(self.lcfg, batch, max_seq, device=self.devs[p], dtype=dtype,
                              quant=quant) for p in self.attn_pos]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings [B, T, D] on the first device."""
        cfg = self.cfg
        if len(self.vocab_pos) == 1:
            x = self.params[self.vocab_pos[0]]["embed"][tokens.to(self.root)]
        else:
            parts = []
            for j, p in enumerate(self.vocab_pos):
                table = self.params[p]["embed"]
                n = table.shape[0]
                local = tokens.to(self.devs[p]) - j * n
                ok = (local >= 0) & (local < n)
                parts.append(table[local.clamp(0, n - 1)] * ok[..., None].to(table.dtype))
            x = reduce_sum(parts, self.root)
        if cfg.embed_scale:
            x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        return x

    def unembed(self, x: torch.Tensor, mm) -> torch.Tensor:
        """Final norm + LM head → fp32 logits [B, T, V] on the first device."""
        cfg = self.cfg
        parts = []
        for p in self.head_pos:
            params = self.params[p]
            h = rms_norm(x.to(self.devs[p]), params["final_norm"], cfg.rms_eps, cfg.norm_offset)
            head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
            parts.append(mm(h, head, torch.float32))
        logits = gather(parts, -1, self.root)
        if cfg.final_logit_softcap is not None:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def project(self, x: torch.Tensor, i: int, mm) -> dict:
        """Layer ``i``'s q/k/v: per attention position (its heads) when the
        heads split, else gathered whole on the first device."""
        if self.heads:
            return {p: _project(self.cfg, x.to(self.devs[p]), self.layers[p][i], mm)
                    for p in self.attn_pos}
        cfg = self.cfg
        names = (("wq", "bq", self.q_pos), ("wk", "bk", self.kv_pos), ("wv", "bv", self.kv_pos))
        normed = {}
        out = []
        for w, b, pos in names:
            parts = []
            for p in pos:
                if p not in normed:
                    lp = self.layers[p][i]
                    normed[p] = rms_norm(x.to(self.devs[p]), lp["attn_norm"], cfg.rms_eps,
                                         cfg.norm_offset)
                y = mm(normed[p], self.layers[p][i][w])
                if cfg.qkv_bias:
                    y = y + self.layers[p][i][b]
                parts.append(y)
            out.append(gather(parts, -1, self.root))
        return {self.root_pos: tuple(out)}

    def out_proj(self, attn: dict, i: int, mm) -> torch.Tensor:
        """The output projection's sum over the group, on the first device:
        ``attn`` maps each attention position to its [B, T, H * dh]."""
        if self.heads:
            return reduce_sum([mm(a, self.layers[p][i]["wo"]) for p, a in attn.items()],
                              self.root)
        a = attn[self.root_pos]
        chunks = a.chunk(len(self.o_pos), dim=-1)
        return reduce_sum([mm(c.to(self.devs[p]), self.layers[p][i]["wo"])
                           for c, p in zip(chunks, self.o_pos)], self.root)

    def mlp(self, x: torch.Tensor, i: int, mm) -> torch.Tensor:
        return reduce_sum([_mlp(self.cfg, x.to(self.devs[p]), self.layers[p][i], mm,
                                self.expert_offset.get(p, 0)) for p in self.mlp_pos],
                          self.root)


def _on(t: Optional[torch.Tensor], dev: torch.device, memo: dict):
    """``t`` on ``dev``, one copy per device per call."""
    if t is None:
        return None
    key = (id(t), dev)
    if key not in memo:
        memo[key] = t.to(dev)
    return memo[key]


def forward_sharded(
    group: ShardGroup,
    tokens: torch.Tensor,             # [B, T] int
    caches: Optional[list] = None,    # group.new_caches(...) or None; updated in place
    start_pos: Pos = 0,
    attn_impl: str = "torch",
    kv_width: Optional[int] = None,
    logits_index: Optional[torch.Tensor] = None,
    *,
    mm: Callable = qmatmul,
    decode_w8a8: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """:func:`forward` over a :class:`ShardGroup`: fp32 logits [B, T, V] on
    the group's first device, the same numbers as the unsharded forward up
    to the order of the partial sums. Single-stream forms only (a cache
    with a shared start, or none): the batcher's ``row_start``, shared
    prefix and bitmap forms over a sharded model are not ported. Routing
    as in :func:`forward`, the kernels each on its shard's heads where
    :class:`ShardGroup` says they run."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if remat and caches is not None:
        raise ValueError("remat is the cache-less (training) forward's")
    cfg, lcfg, root = group.cfg, group.lcfg, group.root
    b, t = tokens.shape
    tokens = tokens.to(root)
    x = group.embed(tokens)
    hq, hkv, dh = lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim
    cache = caches[0] if caches is not None else None
    flash_offset = (
        int(start_pos)
        if (attn_impl == "flash" and cache is not None and isinstance(start_pos, int)
            and group.kernels and flash_supported(t, hq, hkv, dh))
        else None
    )
    decode_flash = (attn_impl == "flash" and cache is not None and t == 1
                    and flash_offset is None and group.kernels
                    and decode_supported(hq, hkv, dh))

    steps = torch.arange(t, dtype=torch.int32, device=root)
    positions = (steps + (start_pos.to(root) if torch.is_tensor(start_pos) else start_pos)
                 )[None, :].expand(b, t)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_dict, device=root)
    cos, sin = rope_angles(positions, inv_freq)
    slots = None if isinstance(start_pos, int) else (steps + start_pos.to(root)).long()
    if flash_offset is not None or decode_flash:
        mask = None
    elif cache is not None:
        s = kv_capacity(cache["k"])
        if kv_width is not None:
            s = min(s, kv_width)
        kv_slots = torch.arange(s, dtype=torch.int32, device=root)[None, :].expand(b, s)
        start = start_pos.to(root) if torch.is_tensor(start_pos) else start_pos
        mask = make_attention_mask(positions, kv_slots, kv_slots < (start + t),
                                   cfg.sliding_window)
    else:
        mask = make_attention_mask(positions, positions, None, cfg.sliding_window)
    layer_ids = row_start = None
    if decode_flash:
        if isinstance(start_pos, int):
            start_pos = torch.full((), start_pos, dtype=torch.int32, device=root)
            slots = (steps + start_pos).long()
        else:
            start_pos = start_pos.to(device=root, dtype=torch.int32)
        layer_ids = torch.arange(cfg.n_layers, dtype=torch.int32, device=root)
        row_start = torch.zeros(b, dtype=torch.int32, device=root)
    decode_w8a8 = decode_w8a8 and decode_flash and is_quantized(cache["k"])
    memo: dict = {}

    def layer(x, i):
        qkv = group.project(x, i, mm)
        attn = {}
        for j, p in enumerate(group.attn_pos):
            d = group.devs[p]
            attn[p] = _attention(
                lcfg, x.to(d), qkv[p], _on(cos, d, memo),
                _on(sin, d, memo), _on(mask, d, memo),
                caches[j] if caches is not None else None,
                _on(start_pos, d, memo) if torch.is_tensor(start_pos) else start_pos, i,
                layer_ids[i].to(d) if layer_ids is not None else None,
                _on(row_start, d, memo), _on(slots, d, memo), flash_offset, kv_width,
                decode_flash, decode_w8a8)
        x = x + group.out_proj(attn, i, mm)
        return x + group.mlp(x, i, mm)

    for i in range(cfg.n_layers):
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(layer, x, i, use_reentrant=False)
        else:
            x = layer(x, i)
    if logits_index is not None:
        idx = logits_index.to(device=root, dtype=torch.long)
        x = x.gather(1, idx[:, None, None].expand(b, 1, x.shape[-1]))
    return group.unembed(x, mm)


def forward_ring_prefill(
    groups: list,                     # one ShardGroup per sp position, in sp order
    tokens: torch.Tensor,             # [B, T], T divisible by len(groups)
    caches: list,                     # groups[0].new_caches(...); written at [0, T)
    logits_index: Optional[torch.Tensor] = None,
    *,
    mm: Callable = qmatmul,
) -> torch.Tensor:
    """Sequence-parallel one-shot prefill from position 0 (the JAX
    ``_forward_ring_prefill``): the prompt's activations split over the
    ``sp`` positions, each holding one block of T / sp tokens on its
    devices, attention by ring attention (parallel/ring.py) per head shard
    (heads over ``tp`` when it divides them, else whole on each sp
    position), and every block's K/V written into the first group's
    caches, where the whole sequence assembles for decode. Returns fp32
    logits [B, 1 or T, V] on the first group's device."""
    from llm_consensus_tpu_torch.parallel.ring import ring_attention_blocks

    g0 = groups[0]
    cfg, lcfg = g0.cfg, g0.lcfg
    n = len(groups)
    b, t = tokens.shape
    if t % n:
        raise ValueError(f"ring prefill: {t} tokens do not split over sp={n}")
    tb = t // n
    hq, hkv, dh = lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim
    x_all = g0.embed(tokens)
    positions = torch.arange(t, dtype=torch.int32, device=g0.root)[None, :].expand(b, t)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_dict,
                             device=g0.root)
    cos, sin = rope_angles(positions, inv_freq)

    def block(a, s, dev):
        return a[:, s * tb:(s + 1) * tb].to(dev)

    xs = [block(x_all, s, g.root) for s, g in enumerate(groups)]
    for i in range(cfg.n_layers):
        qkv = [g.project(xs[s], i, mm) for s, g in enumerate(groups)]
        attn = [dict() for _ in groups]
        for j, p0 in enumerate(g0.attn_pos):
            qs, ks, vs, pos = [], [], [], []
            for s, g in enumerate(groups):
                p = g.attn_pos[j]
                d = g.devs[p]
                q, k, v = qkv[s][p]
                c, sn = block(cos, s, d), block(sin, s, d)
                qs.append(apply_rope(q.reshape(b, tb, hq, dh), c, sn))
                ks.append(apply_rope(k.reshape(b, tb, hkv, dh), c, sn))
                vs.append(v.reshape(b, tb, hkv, dh))
                pos.append(block(positions, s, d))
            outs = ring_attention_blocks(qs, ks, vs, pos, dh ** -0.5, cfg.sliding_window,
                                         cfg.attn_logit_softcap)
            cdev = g0.devs[p0]
            for s, g in enumerate(groups):
                attn[s][g.attn_pos[j]] = outs[s].reshape(b, tb, hq * dh)
                kv_write_rows(caches[j]["k"], ks[s].to(cdev), i, s * tb)
                kv_write_rows(caches[j]["v"], vs[s].to(cdev), i, s * tb)
        for s, g in enumerate(groups):
            xs[s] = xs[s] + g.out_proj(attn[s], i, mm)
            xs[s] = xs[s] + g.mlp(xs[s], i, mm)
    if logits_index is None:
        return g0.unembed(gather(xs, 1, g0.root), mm)
    idx = int(logits_index.reshape(-1)[0]) if b == 1 else None
    if idx is None:
        x = gather(xs, 1, g0.root)
        li = logits_index.to(device=g0.root, dtype=torch.long)
        return g0.unembed(x.gather(1, li[:, None, None].expand(b, 1, x.shape[-1])), mm)
    s, local = divmod(idx, tb)
    return groups[s].unembed(xs[s][:, local:local + 1], mm).to(g0.root)
