"""Weight and KV-cache quantization (port of ``llm_consensus_tpu/ops/quant.py``).

int8 weights: for a weight laid out ``[..., contract, out]`` (every matmul
weight of the dense transformer: the attention projections, the MLP and the
LM head), ``scale = max|w| * float32(1/127)`` per output channel (reduced
over the contraction axis), ``q8 = round(w / scale)`` against the float32
scale; the scale is stored in the weight's dtype. Every scale here is
``max * float32(1/N)`` in float32 because that is what the JAX package
computes under ``jit``, where XLA turns its ``max / N`` into that multiply:
the engine's quantized weights, KV rows and activations then carry the same
codes and scales in both packages. :func:`qmatmul` runs the product on
the codes converted to the activation dtype and multiplies the *output* by
the scale (exact: the scale is constant along the contraction). On the card
that convert materializes a bf16 copy of the weight per call (eager PyTorch
has no fused convert-into-GEMM): the port's int8-weight matmul is plain, not
a kernel, and is expected to be no faster than bf16 until a fused int8
GEMV exists.

int4 weights: two offset-binary codes per byte (``u = round(w / s) + 8``),
group-wise scales along the contraction (group 128); the first and second
half of each group pack into the low and high nibbles. Few rows (decode)
take the nibble dot, which repairs offset and scale on the output; more rows
(prefill) dequantize into the matmul.

W8A8 (int8 weights only): activations quantize per row and the product runs
int8 x int8 with int32 accumulation (``torch._int_mm`` on the card, an
int32 matmul on the CPU; a float32 sum of thousands of products up to
127 * 127 would not be exact).

Every mode also takes the mixture-of-experts form ``[E, C, K] @ [E, K, N]``
(stacked expert weights, scales ``[E, 1, N]``; the JAX package's
``qeinsum("ecd,edf->ecf")``): a batched matmul, one int8 x int8 product
per expert for W8A8, and the int4 nibble dot with the experts in front.

int8 KV cache: ``{"q8": int8 [L, B, S, Hkv, dh], "s": [L, B, Hkv, S]}``
with one scale per written row (over ``dh``), stored seq-minor in the cache
dtype, the layout the decode kernel reads.

Mode names are resolved once by :func:`resolve_mode`; nothing here reads the
environment.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Weight names eligible for quantization (init_params layout, all
# [..., contract, out]).
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})
WEIGHT_MODES = ("int8", "int4")
KV_MODES = ("int8",)
INT4_IMPLS = ("auto", "nibble")  # int4 matmul lowering (LLMC_INT4_IMPL)
INT4_GROUP = 128  # contraction-axis group size of the int4 scales
_TINY = torch.finfo(torch.float32).tiny
# float32(1/127) and float32(1/7), as Python floats: a float32 amax times
# either rounds once, as XLA's rewritten division does.
_INV127 = torch.tensor(1 / 127, dtype=torch.float32).item()
_INV7 = torch.tensor(1 / 7, dtype=torch.float32).item()

# Row bound of the int4 nibble-dot lowering (decode); above it the weight
# is dequantized into the matmul.
_NIBBLE_DOT_MAX_ROWS = 16


def resolve_mode(value: Optional[str], name: str, allowed: tuple) -> Optional[str]:
    """A quantization mode as the engine takes it: ``None``, ``""``,
    ``"bf16"`` and ``"none"`` mean off; anything outside ``allowed`` raises
    ``ValueError`` (before any parameter is built)."""
    if value in (None, "", "bf16", "none"):
        return None
    if value not in allowed:
        raise ValueError(f"unknown {name} mode {value!r} (expected one of {allowed})")
    return value


def resolve_int4_impl(value: Optional[str]) -> str:
    """The int4 matmul lowering: unset or empty is ``"auto"`` (the nibble
    dot up to 16 rows), ``"nibble"`` takes it at any row count; anything
    else raises ``ValueError``."""
    value = value or "auto"
    if value not in INT4_IMPLS:
        raise ValueError(f"unknown int4_impl {value!r} (expected one of {INT4_IMPLS})")
    return value


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


# -- weights -------------------------------------------------------------------


def _quantize(w: torch.Tensor, amax: Optional[torch.Tensor] = None) -> dict:
    """[..., C, O] → {"q8": int8 [..., C, O], "s": [..., 1, O] in w's dtype}.
    ``amax`` ([..., 1, O]) replaces w's own column maxima: a block of a
    weight's rows quantizes with the whole weight's scales."""
    if amax is None:
        amax = w.abs().amax(dim=-2, keepdim=True)
    scale = (amax.float() * _INV127).clamp_min(_TINY)
    q8 = torch.round(w.float() / scale).clamp_(-127, 127)
    return {"q8": q8.to(torch.int8), "s": scale.to(w.dtype)}


def _quantize4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """[..., C, O] → {"q4": uint8 [..., G, g/2, O], "s": [..., G, 1, O]};
    byte = (q_lo + 8) | ((q_hi + 8) << 4), q in [-7, 7]. One group (a
    per-channel scale) when C does not divide by ``group``."""
    *lead, c, o = w.shape
    if c % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {c}")
    g = group if (group and group % 2 == 0 and c % group == 0) else c
    wg = w.float().reshape(*lead, c // g, g, o)
    scale = (wg.abs().amax(dim=-2, keepdim=True) * _INV7).clamp_min(_TINY)
    u = (torch.round(wg / scale).clamp_(-7, 7) + 8).to(torch.uint8)
    lo, hi = u[..., : g // 2, :], u[..., g // 2:, :]
    return {"q4": lo | (hi << 4), "s": scale.to(w.dtype)}


def _unpack4(w: dict, dtype: torch.dtype) -> torch.Tensor:
    """The scaled weight [..., C, O] in ``dtype`` from an int4 dict."""
    p = w["q4"]
    lo = (p & 0xF).to(dtype)
    hi = (p >> 4).to(dtype)
    q = (torch.cat([lo, hi], dim=-2) - 8.0) * w["s"].to(dtype)
    *lead, groups, g, o = q.shape
    return q.reshape(*lead, groups * g, o)


def _fill(n: int, make: Callable[[int], torch.Tensor], fn) -> dict:
    """``fn(make(i))`` (a dict of tensors) for i < n, each copied into
    outputs with a new leading axis of n, allocated at the first slice:
    only one slice's temporaries exist at a time."""
    out = None
    for i in range(n):
        part = fn(make(i))
        if out is None:
            out = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
                   for k, v in part.items()}
        for k, v in part.items():
            out[k][i].copy_(v)
        del part
    return out


def quantize_weight(w: torch.Tensor, mode: str = "int8") -> dict:
    """Quantize one weight. A stacked leaf ([L, C, O], or the experts'
    [L, E, C, O]) quantizes one [C, O] slice at a time into preallocated
    outputs (the scales reduce over C only, so this is exact), keeping the
    float temporaries one slice in size."""
    fn = _quantize4 if mode == "int4" else _quantize
    if w.dim() <= 2:
        return fn(w)
    flat = w.reshape(-1, *w.shape[-2:])
    out = _fill(flat.shape[0], flat.__getitem__, fn)
    return {k: v.reshape(*w.shape[:-2], *v.shape[1:]) for k, v in out.items()}


def stack_layers(n: int, make: Callable[[int], torch.Tensor], mode: Optional[str] = None):
    """The tensors ``make(0) .. make(n - 1)`` stacked on a new axis 0, made
    one at a time in that order; with ``mode`` ("int8" | "int4") each is
    quantized as it is made, so the full-precision stack never exists."""
    if mode is None:
        return _fill(n, make, lambda w: {"": w})[""]
    return _fill(n, make, lambda w: quantize_weight(w, mode))


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """A new tree with every eligible matmul weight quantized (already
    quantized leaves pass through). A source leaf is freed as soon as
    nothing else holds it: the caller keeps the old tree alive or not."""
    out = dict(params)
    if "lm_head" in out and not is_quantized(out["lm_head"]):
        out["lm_head"] = quantize_weight(out["lm_head"], mode)
    layers = dict(out["layers"])
    for name in list(layers):
        if name in QUANT_KEYS and not is_quantized(layers[name]):
            layers[name] = quantize_weight(layers[name], mode)
    out["layers"] = layers
    return out


# -- matmuls -------------------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """[..., K] @ [K, N]. ``out_dtype=float32``: fp32 output, which on the
    card takes bf16 inputs and lands the fp32 accumulator (the JAX
    package's ``preferred_element_type=float32``); float32 inputs stay
    float32."""
    if out_dtype != torch.float32 or x.dtype == torch.float32:
        y = torch.matmul(x, w)
        return y if out_dtype is None else y.to(out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*lead, w.shape[-1])


def quantize_rows_sym(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis → (int8 codes, float32
    scale [..., 1]); scale floor 1e-30. The one convention shared by the
    W8A8 matmul and the decode kernel's q quantization."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) * _INV127).clamp_min(1e-30)
    q = torch.round(xf / s).clamp_(-127, 127).to(torch.int8)
    return q, s


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] → int32 [M, N], exact. On the card
    ``torch._int_mm``, which wants M > 16 and K, N multiples of 8: the
    rows are zero-padded up to a multiple of 8 of at least 24."""
    if not a.is_cuda:
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise ValueError(f"int8 matmul needs K, N multiples of 8, got {k}, {b.shape[1]}")
    m_pad = max(24, -(-m // 8) * 8)
    if m_pad != m:
        a = torch.cat([a, a.new_zeros(m_pad - m, k)])
    return torch._int_mm(a, b)[:m]


def _w8a8_matmul(x: torch.Tensor, w: dict, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """int8 activations (per row) x int8 weights, int32 accumulation; the
    row scale and the channel scale apply to the output. The expert form
    ([E, C, K] @ [E, K, N]) runs one int8 product per expert (the card's
    ``torch._int_mm`` is 2-D only); empty expert slots are zero rows."""
    xq, xs = quantize_rows_sym(x)
    if w["q8"].dim() == 3:  # [E, K, N]
        y = torch.stack([_int8_mm(xq[e], w["q8"][e]) for e in range(w["q8"].shape[0])])
    else:
        lead = x.shape[:-1]
        y = _int8_mm(xq.reshape(-1, x.shape[-1]), w["q8"]).reshape(*lead, -1)
    y = y.float() * xs
    y = y * w["s"].float()
    return y.to(out_dtype or x.dtype)


def _int4_nibble_matmul(x: torch.Tensor, w: dict,
                        out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Decode lowering of the int4 matmul: dot on the raw unsigned nibbles,
    offset and scale repaired on the output,
    ``y = sum_G s[G,o] (x_lo.lo_u + x_hi.hi_u - 8 sum(x_G))``, exact
    because the zero point and the scale are constant within a group.
    Codes [G, g/2, O] take x [..., K]; the experts' [E, G, g/2, O] take
    x [E, C, K], each expert's groups one batch of the product."""
    p, s = w["q4"], w["s"]
    *experts, groups, half, o = p.shape
    e = experts[0] if experts else 1
    lo = (p & 0xF).to(x.dtype).reshape(e * groups, half, o)
    hi = (p >> 4).to(x.dtype).reshape(e * groups, half, o)
    lead = x.shape[:-1]
    xg = x.reshape(e, -1, groups, 2 * half).transpose(1, 2)  # [E, G, R, g]
    xg = xg.reshape(e * groups, -1, 2 * half)
    yg = (
        _bmm_f32(xg[..., :half], lo) + _bmm_f32(xg[..., half:], hi)
        - 8.0 * xg.float().sum(dim=-1, keepdim=True)
    ).reshape(e, groups, -1, o)  # [E, G, R, O]
    y = (yg * s[..., 0, :].float().reshape(e, groups, 1, o)).sum(dim=1)
    return y.reshape(*lead, o).to(out_dtype or x.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with a float32 result (fp32 accumulation of bf16
    inputs on the card)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def qmatmul(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None, *,
            w8a8: bool = False, int4_nibble: bool = False) -> torch.Tensor:
    """``x @ w`` for a weight that may be quantized (the JAX package's
    ``qeinsum``): ``[..., K] @ [K, N]``, the layout every dense weight
    has, or the experts' batched ``[E, C, K] @ [E, K, N]`` (a batched
    matmul; its scales are [E, 1, N]). The output is ``out_dtype``
    (default: x's dtype).

    int8: the product on the codes in x's dtype, then times the
    per-channel scale; ``w8a8`` takes the int8 x int8 product instead.
    int4: the nibble dot for at most 16 rows (all of x's leading dims,
    E·C for the experts, as the JAX package counts them), or at any row
    count with ``int4_nibble`` (``int4_impl="nibble"``), else the
    dequantized weight.
    """
    if not is_quantized(w):
        return _mm(x, w, out_dtype)
    if "q4" in w:
        rows = x.numel() // x.shape[-1]
        if int4_nibble or rows <= _NIBBLE_DOT_MAX_ROWS:
            return _int4_nibble_matmul(x, w, out_dtype)
        return _mm(x, _unpack4(w, x.dtype), out_dtype)
    if w8a8:
        return _w8a8_matmul(x, w, out_dtype)
    y = _mm(x, w["q8"].to(x.dtype), out_dtype)
    return y * w["s"].to(y.dtype)


# -- KV cache --------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., dh] → (int8 codes, per-row scale [..., 1] in x's dtype)."""
    scale = (x.abs().amax(dim=-1, keepdim=True).float() * _INV127).clamp_min(_TINY)
    q8 = torch.round(x.float() / scale).clamp_(-127, 127)
    return q8.to(torch.int8), scale.to(x.dtype)


def kv_seq_axis(leaf: torch.Tensor) -> int:
    """Seq axis of a stacked-cache leaf: 2 for the 5-D [L, B, S, H, dh]
    code or bf16 stacks, 3 for the 4-D seq-minor [L, B, H, S] scales."""
    return 2 if leaf.dim() == 5 else 3


def kv_capacity(stack) -> int:
    """Slots of a stacked cache leaf (bf16 stack or int8 dict)."""
    leaf = stack["q8"] if is_quantized(stack) else stack
    return leaf.shape[kv_seq_axis(leaf)]


def kv_write_rows(full, x: torch.Tensor, layer: int, start,
                  slots: Optional[torch.Tensor] = None) -> None:
    """Write ``x`` [B, T, H, dh] into the stacked cache ``full`` at
    (layer, start), in place (the JAX package updates functionally and lets
    XLA alias the donated buffer). A host ``start`` takes a slice copy; a
    device start (decode) an ``index_copy_`` at ``slots`` =
    start + arange(T). int8 caches quantize the rows on the way in."""
    t = x.shape[1]
    if not is_quantized(full):
        entry = full[layer]
        if slots is None:
            entry[:, start:start + t].copy_(x)
        else:
            entry.index_copy_(1, slots, x.to(full.dtype))
        return
    q8, s = quantize_kv(x)
    s_rows = s[..., 0].transpose(1, 2).to(full["s"].dtype)  # [B, H, T], seq minor
    codes, scales = full["q8"][layer], full["s"][layer]
    if slots is None:
        codes[:, start:start + t].copy_(q8)
        scales[:, :, start:start + t].copy_(s_rows)
    else:
        codes.index_copy_(1, slots, q8)
        scales.index_copy_(2, slots, s_rows)


def kv_layer(full, layer: int, width: Optional[int] = None):
    """One layer's entry [B, S(<=width), H, dh] of the stacked cache, as
    views (int8 scales come out [B, H, S<=width], their storage layout)."""
    if not is_quantized(full):
        return full[layer, :, :width]
    return {"q8": full["q8"][layer, :, :width], "s": full["s"][layer, :, :, :width]}


def kv_read(entry, dtype: torch.dtype) -> torch.Tensor:
    """A cache entry in ``dtype`` (int8 entries dequantized: codes times
    their row's scale)."""
    if not is_quantized(entry):
        return entry
    s = entry["s"].transpose(1, 2)[..., None]  # [B, S, H, 1]
    return entry["q8"].to(dtype) * s.to(dtype)
