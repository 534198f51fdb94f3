"""One-token GQA decode attention over the layer-stacked KV cache: CUDA
kernels and their plain versions.

The port of ``llm_consensus_tpu/ops/pallas/decode_attention.py`` in three
variants, each a kernel in ``csrc/decode_attention.cu``:

  * the bf16 cache ``[L, B, S, Hkv, dh]``;
  * the int8 cache ``{"q8": int8 [L, B, S, Hkv, dh], "s": [L, B, Hkv, S]}``
    read as codes: the per-slot K scale multiplies the scores, the per-slot
    V scale folds into p (a select, so NaN scales past the frontier never
    reach the output), and no dequantized K/V exists;
  * W8A8 scores over the int8 cache (``w8a8=True``, GQA group 2 to 4, the
    TPU kernel's dense-GQA form): q quantized per (row, head) to int8 with a
    float32 scale, int8 x int8 scores with int32 accumulation, P.V in bf16.

All three are one launch per call: a split plan made here from the shape
(:func:`split_plan`), a ``cp.async`` ring of 128-slot chunks (64 at head
width 256), tensor-core scores, and the merge of the splits fused into the
launch (the last CTA of each (row, kv head) merges, after a ticket in a
per-device int32 buffer).
Each variant also has a ``return_state`` form (the shared-prefix decode
path): the kernel's merge writes the softmax state it already holds, fp32
``(m, l)`` [B, Hq], beside the output, in the same launch. ``m`` is the max
of the scores after ``scale``, softcap and the mask; ``l`` the denominator
at that max, summed before the int8 V scale folds into p; a row with no
valid slot gives ``m = NEG_INF`` and ``l = 0``.

:func:`decode_attention` launches the kernel, or raises, for CUDA tensors
and uses :func:`decode_attention_plain` only for tensors on the CPU. The
plain version repeats the TPU kernel's arithmetic: kv blocks of the span,
an fp32 online softmax with the same ``NEG_INF``, invalid V rows (bf16) or
V scales (int8) zeroed by a select, p cast to q's dtype (bf16 for W8A8)
before P.V, and l = 0 rows output as 0. Its p is a select over the valid
slots, so a row with nothing valid reports l = 0 (the TPU kernel's online
loop counts exp(0) per masked column there; its output is 0 either way,
and the merge drops such a row whatever its l).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from llm_consensus_tpu_torch.analysis import sanitizer
from llm_consensus_tpu_torch.obs import roofline as _roofline
from llm_consensus_tpu_torch.ops.kernels.build import (
    LaunchCounter, check, ensure_built)
from llm_consensus_tpu_torch.ops.quant import is_quantized, quantize_rows_sym

NEG_INF = -1e30  # the TPU kernel's mask value

# Head widths the CUDA kernel is instantiated for, the largest GQA group it
# holds (one 16-row tensor-core tile), the kv slots of one chunk of its
# ring (the most: at dh 256 a CTA has four warps and 64-slot chunks), the
# least span of a split, the most splits its fused merge holds (at every
# head width), and the CTAs per SM its plan aims at. The least split and the
# CTAs per SM come from the card: over either cache one merge round trip
# costs more than a split under 256 slots saves (the int8 cache measured at
# 128, 256 and 512), and a second CTA per SM bought no bandwidth (measured
# on an H100, PERF.md §6).
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 16
RING_CHUNK = 128
MIN_SPLIT = 256
MAX_SPLIT = 512
CTAS_PER_SM = 1
H100_SMS = 132

LAUNCHES = LaunchCounter()        # bf16 cache
LAUNCHES_INT8 = LaunchCounter()   # int8 cache
LAUNCHES_W8A8 = LaunchCounter()   # int8 cache, int8 x int8 scores
LAUNCHES_STATE = LaunchCounter()  # any variant with return_state=True

Index = Union[int, torch.Tensor]
Cache = Union[torch.Tensor, dict]


def _pow2_block(width: int, cap: int) -> int:
    """Largest power-of-two divisor of ``width``, capped at ``cap``."""
    bk = 1
    while bk * 2 <= cap and width % (bk * 2) == 0:
        bk *= 2
    return bk


def split_plan(kv_width: int, batch: int, n_kv_heads: int, sms: int = H100_SMS) -> int:
    """Splits per (row, kv head) of the decode kernel, over either cache: as
    many CTAs (``batch * n_kv_heads * n_split``) as fit ``CTAS_PER_SM`` to an
    SM in one wave, never more (a second wave would double the time of the
    CTAs left over), and no split shorter than ``MIN_SPLIT`` slots unless
    the width is. It depends only on host ints, so one plan serves every
    step of a CUDA graph."""
    rows = batch * n_kv_heads
    want = CTAS_PER_SM * sms // rows
    return max(1, min(want, kv_width // MIN_SPLIT, MAX_SPLIT))


def split_bounds(kv_width: int, n_split: int) -> list:
    """The slots ``[start, end)`` of each split, as the kernel computes them:
    split ``i`` starts at ``i * kv_width // n_split``."""
    return [(i * kv_width // n_split, (i + 1) * kv_width // n_split) for i in range(n_split)]


_sms: dict = {}
_tickets: dict = {}
_tickets_lock = sanitizer.make_lock("ops.kernels.decode_attention")


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev.index]


def _ticket_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's int32 tickets on ``dev``, zero between launches (the
    last CTA of each (row, kv head) resets its own). One buffer per device:
    the port issues all device work of a device on one stream. Made outside
    CUDA-graph capture, so a graph replays against zeros."""
    with _tickets_lock:
        buf = _tickets.get(dev.index)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "decode_attention: call it once outside CUDA-graph capture first "
                    "(its ticket buffer is made then)")
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _tickets[dev.index] = buf
        return buf


def decode_supported(n_heads: int, n_kv_heads: int, head_dim: int) -> bool:
    """The Hopper kernel's own shape limits (any kv width is legal: the
    CTAs mask the ragged last chunk)."""
    return (
        n_heads % n_kv_heads == 0
        and n_heads // n_kv_heads <= MAX_GROUP
        and head_dim in HEAD_DIMS
    )


def w8a8_supported(n_heads: int, n_kv_heads: int) -> bool:
    """W8A8 scores exist only in the dense-GQA form: group 2 to 4."""
    return 2 <= n_heads // n_kv_heads <= 4


def _check_shapes(q, k, v, w8a8: bool) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode kernel is T=1 only, q {tuple(q.shape)}")
    if is_quantized(k) != is_quantized(v):
        raise ValueError("k and v must both be int8 dicts or both be tensors")
    kc, vc = (k["q8"], v["q8"]) if is_quantized(k) else (k, v)
    if kc.dim() != 5 or vc.shape != kc.shape:
        raise ValueError(
            f"k/v must be [L, B, S, Hkv, dh] stacks, got {tuple(kc.shape)}, "
            f"{tuple(vc.shape)}"
        )
    b, _, hq, dh = q.shape
    if kc.shape[1] != b or kc.shape[4] != dh:
        raise ValueError("q and the cache disagree on batch or head_dim")
    if hq % kc.shape[3]:
        raise ValueError(f"n_heads {hq} not a multiple of n_kv_heads {kc.shape[3]}")
    if is_quantized(k):
        want = (kc.shape[0], b, kc.shape[3], kc.shape[2])
        for name, x in (("k", k), ("v", v)):
            if x["q8"].dtype != torch.int8 or tuple(x["s"].shape) != want:
                raise ValueError(
                    f"{name} must be {{'q8': int8 [L, B, S, Hkv, dh], 's': {list(want)}}}"
                )
    if w8a8 and not (is_quantized(k) and w8a8_supported(hq, kc.shape[3])):
        raise ValueError("W8A8 scores need the int8 cache and a GQA group of 2 to 4")


def decode_attention_plain(
    q: torch.Tensor,   # [B, 1, Hq, dh]
    k: Cache,          # [L, B, S, Hkv, dh], or the int8 dict
    v: Cache,
    pos: Index,
    layer_idx: Index = 0,
    row_start: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    kv_width: Optional[int] = None,
    w8a8: bool = False,
    return_state: bool = False,
):
    """The TPU kernel's arithmetic in plain PyTorch → [B, 1, Hq, dh], and
    with ``return_state`` also fp32 ``(m, l)`` [B, Hq]."""
    block_k = 512  # the TPU kernel's default kv block cap
    quantized = is_quantized(k)
    kc, vc = (k["q8"], v["q8"]) if quantized else (k, v)
    b, _, hq, dh = q.shape
    s, hkv = kc.shape[2], kc.shape[3]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    dev = q.device
    w = s if kv_width is None else min(kv_width, s)
    bk = _pow2_block(w, block_k)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    layer = torch.as_tensor(layer_idx, dtype=torch.int64, device=dev).reshape(1)
    rs = (
        torch.zeros(b, dtype=torch.int64, device=dev) if row_start is None
        else row_start.to(device=dev, dtype=torch.int64)
    )
    kl = kc.index_select(0, layer)[0]  # [B, S, Hkv, dh]
    vl = vc.index_select(0, layer)[0]
    if quantized:
        ksl = k["s"].index_select(0, layer)[0].float()  # [B, Hkv, S]
        vsl = v["s"].index_select(0, layer)[0].float()
    qg = q[:, 0].reshape(b, hkv, g, dh)
    # P.V runs in q's dtype; in bf16 for W8A8 whatever q's dtype (the TPU
    # kernel's _qstruct_tail(..., jnp.bfloat16)).
    pv_dtype = torch.bfloat16 if w8a8 else q.dtype
    if w8a8:
        # q quantized once per step, per (row, head) over its dh values.
        # The int8 x int8 dot is exact in float32: |sum| <= dh * 127^2 < 2^24.
        q8, q_scale = quantize_rows_sym(qg)  # [B, Hkv, g, dh], [B, Hkv, g, 1]
        qg = q8.float()
    else:
        qg = qg.float()
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=dev)
    for k0 in range(0, w, bk):
        cols = k0 + torch.arange(bk, device=dev)
        valid = (cols[None, :] <= pos) & (cols[None, :] >= rs[:, None])  # [B, bk]
        if sliding_window is not None:
            valid = valid & (cols[None, :] > pos - sliding_window)
        if quantized:
            kb = kl[:, k0:k0 + bk].float() if w8a8 else kl[:, k0:k0 + bk].to(q.dtype).float()
            vb = vl[:, k0:k0 + bk].to(pv_dtype)  # int8 codes cannot be NaN
        else:
            kb = kl[:, k0:k0 + bk].float()
            # Zero invalid V rows (a select): NaN garbage past the frontier
            # would otherwise ride 0 * NaN = NaN through P.V.
            vb = torch.where(valid[:, :, None, None], vl[:, k0:k0 + bk],
                             torch.zeros_like(vl[:, k0:k0 + bk]))
        sc = torch.einsum("bkgd,bskd->bkgs", qg, kb)
        if w8a8:
            sc = sc * q_scale
        if quantized:
            sc = sc * ksl[:, :, None, k0:k0 + bk]  # per-column K scale
        sc = sc * scale
        if logit_softcap is not None:
            sc = logit_softcap * torch.tanh(sc / logit_softcap)
        sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(valid[:, None, None, :], torch.exp(sc - m_new[..., None]),
                        torch.zeros_like(sc))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        if quantized:
            # The V scale folds into p after l; a select keeps NaN scales of
            # slots past the frontier out.
            vs = vsl[:, :, None, k0:k0 + bk]
            p = p * torch.where(valid[:, None, None, :], vs, torch.zeros_like(vs))
        pv = torch.einsum("bkgs,bskd->bkgd", p.to(pv_dtype).float(), vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    out = out.reshape(b, 1, hq, dh).to(q.dtype)
    if return_state:
        return out, m.reshape(b, hq), l.reshape(b, hq)
    return out


def decode_attention(
    q: torch.Tensor,
    k: Cache,
    v: Cache,
    pos: Index,
    layer_idx: Index = 0,
    row_start: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    kv_width: Optional[int] = None,
    w8a8: bool = False,
    return_state: bool = False,
):
    """Single-step GQA attention over one layer of the cache → [B, 1, Hq, dh]
    (with ``return_state``: ``(out, m, l)``, m and l fp32 [B, Hq]).

    Row ``b`` attends slots ``row_start[b] <= p <= pos`` of layer
    ``layer_idx`` (windowed when ``sliding_window``) within ``kv_width``.
    ``k``/``v`` are the full bf16 stacks or the int8 dicts (full code and
    scale stacks: the kernel addresses the layer by offset, no slice);
    ``w8a8`` takes the int8 x int8 score variant (int8 cache, GQA group 2
    to 4). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. On CUDA, ``pos`` and ``layer_idx`` are int32 device
    scalars and ``row_start`` an int32 device vector, so a step reads them
    on the card with no host sync. Under a roofline capture
    (obs/roofline.py) the call books its own work.
    """
    _check_shapes(q, k, v, w8a8)
    args = (q, k, v, pos, layer_idx, row_start, scale, sliding_window, logit_softcap,
            kv_width, w8a8, return_state)
    if _roofline.CAPTURING:
        cap = _roofline.current_capture()
        if cap is not None:
            with cap.kernel(*decode_work(q, k, kv_width, cap.kv_valid, return_state)):
                return _decode(*args)
    return _decode(*args)


def decode_work(q: torch.Tensor, k: Cache, kv_width: Optional[int] = None,
                kv_valid: Optional[int] = None,
                return_state: bool = False) -> tuple[float, float, float]:
    """(FLOPs, bytes, output bytes) of one call over ``kv_valid`` valid
    cache slots summed over rows (None: every slot of the width, every
    row): QK^T and PV per valid slot; each valid K/V slot (codes and scales
    of an int8 cache) and q read once, the output (and the state) written
    once."""
    b, _, hq, dh = q.shape
    quantized = is_quantized(k)
    kc = k["q8"] if quantized else k
    s, hkv = kc.shape[2], kc.shape[3]
    n = b * (s if kv_width is None else min(kv_width, s)) if kv_valid is None else kv_valid
    slot = 2.0 * hkv * (dh + k["s"].element_size() if quantized else dh * kc.element_size())
    out_b = float(q.element_size() * b * hq * dh + (8 * b * hq if return_state else 0))
    return 4.0 * hq * dh * n, n * slot + q.element_size() * b * hq * dh + out_b, out_b


def _decode(q, k, v, pos, layer_idx, row_start, scale, sliding_window, logit_softcap,
            kv_width, w8a8, return_state):
    quantized = is_quantized(k)
    tensors = [("q", q)]
    if quantized:
        tensors += [("k.q8", k["q8"]), ("v.q8", v["q8"]), ("k.s", k["s"]), ("v.s", v["s"])]
    else:
        tensors += [("k", k), ("v", v)]
    if all(x.device.type == "cpu" for _, x in tensors):
        return decode_attention_plain(
            q, k, v, pos, layer_idx, row_start, scale=scale,
            sliding_window=sliding_window, logit_softcap=logit_softcap,
            kv_width=kv_width, w8a8=w8a8, return_state=return_state,
        )
    dev = q.device
    for name, x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} on {x.device}, q on {dev}")
        if x.dtype != (torch.int8 if name.endswith("q8") else torch.bfloat16):
            raise TypeError(f"decode_attention kernel takes bf16 and int8 codes, "
                            f"{name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must start on a 16-byte boundary")
    kc = k["q8"] if quantized else k
    b, _, hq, dh = q.shape
    s, hkv = kc.shape[2], kc.shape[3]
    if not decode_supported(hq, hkv, dh):
        raise ValueError(
            f"decode_attention kernel has no build for Hq={hq}, Hkv={hkv}, dh={dh}"
        )

    for name, x, n in (("pos", pos, 1), ("layer_idx", layer_idx, 1), ("row_start", row_start, b)):
        if (not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != torch.int32
                or x.numel() != n or not x.is_contiguous()):
            raise ValueError(f"decode_attention: {name} must be {n} int32 on {dev}")
    w = s if kv_width is None else min(kv_width, s)
    scale = dh ** -0.5 if scale is None else scale
    lib = ensure_built()
    # The host's split plan; one launch, whose last CTA per (row, kv head)
    # merges the splits.
    n_split = split_plan(w, b, hkv, _sm_count(dev))
    part_m = part_l = part_acc = tickets = None
    if n_split > 1:
        part_m = torch.empty(b * hq * n_split, dtype=torch.float32, device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty(b * hq * n_split * dh, dtype=torch.float32, device=dev)
        tickets = _ticket_buffer(dev, b * hkv)
    out = torch.empty_like(q)
    m_out = l_out = None
    if return_state:
        m_out = torch.empty((b, hq), dtype=torch.float32, device=dev)
        l_out = torch.empty_like(m_out)

    def ptr(x):
        return None if x is None else x.data_ptr()

    index = (pos.data_ptr(), layer_idx.data_ptr(), row_start.data_ptr(),
             ptr(part_m), ptr(part_l), ptr(part_acc), ptr(tickets))
    tail = (
        out.data_ptr(), ptr(m_out), ptr(l_out), b, s, hq, hkv, dh, w, n_split,
        sliding_window or 0, float(logit_softcap or 0.0), float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    with torch.cuda.device(dev):
        if not quantized:
            err = lib.llmc_decode_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 *index, *tail)
            name, counter = "decode_attention", LAUNCHES
        else:
            fn = lib.llmc_decode_attention_int8_w8a8 if w8a8 else lib.llmc_decode_attention_int8
            err = fn(q.data_ptr(), k["q8"].data_ptr(), v["q8"].data_ptr(),
                     k["s"].data_ptr(), v["s"].data_ptr(), *index, *tail)
            name = "decode_attention_int8_w8a8" if w8a8 else "decode_attention_int8"
            counter = LAUNCHES_W8A8 if w8a8 else LAUNCHES_INT8
    check(lib, err, name)
    counter.add()
    if return_state:
        LAUNCHES_STATE.add()
        return out, m_out, l_out
    return out
