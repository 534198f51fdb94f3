#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llm_consensus_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phase kernels   # build + kernel checks only
    python3 chip_smoke.py --phase mixtral   # build + the Mixtral phases only
    python3 chip_smoke.py --phase telemetry # build + the telemetry phase only
    python3 chip_smoke.py --phase modes     # build + the modes phase only
    python3 chip_smoke.py --phase session   # build + the session phase only
    python3 chip_smoke.py --phase serving   # build + the B = 16 kernel rows + serving

Phases, in order; any failure exits non-zero before the last line:

1. the card: ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels from ``llm_consensus_tpu_torch/csrc`` with nvcc
   for sm_90a (seconds printed);
3. kernels against their plain PyTorch versions on the card, in bf16, at
   the main path's shapes and at edge cases of their tiling (flash, also at
   B = 4, ragged T, q_offset, window, softcap, GQA groups 1 and 8, dh 32
   and 64; decode over the bf16 cache at the split plan's edge widths and
   replayed from one CUDA graph at four frontiers; decode over the int8
   cache and with W8A8 scores, at widths 1 to 8,192 across the split plan
   and from a CUDA graph replayed at four frontiers, with the plan's least
   split timed at 128, 256 and 512 slots; the ``return_state`` form of all
   three decode variants at B = 4 with ragged row starts, the bf16 one also at
   width 8,192 beside the aten memory-efficient attention; the bf16 decode and
   its ``return_state`` form at B = 16 with ragged row starts, widths 384 and
   2,048, beside SDPA and the memory-efficient attention); each timed with CUDA
   graphs, warm (back-to-back calls on the same inputs) and cold (a 128 MiB
   write between calls flushes the 50 MB L2; the flushes alone are timed
   and subtracted), beside its plain version and, where one exists, one
   PyTorch library call timed the same two ways; then the int8 matmuls
   (exactness of the int8 x int8 product, device time of the int8-weight
   matmul against bf16);
4. the small-model check: a narrow model's logits through the kernels
   against the same model through the plain attention op;
5. the slice: one consensus run through the port's CLI (llama-3-8b +
   consensus-1b panel, llama-3-8b judge, random weights from a seed), with
   the kernel launch counters read around it;
6. the chunked path: one Engine.generate on llama-3-8b with a ~1,500-token
   prompt (chunked prefill, then decode at a longer frontier);
7. a torch.profiler window over one llama-3-8b generate: device busy
   share and the kernels with the most device time (the bf16 decode is one
   launch per (layer, step): no merge kernel may appear);
8. the batched slice: the CLI run with a panel of 4 x llama-3-8b and a
   llama-3-8b judge under ``LLMC_MAX_BATCH=4`` (one continuous batcher;
   the panel's shared prompt becomes the pool's shared prefix, so its
   decode runs the decode kernel's ``return_state`` form), then the
   batcher driven directly: the first decode step's logits of a
   shared-prefix wave against the single-stream engine, the wall of a
   decode step at B = 1, at B = 4 and at B = 4 with the prefix, a
   shared-prefix wave with an unrelated prompt beside it, a profiler
   window over a shared-prefix wave, a wave of 4 unrelated prompts (flash
   at B = 4), and short int8-KV and W8A8 shared-prefix runs;
8a. telemetry (obs/, on by default in every CLI phase): the slice's CLI
   run with ``--events`` and auto-save, then the batched slice's, each
   checked for the JAX CLI's run directory (``metrics.json``,
   ``trace.json``), the expected spans and roofline counters, the kernels'
   launches, every roofline share at most 1.05, decode memory-bound and
   the cross-check ok (each family's rates, intensity and verdict
   printed); the attribution ledger's decode device time against the
   kernels of a torch.profiler window; a generate on new keys and again
   (the device time a captured and an uncaptured dispatch book, and the
   captures' counting time); one llama-3-8b generate with every
   plane bound and with none, in turns (decode rates, host time inside
   telemetry code per chunk, synchronizations per chunk, which must be
   equal); ``--trace DIR`` and ``--profile`` artifacts with the card's
   kernels; the ledger's device-memory numbers against
   ``torch.cuda.max_memory_allocated``; the slice's auto-saved CLI run in
   a fresh process with the planes on and off, one of each (process and
   main() walls);
8b. the consensus modes (``--phase modes``), each through the port's CLI
   over warm shared providers (the slice's panel and judge, bf16, the
   350-token prompt, 64 tokens): ``--rounds 2 --confidence --system-file``
   (7 generates), ``--vote`` (2, no judge engine built), ``--continue``, a
   plain run (the phase's baseline wall), ``--resume`` of that run less one
   panel answer and of a run whose child
   process was killed with SIGKILL after its first panel answer, ``-i``
   over three queries, the config file with an alias, and ``--version``;
   each run's generates, the decode kernel's launches, flash launched
   exactly for the prompts that fit one prefill chunk, no warning but the
   ones random weights cause; a ``{"modes": ...}`` line;
8c. the session phase (``--phase session``) over warm shared providers
   (llama-3-8b and consensus-1b, bf16): (a) prefix snapshot reuse, the
   1,501-token prompt and 48 tokens, then it with its answer and a
   200-token follow-up, on an engine holding the snapshot and on a fresh
   one (the reused tokens of the prefill span, at least 1,501; the
   follow-up's prefill ms, CUDA events, median of 5; first-step logits
   within BATCH_LOGIT_TOL; greedy tokens; peak memory with and without the
   snapshot), then a full-prompt wave of 4 rows sharing 1,100 tokens with a
   snapshot to fork and without; (b) the slice's CLI run with
   ``--judge-overlap`` and without, one of each: wall, the
   judge's time to first token after the panel's end, the session's
   prefilled tokens, the judge prompt's tokens, no classic fallback; (c)
   the provider's retry ladder on consensus-1b: an injected RuntimeError
   (one eviction, one rebuild, the answer, peak memory under one more
   engine's weights), an injected torch.cuda.OutOfMemoryError (rebuilt),
   an injected KernelLaunchError (propagates, no rebuild); (d) a mixed panel
   through the CLI: ``gpt-5.2-2025-12-11`` served by a local SSE mock on
   127.0.0.1 (``OPENAI_BASE_URL``) beside ``gpu:consensus-1b``, the
   llama-3-8b judge overlapped: exit 0, both answers, the JAX CLI's run
   directory; a ``{"session": ...}`` line;
8d. the serving phase (``--phase serving``) on llama-3-8b, bf16: (a) a
   ``ContinuousBatcher(max_batch=32)`` takes 32 random 350-token prompts
   (28 x 32 tokens, 4 x 160), shrinks to 8 rows once the short ones retire
   (memory_allocated before and after: 24 rows of 1.07 GB freed), then a
   burst of 12 prompts sharing the slice's prompt regrows it to 16 (the
   state kernel); rows over time, the step wall at 32, 8 and 16 rows, the 4
   moved streams against single-stream; (b) four residents (1,501-token
   prompts, 256 tokens) and a wave of four 1,501-token prompts with
   ``prefill_budget`` 2048, 0, 0, 2048: the residents' longest gap between
   fetches while the wave fills, the wave's time to first token, every
   stream against single-stream; (c) a 2-row pool, two LOW residents (128
   tokens) and a HIGH latecomer (64): a preemption, the resume through
   flash, all three against single-stream; (d) the CLI with 4 x llama-3-8b
   and its judge under ``LLMC_MAX_BATCH=16 --priority low --prefill-budget
   2048``: classes 2 and 1 at the batcher. A batched stream in bf16 must
   equal single-stream or, past a near-tie, keep every token within 0.25 of
   the model's best logit under teacher forcing. Any RuntimeWarning fails
   it. A ``{"serving": ...}`` line;
9. the quantized slice: the same CLI run with ``LLMC_QUANT=int8
   LLMC_KV_QUANT=int8`` in the environment (int8 weights, int8 KV cache,
   the int8 decode kernel), then a profiler window over one of its
   llama-3-8b generates (one int8 decode launch per (layer, step), no
   merge kernel);
10. long context: llama-3.1-8b with int8 weights and the int8 cache at its
    full 131,072 slots, an 8,000-token prompt (chunked prefill) and 64
    decoded tokens;
11. W8A8 and int4: one llama-3-8b generate each (350-token prompt, 48
    tokens), the first with int8 x int8 matmuls and decode scores (the W8A8
    decode kernel), the second with int4 weights;
12. Mixtral's shapes: one mixtral-8x7b layer's ``moe_block`` (d 4096,
    d_ff 14336, 8 experts, top-2) in float32 on the card against float32
    on the CPU at 1, 4 and 512 tokens, and the int8 and W8A8 decode
    kernels over its [32, 1, 32768, 8, 128] cache;
13. the Mixtral slice: the CLI run with a ``gpu:mixtral-8x7b,
    gpu:consensus-1b`` panel and a ``gpu:mixtral-8x7b`` judge under
    ``LLMC_QUANT=int8 LLMC_KV_QUANT=int8`` at full published width (random
    weights from the seed), auto-saved: every response, the consensus,
    ``agreement``, ``run.json`` and ``panel/``; flash and the int8 decode
    kernel launched, the bf16 decode kernel not; engine build time, wall,
    decode rates and MBU, prefill ms and peak device memory;
14. a torch.profiler window over one Mixtral int8 generate (one int8
    decode launch per (layer, step));
15. one Mixtral generate with W8A8 matmuls (``torch._int_mm`` per expert)
    and W8A8 decode scores;
16. the checkpoint loader: synthetic HF-layout checkpoints of tiny-mixtral
    and tiny-qwen2 written into a temp dir (the format writer is here),
    loaded through ``GPUProvider(checkpoint_dir=...)`` on the card;
17. a ``{"kernels": [...]}`` line, the card line, then the
    ``{"ok": true, ...}`` line.

Each path's launch counts are set to 0 just before it runs and read just
after; a kernel of the path that never launched fails the run.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s, for the least-time bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

FLASH_TOL = 3e-2   # max |kernel - plain| in bf16 outputs of magnitude ~1
# Decode outputs shrink as the width grows (~0.07 at most at width 8192 with
# unit-normal inputs), so a decode check allows 5 % of the largest plain
# output (a few bf16 ulps there), and never more than 3e-2.
DECODE_TOL = 3e-2
DECODE_REL_TOL = 0.05
# return_state: m is a max of fp32 scores of magnitude ~5 and l a sum of
# exps, both summed in another order than the plain version.
STATE_M_TOL = 1e-2      # absolute
STATE_L_REL_TOL = 1e-2  # relative
# The batcher's first decode step against the single-stream engine on
# llama-3-8b: two bf16 computation orders 32 layers deep, logits of std ~1
# (the small-model check's bound for bf16 on the card against float32 on
# the CPU).
BATCH_LOGIT_TOL = 0.25
FLUSH_BYTES = 128 << 20  # L2 flush for cold timings: over twice the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall per call of ``fn`` on the card, host launch cost included:
    CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []  # the L2 flush buffer, made on first use


def _flush_l2() -> None:
    """Write a 128 MiB scratch buffer (over twice the H100's 50 MB L2), so the
    next kernel finds none of its inputs in L2."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    _FLUSH[0].fill_(1)


def _graph_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed between two events."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int, cold: bool = False) -> tuple[float, str]:
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between two events, so host launch cost drops
    out. Warm (``cold=False``): back-to-back calls on the same inputs, which
    stay in L2 when they fit. Cold: each call follows a 128 MiB write
    (``_flush_l2``); the flushes are timed alone the same way and their time
    is subtracted. Returns (ms, method); a call that cannot be captured is
    timed eagerly instead (warm only), and the method says so."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        if cold:
            _flush_l2()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if not cold:
        try:
            return _graph_ms(fn, iters), "graph"
        except RuntimeError as err:
            log(f"  (graph capture refused: {err}; timing eagerly)")
            torch.cuda.synchronize()
            return eager_time_ms(fn, iters), "eager"

    def both():
        _flush_l2()
        fn()

    # The flush alone before and after, averaged: it is the larger term.
    flush_ms = _graph_ms(_flush_l2, iters)
    both_ms = _graph_ms(both, iters)
    flush_ms = 0.5 * (flush_ms + _graph_ms(_flush_l2, iters))
    return both_ms - flush_ms, "graph, L2 flushed"


def timed(fn, iters: int) -> dict:
    """Warm and cold device time of ``fn`` (ms)."""
    return {"ms": device_time_ms(fn, iters)[0], "cold_ms": device_time_ms(fn, iters, cold=True)[0]}


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate against bf16
    FLOPs plus int8 operations, each over its own peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_tol(want) -> float:
    return min(DECODE_TOL, DECODE_REL_TOL * want.float().abs().max().item())


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def release_memory(torch) -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- phase 3: kernels against their plain versions ---------------------------


def check_flash(torch, rec: dict) -> None:
    from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, t, s, hq, hkv, dh):
        mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",  # noqa: E731
                                        dtype=torch.bfloat16)
        return mk(b, t, hq, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh)

    cases = [
        # (name, b, t, s, hq, hkv, dh, q_offset, window, softcap)
        ("llama-3-8b prefill", 1, 512, 512, 32, 8, 128, 0, None, None),
        ("consensus-1b prefill", 1, 256, 256, 16, 8, 128, 0, None, None),
        ("q_offset", 1, 64, 192, 8, 2, 128, 128, None, None),
        ("q_offset mid-tile", 1, 100, 300, 8, 2, 128, 170, None, None),
        ("window", 1, 128, 128, 8, 2, 128, 0, 48, None),
        ("window mid-tile", 1, 320, 320, 8, 2, 128, 0, 200, None),
        ("softcap", 2, 64, 64, 8, 4, 128, 0, None, 30.0),
        ("ragged T, dh 64", 1, 48, 48, 8, 2, 64, 0, None, None),
        ("T 200, MHA, dh 32", 1, 200, 200, 8, 8, 32, 0, None, None),
        ("T 320, group 8", 2, 320, 320, 8, 1, 128, 0, None, None),
        ("B=4 admission wave", 4, 512, 512, 32, 8, 128, 0, None, None),
    ]
    worst = 0.0
    for name, b, t, s, hq, hkv, dh, off, win, cap in cases:
        q, k, v = qkv(b, t, s, hq, hkv, dh)
        kw = dict(q_offset=off, sliding_window=win, logit_softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        log(f"flash  {name:24s} B{b} T{t} S{s} Hq{hq} Hkv{hkv} dh{dh}: "
            f"max_abs_err {err:.3e} (tol {FLASH_TOL})")
        if not finite or err > FLASH_TOL:
            raise AssertionError(f"flash_attention {name}: err {err}, finite {finite}")
        worst = max(worst, err)

    # Timing at the slice's prefill shape (llama-3-8b, bucket 512), B = 1 and
    # the batcher's B = 4 admission wave.
    hq, hkv, dh, t = 32, 8, 128, 512
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for b in (1, 4):
        q, k, v = qkv(b, t, t, hq, hkv, dh)
        kern = timed(lambda: fa.flash_attention(q, k, v), 50)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kt = kt.repeat_interleave(hq // hkv, dim=1)
        vt = vt.repeat_interleave(hq // hkv, dim=1)
        lib = timed(lambda: sdpa(qt, kt, vt, is_causal=True), 50)
        pairs = t * (t + 1) // 2
        bms, by = bound_ms(2.0 * (2 * b * t * hq * dh + 2 * b * t * hkv * dh),
                           4.0 * b * hq * dh * pairs)
        times[b] = dict(kern=kern, lib=lib, bound=bms, by=by)
        if b == 1:
            eager_ms = eager_time_ms(lambda: fa.flash_attention(q, k, v), 50)
            plain_ms, _ = device_time_ms(lambda: fa.flash_attention_plain(q, k, v), 5)
        del q, k, v, qt, kt, vt
    one, four = times[1], times[4]
    rec.update(
        name="flash_attention", route="cuda",
        source="llm_consensus_tpu_torch/csrc/flash_attention.cu",
        replaces="llm_consensus_tpu/ops/pallas/flash_attention.py:136",
        shapes=f"q[1,{t},{hq},{dh}] k/v[1,{t},{hkv},{dh}] bf16, q_offset 0",
        max_abs_err=worst, ms=one["kern"]["ms"], cold_ms=one["kern"]["cold_ms"],
        plain_ms=plain_ms, bound_ms=one["bound"], bound_by=one["by"],
        bound_share=one["bound"] / one["kern"]["cold_ms"],
        library_ms=one["lib"]["ms"], library_cold_ms=one["lib"]["cold_ms"],
        b4_ms=four["kern"]["ms"], b4_cold_ms=four["kern"]["cold_ms"],
        b4_bound_ms=four["bound"], b4_library_ms=four["lib"]["ms"],
        b4_library_cold_ms=four["lib"]["cold_ms"],
    )
    for b, x in times.items():
        log(f"flash  timing q[{b},{t},{hq},{dh}] k/v[{b},{t},{hkv},{dh}]: kernel warm "
            f"{x['kern']['ms']:.4f} ms, cold {x['kern']['cold_ms']:.4f} ms; sdpa warm "
            f"{x['lib']['ms']:.4f}, cold {x['lib']['cold_ms']:.4f} ms; bound {x['bound']:.5f} ms "
            f"({x['by']})" + (f"; eager with launch {eager_ms:.4f} ms, plain {plain_ms:.4f} ms"
                              if b == 1 else ""))


def check_decode(torch, rec: dict) -> None:
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device="cuda")

    worst = 0.0

    def compare(name, q, k, v, pos, layer, rs, w, window=None, cap=None):
        nonlocal worst
        kw = dict(kv_width=w, sliding_window=window, logit_softcap=cap)
        if rs is None:
            rs = torch.zeros(q.shape[0], dtype=torch.int32, device="cuda")
        got = da.decode_attention(q, k, v, i32(pos), i32(layer), rs, **kw)
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k, v, pos, layer, rs, **kw)
        err, tol = max_err(got, want), decode_tol(want)
        finite = bool(torch.isfinite(got).all())
        log(f"decode {name:24s} q{list(q.shape)} cache{list(k.shape)} pos {pos} "
            f"width {w} layer {layer}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not finite or err > tol:
            raise AssertionError(f"decode_attention {name}: err {err}, finite {finite}")
        worst = max(worst, err)

    # llama-3-8b stack; NaN poisons the slots past each pos (pos descending,
    # so a later case never reads a poisoned valid slot). Widths 1, 63, 65
    # and 512 give the split plan its edge values (one split under one chunk,
    # just past one, the first width that splits).
    L, S, hq, hkv, dh, layer = 32, 8192, 32, 8, 128, 7
    k = rnd(L, 1, S, hkv, dh)
    v = rnd(L, 1, S, hkv, dh)
    q = rnd(1, 1, hq, dh)
    for pos, w in ((8191, 8192), (4000, 4096), (600, 640), (511, 512), (383, 384), (100, 128),
                   (64, 65), (62, 63), (0, 1)):
        k[layer, :, pos + 1:] = float("nan")
        v[layer, :, pos + 1:] = float("nan")
        compare("llama-3-8b", q, k, v, pos, layer, None, w)
    k[layer].normal_(generator=gen)
    v[layer].normal_(generator=gen)

    # One CUDA graph of a decode call replayed at other frontiers: the
    # kernel's merge tickets must be back at 0 after every launch.
    rs0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    pos_t, layer_t, w = i32(100), i32(layer), 2048
    da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w)
    for pos in (100, 2047, 700, 5):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        want = da.decode_attention_plain(q, k, v, pos, layer, rs0, kv_width=w)
        err, tol = max_err(got, want), decode_tol(want)
        log(f"decode graph replay at pos {pos}, width {w}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if err > tol:
            raise AssertionError(f"decode graph replay at pos {pos}: err {err}")
        worst = max(worst, err)
    del graph

    # Timing at the slice's decode shape (prompt ~300 + 64 tokens: width
    # 384) and at the full llama-3-8b window, warm and cold.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)                                   # [1, Hq, 1, dh]
    times = {}
    for pos, w in ((383, 384), (S - 1, S)):
        pos_t = i32(pos)
        kern = timed(lambda: da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w), 200)
        kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        lib = timed(lambda: sdpa(qt, kt, vt), 200)
        n_valid = pos + 1
        bms, by = bound_ms(2.0 * (2 * n_valid * hkv * dh + 2 * hq * dh), 4.0 * hq * dh * n_valid)
        times[w] = dict(kern=kern, lib=lib, bound=bms, by=by, pos=pos)
        del kt, vt
    pos, w = 383, 384
    pos_t = i32(pos)
    eager_ms = eager_time_ms(
        lambda: da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w), 200)
    plain_ms, _ = device_time_ms(
        lambda: da.decode_attention_plain(q, k, v, pos_t, layer_t, rs0, kv_width=w), 10)
    del k, v
    torch.cuda.empty_cache()

    # consensus-1b stack (GQA group 2), small edge cases.
    k1 = rnd(16, 1, 4096, 8, 128)
    v1 = rnd(16, 1, 4096, 8, 128)
    compare("consensus-1b", rnd(1, 1, 16, 128), k1, v1, 300, 15, None, 384)
    del k1, v1
    kr, vr = rnd(2, 4, 128, 2, 128), rnd(2, 4, 128, 2, 128)
    rs = torch.tensor([0, 5, 17, 90], dtype=torch.int32, device="cuda")
    compare("B=4 ragged row_start", rnd(4, 1, 8, 128), kr, vr, 95, 1, rs, 128)
    compare("window + softcap", rnd(4, 1, 8, 128), kr, vr, 120, 0, None, 128, 32, 20.0)
    km, vm = rnd(1, 1, 300, 1, 64), rnd(1, 1, 300, 1, 64)
    compare("MQA g=8, dh 64, w 300", rnd(1, 1, 8, 64), km, vm, 250, 0, None, 300)
    kg, vg = rnd(1, 2, 1024, 1, 32), rnd(1, 2, 1024, 1, 32)
    compare("group 16, dh 32, B 2", rnd(2, 1, 16, 32), kg, vg, 1000, 0, None, 1024)
    short, full = times[384], times[S]
    rec.update(
        name="decode_attention", route="cuda",
        source="llm_consensus_tpu_torch/csrc/decode_attention.cu",
        replaces="llm_consensus_tpu/ops/pallas/decode_attention.py:415",
        shapes=f"q[1,1,{hq},{dh}] cache[{L},1,{S},{hkv},{dh}] bf16, pos {pos}, "
               f"kv_width {w}",
        max_abs_err=worst, ms=short["kern"]["ms"], cold_ms=short["kern"]["cold_ms"],
        plain_ms=plain_ms, bound_ms=short["bound"], bound_by=short["by"],
        bound_share=short["bound"] / short["kern"]["cold_ms"],
        library_ms=short["lib"]["ms"], library_cold_ms=short["lib"]["cold_ms"],
        w8192_ms=full["kern"]["ms"], w8192_cold_ms=full["kern"]["cold_ms"],
        w8192_bound_ms=full["bound"], w8192_bound_share=full["bound"] / full["kern"]["cold_ms"],
        w8192_library_ms=full["lib"]["ms"], w8192_library_cold_ms=full["lib"]["cold_ms"],
    )
    for w, x in times.items():
        log(f"decode timing q[1,1,{hq},{dh}] cache[{L},1,{S},{hkv},{dh}] pos {x['pos']} width "
            f"{w} (split plan {da.split_plan(w, 1, hkv)}): kernel warm {x['kern']['ms']:.4f} ms, "
            f"cold {x['kern']['cold_ms']:.4f} ms; sdpa warm {x['lib']['ms']:.4f}, cold "
            f"{x['lib']['cold_ms']:.4f} ms; bound {x['bound']:.5f} ms ({x['by']}), "
            f"{100 * x['bound'] / x['kern']['cold_ms']:.1f} % of it cold"
            + (f"; eager with launch {eager_ms:.4f} ms, plain {plain_ms:.4f} ms"
               if w == 384 else ""))


def check_decode_int8(torch, rec8: dict, rec_w8: dict) -> None:
    """The int8-cache decode kernels (int8 and W8A8 scores) against their
    plain versions, then timed at the slice's decode shape."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def int8_side(l, b, s, hkv, dh=128):
        """{"q8": [L, B, S, Hkv, dh] int8, "s": [L, B, Hkv, S] bf16}, one
        layer at a time (the float temporaries stay one layer's size)."""
        q8 = torch.empty((l, b, s, hkv, dh), dtype=torch.int8, device="cuda")
        sc = torch.empty((l, b, hkv, s), dtype=torch.bfloat16, device="cuda")
        for i in range(l):
            codes, scale = quantize_kv(rnd(b, s, hkv, dh))
            q8[i].copy_(codes)
            sc[i].copy_(scale[..., 0].transpose(1, 2))
        return {"q8": q8, "s": sc}

    def i32(x):
        return torch.full((), x, dtype=torch.int32, device="cuda")

    worst = {False: 0.0, True: 0.0}

    def compare(name, q, k, v, pos, layer, rs, w, window=None, cap=None):
        if rs is None:
            rs = torch.zeros(q.shape[0], dtype=torch.int32, device="cuda")
        for w8a8 in (False, True):
            kw = dict(kv_width=w, sliding_window=window, logit_softcap=cap, w8a8=w8a8)
            got = da.decode_attention(q, k, v, i32(pos), i32(layer), rs, **kw)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, k, v, pos, layer, rs, **kw)
            err, tol = max_err(got, want), decode_tol(want)
            finite = bool(torch.isfinite(got).all())
            variant = "w8a8" if w8a8 else "int8"
            log(f"decode {variant} {name:22s} q{list(q.shape)} cache{list(k['q8'].shape)} "
                f"pos {pos} width {w} layer {layer}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if not finite or err > tol:
                raise AssertionError(f"decode_attention {variant} {name}: err {err}, "
                                     f"finite {finite}")
            worst[w8a8] = max(worst[w8a8], err)

    # llama-3-8b int8 stack; garbage codes and NaN scales poison the slots
    # past each pos of the layer (pos descending, so a later case never
    # reads a poisoned valid slot). The widths walk the split plan from 16
    # splits down to one, through split bounds off multiples of 8 (2,999),
    # the first width that splits (1,024), one chunk (128), just past one
    # (65), under one (63) and one slot.
    L, S, hq, hkv, dh, layer = 32, 8192, 32, 8, 128, 7
    k, v = int8_side(L, 1, S, hkv), int8_side(L, 1, S, hkv)
    q = rnd(1, 1, hq, dh)
    for pos, w in ((8191, 8192), (4000, 4096), (2998, 2999), (1500, 1536), (1023, 1024),
                   (600, 640), (511, 512), (383, 384), (100, 128), (64, 65), (62, 63), (0, 1)):
        for side in (k, v):
            side["q8"][layer, :, pos + 1:] = 127
            side["s"][layer, :, :, pos + 1:] = float("nan")
        compare("llama-3-8b", q, k, v, pos, layer, None, w)
    for side in (k, v):
        codes, scale = quantize_kv(rnd(1, S, hkv, dh))
        side["q8"][layer].copy_(codes)
        side["s"][layer].copy_(scale[..., 0].transpose(1, 2))

    # One CUDA graph of each variant replayed at other frontiers: the
    # kernel's merge tickets must be back at 0 after every launch.
    rs0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    for w8a8 in (False, True):
        variant = "w8a8" if w8a8 else "int8"
        pos_t, layer_t, w = i32(100), i32(layer), 2048
        da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w, w8a8=w8a8)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w, w8a8=w8a8)
        for pos in (100, 2047, 700, 5):
            pos_t.fill_(pos)
            graph.replay()
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, k, v, pos, layer, rs0, kv_width=w, w8a8=w8a8)
            err, tol = max_err(got, want), decode_tol(want)
            log(f"decode {variant} graph replay at pos {pos}, width {w}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            if not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(f"decode {variant} graph replay at pos {pos}: err {err}")
            worst[w8a8] = max(worst[w8a8], err)
        del graph
    pos, w = 383, 384
    pos_t, layer_t, last = i32(pos), i32(layer), i32(S - 1)
    # With unit-normal q, rounding q to int8 moves the output far less than
    # the tolerance, so the cases above cannot tell W8A8 from int8. Here q
    # has one outlier of 127 per head, on a dimension where every K code is
    # 0: it sets q's int8 scale to 1 without touching the scores, so W8A8
    # rounds the rest of q to integers and moves the output well past the
    # tolerance. Each kernel must match its own plain version and not the
    # other's.
    k["q8"][layer, ..., 0] = 0
    q_out = q.clone()
    q_out[..., 0] = 127.0
    got, want = {}, {}
    for w8a8 in (False, True):
        got[w8a8] = da.decode_attention(q_out, k, v, pos_t, layer_t, rs0, kv_width=w, w8a8=w8a8)
        want[w8a8] = da.decode_attention_plain(q_out, k, v, pos_t, layer_t, rs0, kv_width=w,
                                               w8a8=w8a8)
    torch.cuda.synchronize()
    for w8a8 in (False, True):
        variant = "w8a8" if w8a8 else "int8"
        err, tol = max_err(got[w8a8], want[w8a8]), decode_tol(want[w8a8])
        cross = max_err(got[w8a8], want[not w8a8])
        log(f"decode {variant} q outlier 127 per head   pos {pos} width {w}: max_abs_err "
            f"{err:.3e} (tol {tol:.3e}); against the {'int8' if w8a8 else 'w8a8'} plain "
            f"version {cross:.3e} (must exceed the tol)")
        if not bool(torch.isfinite(got[w8a8]).all()) or err > tol or cross <= tol:
            raise AssertionError(f"decode_attention {variant} q outlier: err {err}, "
                                 f"against the other variant {cross}, tol {tol}")
        worst[w8a8] = max(worst[w8a8], err)
    # Timing at the slice's decode shape (width 384), both variants.

    def int8_bytes(n):  # K+V codes, their bf16 scales, q in and out in bf16
        return 2.0 * n * hkv * dh + 2.0 * n * hkv * 2 + 2.0 * 2 * hq * dh

    n_valid = pos + 1
    nbytes, long_bytes = int8_bytes(n_valid), int8_bytes(S)
    for w8a8, rec in ((False, rec8), (True, rec_w8)):
        def call(w8a8=w8a8):
            return da.decode_attention(q, k, v, pos_t, layer_t, rs0, kv_width=w, w8a8=w8a8)

        kern = timed(call, 200)
        ms = kern["ms"]
        eager_ms = eager_time_ms(call, 200)
        plain_ms, _ = device_time_ms(
            lambda w8a8=w8a8: da.decode_attention_plain(q, k, v, pos_t, layer_t, rs0,
                                                        kv_width=w, w8a8=w8a8), 10)
        long = timed(
            lambda w8a8=w8a8: da.decode_attention(q, k, v, last, layer_t, rs0,
                                                  kv_width=S, w8a8=w8a8), 100)
        if w8a8:  # int8 x int8 scores, bf16 P.V
            bms, by = bound_ms(nbytes, 2.0 * hq * dh * n_valid, 2.0 * hq * dh * n_valid)
            long_bms, _ = bound_ms(long_bytes, 2.0 * hq * dh * S, 2.0 * hq * dh * S)
        else:
            bms, by = bound_ms(nbytes, 4.0 * hq * dh * n_valid)
            long_bms, _ = bound_ms(long_bytes, 4.0 * hq * dh * S)
        name = "decode_attention_int8_w8a8" if w8a8 else "decode_attention_int8"
        rec.update(
            name=name, route="cuda",
            source="llm_consensus_tpu_torch/csrc/decode_attention.cu",
            replaces=("llm_consensus_tpu/ops/pallas/decode_attention.py:245" if w8a8 else
                      "llm_consensus_tpu/ops/pallas/decode_attention.py:268"),
            shapes=f"q[1,1,{hq},{dh}] int8 cache[{L},1,{S},{hkv},{dh}] + bf16 scales, "
                   f"pos {pos}, kv_width {w}",
            max_abs_err=worst[w8a8], ms=ms, cold_ms=kern["cold_ms"], plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, bound_share=bms / kern["cold_ms"], library_ms=None,
            w8192_ms=long["ms"], w8192_cold_ms=long["cold_ms"], w8192_bound_ms=long_bms,
            w8192_bound_share=long_bms / long["cold_ms"],
        )
        log(f"decode {name} timing {rec['shapes']} (split plan "
            f"{da.split_plan(w, 1, hkv)}): kernel warm {ms:.4f} ms, "
            f"cold {kern['cold_ms']:.4f} ms (eager with launch {eager_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library none, bound {bms:.5f} ms ({by}), "
            f"{100 * bms / kern['cold_ms']:.1f} % of it cold; at pos {S - 1}, width {S} (split "
            f"plan {da.split_plan(S, 1, hkv)}): kernel warm "
            f"{long['ms']:.4f} ms, cold {long['cold_ms']:.4f} ms, bound {long_bms:.5f} ms, "
            f"{100 * long_bms / long['cold_ms']:.1f} % of it cold")

    # The plan's least split over the int8 cache, whose slots carry half
    # the bf16 bytes: 128, 256 (the shipped MIN_SPLIT) and 512 slots, cold,
    # at widths where the plans differ (B 1), in turns.
    shipped = da.MIN_SPLIT
    by_min, splits = {}, {}
    try:
        for min_split in (128, 256, 512, 512, 256, 128):
            da.MIN_SPLIT = min_split
            for width in (384, 1024, 2048, 8064):
                splits[min_split, width] = da.split_plan(width, 1, hkv)
                t = device_time_ms(lambda width=width, p=i32(width - 1): da.decode_attention(
                    q, k, v, p, layer_t, rs0, kv_width=width), 100, cold=True)[0]
                by_min.setdefault(min_split, {}).setdefault(width, []).append(t)
    finally:
        da.MIN_SPLIT = shipped
    for min_split, times in by_min.items():
        log(f"decode int8 least split {min_split}: cold ms by width (two runs each) "
            + ", ".join(f"{width} ({splits[min_split, width]} splits) {t[0]:.4f}/{t[1]:.4f}"
                        for width, t in times.items()))
    rec8["min_split_cold_ms"] = {str(m): {str(w): sum(t) / len(t) for w, t in times.items()}
                                 for m, times in by_min.items()}
    del k, v
    release_memory(torch)

    # consensus-1b-like group 2 at B = 4, ragged rows; window + softcap.
    k1, v1 = int8_side(2, 4, 512, 8), int8_side(2, 4, 512, 8)
    rs = torch.tensor([0, 37, 5, 90], dtype=torch.int32, device="cuda")
    compare("B=4 ragged row_start", rnd(4, 1, 16, 128), k1, v1, 300, 1, rs, 384)
    compare("window + softcap", rnd(4, 1, 16, 128), k1, v1, 400, 0, None, 512, 128, 30.0)
    del k1, v1
    release_memory(torch)


STATE_VARIANTS = (
    # (key, record name, w8a8)
    ("bf16", "decode_attention_state", False),
    ("int8", "decode_attention_int8_state", False),
    ("w8a8", "decode_attention_int8_w8a8_state", True),
)


def check_decode_state(torch, recs: dict) -> None:
    """The ``return_state`` form of the three decode variants against their
    plain versions: q [4, 1, 32, 128] over llama-3-8b's [32, 4, 8192, 8, 128]
    cache with ragged row starts (one row holding one slot) at widths 8,192
    and 256, and a window + softcap case; garbage past each pos. Then each
    timed at width 256 against its bound; the bf16 one beside the aten
    memory-efficient SDPA op, which also returns the log-sum-exp."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(4)
    L, B, S, hq, hkv, dh, layer = 32, 4, 8192, 32, 8, 128, 7

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    k, v = rnd(L, B, S, hkv, dh), rnd(L, B, S, hkv, dh)

    def int8_of(x):
        q8 = torch.empty(x.shape, dtype=torch.int8, device="cuda")
        sc = torch.empty((L, B, hkv, S), dtype=torch.bfloat16, device="cuda")
        for i in range(L):
            codes, scale = quantize_kv(x[i])
            q8[i].copy_(codes)
            sc[i].copy_(scale[..., 0].transpose(1, 2))
        return {"q8": q8, "s": sc}

    k8, v8 = int8_of(k), int8_of(v)
    q = rnd(B, 1, hq, dh)
    caches = {"bf16": (k, v), "int8": (k8, v8), "w8a8": (k8, v8)}
    worst = {key: [0.0, 0.0, 0.0] for key, _, _ in STATE_VARIANTS}
    cases = [
        # (pos, width, row_start, window, softcap), pos descending: a later
        # case never reads a slot an earlier one poisoned.
        (8191, 8192, (0, 1000, 8191, 17), None, None),
        (255, 256, (0, 37, 255, 5), None, None),
        (200, 256, (0, 37, 150, 5), 64, 30.0),
    ]
    for pos, w, rs, window, cap in cases:
        k[layer, :, pos + 1:] = float("nan")
        v[layer, :, pos + 1:] = float("nan")
        for side in (k8, v8):
            side["q8"][layer, :, pos + 1:] = 127
            side["s"][layer, :, :, pos + 1:] = float("nan")
        for key, _name, w8a8 in STATE_VARIANTS:
            kk, vv = caches[key]
            kw = dict(kv_width=w, sliding_window=window, logit_softcap=cap, w8a8=w8a8,
                      return_state=True)
            got = da.decode_attention(q, kk, vv, i32(pos)[0], i32(layer)[0], i32(*rs), **kw)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, kk, vv, pos, layer, i32(*rs), **kw)
            err, tol = max_err(got[0], want[0]), decode_tol(want[0])
            m_err = max_err(got[1], want[1])
            l_err = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            log(f"state  {key:4s} pos {pos} width {w} row_start {rs} window {window} softcap "
                f"{cap}: out max_abs_err {err:.3e} (tol {tol:.3e}), m {m_err:.3e} (tol "
                f"{STATE_M_TOL}), l relative {l_err:.3e} (tol {STATE_L_REL_TOL})")
            if (not finite or err > tol or m_err > STATE_M_TOL or l_err > STATE_L_REL_TOL
                    or got[1].shape != (B, hq)):
                raise AssertionError(f"decode state {key}: out {err}, m {m_err}, l {l_err}, "
                                     f"finite {finite}")
            for j, e in enumerate((err, m_err, l_err)):
                worst[key][j] = max(worst[key][j], e)

    # Timing at width 256 (the poisoned tail lies past every valid slot).
    pos, w, rs = 255, 256, (0, 37, 255, 5)
    pos_t, layer_t, rs_t = i32(pos)[0], i32(layer)[0], i32(*rs)
    # The full window on an unpoisoned layer, for the record.
    last_t, layer3_t, rs0_t = i32(S - 1)[0], i32(3)[0], i32(0, 0, 0, 0)
    n_valid = sum(pos - r + 1 for r in rs)
    io = 2.0 * 2 * B * hq * dh + 2 * 4 * B * hq  # q in, out, and fp32 m and l out
    qt = q.transpose(1, 2)  # [B, Hq, 1, dh]
    kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
    vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
    cols = torch.arange(w, device="cuda")
    valid = (cols[None, :] <= pos) & (cols[None, :] >= rs_t[:, None].long())
    bias = torch.zeros((B, hq, 1, w), dtype=torch.bfloat16, device="cuda")
    bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
    for key, name, w8a8 in STATE_VARIANTS:
        kk, vv = caches[key]

        def call(kk=kk, vv=vv, w8a8=w8a8):
            return da.decode_attention(q, kk, vv, pos_t, layer_t, rs_t, kv_width=w, w8a8=w8a8,
                                       return_state=True)

        kern = timed(call, 200)
        ms = kern["ms"]
        eager_ms = eager_time_ms(call, 200)
        plain_ms, _ = device_time_ms(
            lambda kk=kk, vv=vv, w8a8=w8a8: da.decode_attention_plain(
                q, kk, vv, pos_t, layer_t, rs_t, kv_width=w, w8a8=w8a8, return_state=True), 10)
        long = timed(
            lambda kk=kk, vv=vv, w8a8=w8a8: da.decode_attention(
                q, kk, vv, last_t, layer3_t, rs0_t, kv_width=S, w8a8=w8a8, return_state=True),
            50)
        library = {"ms": None, "cold_ms": None}
        wide = {}
        if key == "bf16":
            nbytes = 2.0 * 2 * n_valid * hkv * dh + io
            bms, by = bound_ms(nbytes, 4.0 * hq * dh * n_valid)
            long_bms, _ = bound_ms(2.0 * 2 * B * S * hkv * dh + io, 4.0 * B * hq * dh * S)
            efficient = torch.ops.aten._scaled_dot_product_efficient_attention
            library = timed(lambda: efficient(qt, kt, vt, bias, True), 200)
            wide = time_state_width_8192(torch, da, q, k, v, rs)
        else:
            nbytes = 2.0 * n_valid * hkv * dh + 2.0 * 2 * n_valid * hkv + io
            long_bytes = 2.0 * B * S * hkv * dh + 2.0 * 2 * B * S * hkv + io
            if w8a8:
                bms, by = bound_ms(nbytes, 2.0 * hq * dh * n_valid, 2.0 * hq * dh * n_valid)
                long_bms, _ = bound_ms(long_bytes, 2.0 * B * hq * dh * S, 2.0 * B * hq * dh * S)
            else:
                bms, by = bound_ms(nbytes, 4.0 * hq * dh * n_valid)
                long_bms, _ = bound_ms(long_bytes, 4.0 * B * hq * dh * S)
        library_ms = library["ms"]
        rec = recs[key]
        rec.update(
            name=name, route="cuda", source="llm_consensus_tpu_torch/csrc/decode_attention.cu",
            replaces="llm_consensus_tpu/ops/pallas/decode_attention.py:410",
            shapes=(f"q[{B},1,{hq},{dh}] {'int8 ' if key != 'bf16' else ''}cache"
                    f"[{L},{B},{S},{hkv},{dh}], pos {pos}, kv_width {w}, row_start {list(rs)}, "
                    f"return_state"),
            max_abs_err=worst[key][0], m_max_abs_err=worst[key][1],
            l_max_rel_err=worst[key][2], ms=ms, cold_ms=kern["cold_ms"], plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, bound_share=bms / kern["cold_ms"], library_ms=library_ms,
            library_cold_ms=library["cold_ms"], w8192_ms=long["ms"],
            w8192_cold_ms=long["cold_ms"], w8192_bound_ms=long_bms,
            w8192_bound_share=long_bms / long["cold_ms"], **wide,
        )
        lib_text = ("none" if library_ms is None else
                    f"warm {library_ms:.4f}, cold {library['cold_ms']:.4f} ms")
        log(f"state  {name} timing {rec['shapes']}: kernel warm {ms:.4f} ms, cold "
            f"{kern['cold_ms']:.4f} ms (eager with launch {eager_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library {lib_text}, bound {bms:.5f} ms ({by}); at pos {S - 1}, width {S}, B {B}: kernel warm "
            f"{long['ms']:.4f} ms, cold {long['cold_ms']:.4f} ms, bound {long_bms:.4f} ms "
            f"({100 * long_bms / long['cold_ms']:.1f} % of it cold)")
    del k, v, k8, v8, kt, vt, caches
    release_memory(torch)


def time_state_width_8192(torch, da, q, k, v, rs: tuple) -> dict:
    """The bf16 ``return_state`` kernel at width 8,192 (pos 8,191 on an
    unpoisoned layer, row starts ``rs``) beside the one library call of the
    same function: the aten memory-efficient attention with its log-sum-exp
    over the GQA-expanded K and V of the layer, the slots outside
    ``[row_start, pos]`` masked by a bias. Each warm and cold."""
    L, B, S, hkv, dh = k.shape
    hq, layer = q.shape[2], 3
    pos = S - 1
    rs_t = torch.tensor(rs, dtype=torch.int32, device="cuda")
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    layer_t = torch.tensor(layer, dtype=torch.int32, device="cuda")
    kern = timed(lambda: da.decode_attention(q, k, v, pos_t, layer_t, rs_t, kv_width=S,
                                             return_state=True), 50)
    qt = q.transpose(1, 2)
    kt = k[layer].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
    vt = v[layer].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
    cols = torch.arange(S, device="cuda")
    valid = (cols[None, :] <= pos) & (cols[None, :] >= rs_t[:, None].long())
    bias = torch.zeros((B, hq, 1, S), dtype=torch.bfloat16, device="cuda")
    bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    got = da.decode_attention(q, k, v, pos_t, layer_t, rs_t, kv_width=S, return_state=True)
    lib_out = efficient(qt, kt, vt, bias, True)[0].transpose(1, 2)
    err = max_err(got[0], lib_out)
    library = timed(lambda: efficient(qt, kt, vt, bias, True), 50)
    n_valid = sum(pos - r + 1 for r in rs)
    bms, _ = bound_ms(2.0 * 2 * n_valid * hkv * dh + 2.0 * 2 * B * hq * dh + 2 * 4 * B * hq,
                      4.0 * hq * dh * n_valid)
    log(f"state  bf16 at pos {pos}, width {S}, row_start {list(rs)}: kernel warm "
        f"{kern['ms']:.4f} ms, cold {kern['cold_ms']:.4f} ms; library (aten efficient "
        f"attention with log-sum-exp, K/V expanded to {hq} heads) warm {library['ms']:.4f} ms, "
        f"cold {library['cold_ms']:.4f} ms; bound {bms:.5f} ms; kernel against library out "
        f"max_abs_err {err:.3e}")
    if err > decode_tol(lib_out):
        raise AssertionError(f"decode state at width {S}: kernel against library {err}")
    del kt, vt, bias
    return {"w8192_rs_ms": kern["ms"], "w8192_rs_cold_ms": kern["cold_ms"],
            "w8192_rs_bound_ms": bms, "w8192_library_ms": library["ms"],
            "w8192_library_cold_ms": library["cold_ms"], "w8192_rs": list(rs)}


ROWS16_STARTS = (0, 17, 100, 5, 0, 300, 31, 2, 64, 0, 200, 9, 1, 150, 40, 77)


def check_decode_rows16(torch, recs: dict) -> None:
    """The bf16 decode kernel and its ``return_state`` form at B = 16, the
    row-bucketed pool's middle size: q [16, 1, 32, 128] over llama-3-8b's
    layer shape with ragged row starts at widths 384 and 2,048 (garbage
    past each pos), each against its plain version, then timed warm and
    cold beside its bound and the library call: SDPA for the plain form,
    aten's memory-efficient attention with its log-sum-exp for the state
    form, over the GQA-expanded K/V with the row starts as a bias mask."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(6)
    L, B, S, hq, hkv, dh, layer = 4, 16, 2048, 32, 8, 128, 3

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    k, v, q = rnd(L, B, S, hkv, dh), rnd(L, B, S, hkv, dh), rnd(B, 1, hq, dh)
    rs_t = torch.tensor(ROWS16_STARTS, dtype=torch.int32, device="cuda")
    layer_t = torch.tensor(layer, dtype=torch.int32, device="cuda")
    qt = q.transpose(1, 2)  # [B, Hq, 1, dh]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    rows = {}
    for pos, w in ((2047, 2048), (383, 384)):  # pos descending: poison never read later
        k[layer, :, pos + 1:] = float("nan")
        v[layer, :, pos + 1:] = float("nan")
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        n_valid = sum(pos - r + 1 for r in ROWS16_STARTS)
        kt = k[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        vt = v[layer, :, :w].transpose(1, 2).repeat_interleave(hq // hkv, dim=1).contiguous()
        cols = torch.arange(w, device="cuda")
        valid = (cols[None, :] <= pos) & (cols[None, :] >= rs_t[:, None].long())
        bias = torch.zeros((B, hq, 1, w), dtype=torch.bfloat16, device="cuda")
        bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
        for state in (False, True):
            kw = dict(kv_width=w, return_state=state)

            def call(kw=kw, pos_t=pos_t):
                return da.decode_attention(q, k, v, pos_t, layer_t, rs_t, **kw)

            got = call()
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, k, v, pos, layer, rs_t, **kw)
            got0, want0 = (got[0], want[0]) if state else (got, want)
            err, tol = max_err(got0, want0), decode_tol(want0)
            m_err = l_err = 0.0
            if state:
                m_err = max_err(got[1], want[1])
                l_err = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
            finite = all(bool(torch.isfinite(x).all()) for x in (got if state else (got,)))
            name = "decode_attention_state" if state else "decode_attention"
            log(f"rows16 {name} pos {pos} width {w} (split plan {da.split_plan(w, B, hkv)}): "
                f"out max_abs_err {err:.3e} (tol {tol:.3e})"
                + (f", m {m_err:.3e} (tol {STATE_M_TOL}), l relative {l_err:.3e} (tol "
                   f"{STATE_L_REL_TOL})" if state else ""))
            if (not finite or err > tol or m_err > STATE_M_TOL or l_err > STATE_L_REL_TOL):
                raise AssertionError(f"{name} at B=16 width {w}: out {err}, m {m_err}, "
                                     f"l {l_err}, finite {finite}")
            kern = timed(call, 200)
            plain_ms, _ = device_time_ms(
                lambda kw=kw, pos_t=pos_t: da.decode_attention_plain(
                    q, k, v, pos_t, layer_t, rs_t, **kw), 10)
            if state:
                library = timed(lambda: efficient(qt, kt, vt, bias, True), 200)
            else:
                library = timed(lambda: sdpa(qt, kt, vt, attn_mask=bias), 200)
            io_bytes = 2.0 * 2 * B * hq * dh + (2 * 4 * B * hq if state else 0)
            bms, by = bound_ms(2.0 * 2 * n_valid * hkv * dh + io_bytes, 4.0 * hq * dh * n_valid)
            row = dict(err=err, m_err=m_err, l_err=l_err, ms=kern["ms"], cold_ms=kern["cold_ms"],
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=library["ms"], library_cold_ms=library["cold_ms"])
            rows[(state, w)] = row
            log(f"rows16 {name} timing q[{B},1,{hq},{dh}] cache[{L},{B},{S},{hkv},{dh}] pos {pos} "
                f"width {w} row starts {list(ROWS16_STARTS)}: kernel warm {kern['ms']:.4f} ms, "
                f"cold {kern['cold_ms']:.4f} ms, plain {plain_ms:.4f} ms, library warm "
                f"{library['ms']:.4f}, cold {library['cold_ms']:.4f} ms, bound {bms:.5f} ms "
                f"({by}), {100 * bms / kern['cold_ms']:.1f} % of it cold")
        del kt, vt, bias
    for state, key in ((False, "decode_attention_b16"), (True, "decode_attention_state_b16")):
        short, wide = rows[(state, 384)], rows[(state, 2048)]
        recs[key].update(
            name=("decode_attention_state" if state else "decode_attention") + " (B=16)",
            route="cuda", source="llm_consensus_tpu_torch/csrc/decode_attention.cu",
            replaces=("llm_consensus_tpu/ops/pallas/decode_attention.py:410" if state
                      else "llm_consensus_tpu/ops/pallas/decode_attention.py:415"),
            shapes=(f"q[{B},1,{hq},{dh}] cache[{L},{B},{S},{hkv},{dh}] bf16, pos 383, kv_width "
                    f"384, row starts {list(ROWS16_STARTS)}" + (", return_state" if state else "")),
            max_abs_err=max(short["err"], wide["err"]), ms=short["ms"], cold_ms=short["cold_ms"],
            plain_ms=short["plain_ms"], bound_ms=short["bound_ms"], bound_by=short["bound_by"],
            bound_share=short["bound_ms"] / short["cold_ms"], library_ms=short["library_ms"],
            library_cold_ms=short["library_cold_ms"], w2048_ms=wide["ms"],
            w2048_cold_ms=wide["cold_ms"], w2048_plain_ms=wide["plain_ms"],
            w2048_bound_ms=wide["bound_ms"], w2048_bound_share=wide["bound_ms"] / wide["cold_ms"],
            w2048_library_ms=wide["library_ms"], w2048_library_cold_ms=wide["library_cold_ms"],
            **({"m_max_abs_err": max(short["m_err"], wide["m_err"]),
                "l_max_rel_err": max(short["l_err"], wide["l_err"])} if state else {}),
        )
    del k, v, q
    release_memory(torch)


def check_int8_matmul(torch) -> None:
    """The int8 x int8 product on the card against the CPU's exact int32
    one, and the device time of the plain int8-weight matmul (convert the
    codes to bf16, multiply, scale the output) against a bf16 matmul and
    the W8A8 one, at llama-3-8b's gate projection (one decode row)."""
    from llm_consensus_tpu_torch.ops.quant import _int8_mm, _quantize, qmatmul

    gen = torch.Generator().manual_seed(3)
    for m in (1, 17, 512):
        a = torch.randint(-127, 128, (m, 4096), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (4096, 1024), generator=gen, dtype=torch.int8)
        got = _int8_mm(a.cuda(), b.cuda()).cpu()
        if not torch.equal(got, _int8_mm(a, b)):
            raise AssertionError(f"int8 x int8 product differs from int32 at M={m}")
    log("int8 matmul: torch._int_mm on the card equals the exact int32 product "
        "(M 1, 17, 512; K 4096, N 1024)")
    gcuda = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(4096, 14336, generator=gcuda, device="cuda", dtype=torch.bfloat16) * 0.02
    wq = _quantize(w)
    x = torch.randn(1, 4096, generator=gcuda, device="cuda", dtype=torch.bfloat16)
    bf16_ms, _ = device_time_ms(lambda: torch.matmul(x, w), 100)
    int8_ms, _ = device_time_ms(lambda: qmatmul(x, wq), 100)
    w8a8_ms, _ = device_time_ms(lambda: qmatmul(x, wq, w8a8=True), 100)
    log(f"int8-weight matmul x[1,4096] @ w[4096,14336] (device time, graph replay): bf16 "
        f"{bf16_ms:.4f} ms, int8 weights (plain: convert + matmul + scale) {int8_ms:.4f} ms, "
        f"W8A8 (torch._int_mm) {w8a8_ms:.4f} ms; bytes bound bf16 "
        f"{4096 * 14336 * 2 / PEAK_BYTES_PER_S * 1e3:.4f} ms, int8 "
        f"{4096 * 14336 / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    del w, wq
    release_memory(torch)


# -- phase 4: a narrow model, kernels against the plain attention op ---------

# Kernel path vs plain-op path, both bf16 on the card: each sits ~0.04 from
# float32 (the CPU gap below measures that bf16 noise on logits of std ~1).
SMALL_TOL = 0.1
CPU_TOL = 0.25     # bf16 on the card vs float32 on the CPU, logits of std ~1


def check_small_model(torch, seed: int) -> None:
    from llm_consensus_tpu_torch.models.config import get_config
    from llm_consensus_tpu_torch.models.transformer import (
        forward, init_kv_cache, init_params)

    cfg = get_config("tiny-llama", head_dim=128)
    dev = torch.device("cuda")
    params = init_params(cfg, seed, device=dev, dtype=torch.bfloat16)
    cpu_params = {
        k: ({n: w.float().cpu() for n, w in v.items()} if isinstance(v, dict)
            else v.float().cpu())
        for k, v in params.items()
    }
    gen = torch.Generator().manual_seed(seed)
    n_prompt, bucket = 27, 32
    tokens = torch.randint(0, 256, (1, bucket), generator=gen)
    last = torch.tensor([n_prompt - 1])
    caches = {
        "flash": init_kv_cache(cfg, 1, 128, device=dev),
        "torch": init_kv_cache(cfg, 1, 128, device=dev),
        "cpu": init_kv_cache(cfg, 1, 128, device=torch.device("cpu"), dtype=torch.float32),
    }
    worst = {"torch": 0.0, "cpu": 0.0}

    def step(toks, start, index=None):
        out = {}
        for name, cache in caches.items():
            on_cpu = name == "cpu"
            start_arg = start if isinstance(start, int) else (
                start.cpu() if on_cpu else start.to(dev))
            logits, _ = forward(
                cpu_params if on_cpu else params, cfg,
                toks if on_cpu else toks.to(dev), cache, start_arg,
                attn_impl="torch" if name == "torch" else "flash",
                kv_width=None if isinstance(start, int) else 128,
                logits_index=None if index is None else (index if on_cpu else index.to(dev)),
            )
            out[name] = logits[:, -1].float().cpu()
        for name in worst:
            err = (out["flash"] - out[name]).abs().max().item()
            worst[name] = max(worst[name], err)
        if not all(bool(torch.isfinite(x).all()) for x in out.values()):
            raise AssertionError("small model: non-finite logits")
        return out["flash"]

    with torch.inference_mode():
        logits = step(tokens, 0, last)
        pos = torch.tensor(n_prompt, dtype=torch.int32)
        for _ in range(8):
            nxt = logits.argmax(dim=-1)[:, None]
            logits = step(nxt, pos)
            pos = pos + 1
    log(f"small model {cfg.name} dh {cfg.head_dim}: prefill + 8 decode steps, "
        f"max |logit diff| kernels vs plain op {worst['torch']:.3e} (tol {SMALL_TOL}), "
        f"card bf16 vs cpu fp32 {worst['cpu']:.3e} (tol {CPU_TOL})")
    if worst["torch"] > SMALL_TOL or worst["cpu"] > CPU_TOL:
        raise AssertionError(f"small model logits disagree: {worst}")


# -- phases 5 and 6: the slice and the chunked path --------------------------

PROMPT = (
    "Three engineers disagree about the fastest way to move a large dataset "
    "between two data centers: ship encrypted drives by courier, stream it "
    "over the existing 10 Gbit/s link overnight, or rent a dedicated line for "
    "a week. Compare the options on cost, time, risk and operational effort, "
    "and recommend one for 400 TB that must arrive within five days."
)


def check_devices(engine) -> None:
    """Every parameter on the card; with int8 weights, every layer matmul
    weight as int8 codes."""
    import torch

    from llm_consensus_tpu_torch.models.transformer import param_leaves
    from llm_consensus_tpu_torch.ops.quant import QUANT_KEYS

    for name, w in param_leaves(engine.params):
        if not w.is_cuda:
            raise AssertionError(f"{engine.cfg.name}: param {name} on {w.device}")
    if engine.quant == "int8":
        for name in QUANT_KEYS - {"lm_head"}:
            codes = engine.params["layers"][name]["q8"]
            if codes.dtype != torch.int8:
                raise AssertionError(f"{engine.cfg.name}: {name} codes are {codes.dtype}")


def check_cache(engine, cache: dict) -> None:
    """The cache on the card; an int8 cache as int8 codes and card scales."""
    import torch

    for side, leaf in cache.items():
        parts = leaf.items() if isinstance(leaf, dict) else [("", leaf)]
        for key, t in parts:
            if not t.is_cuda:
                raise AssertionError(f"{engine.cfg.name}: cache {side}{key} on {t.device}")
        if engine.kv_quant == "int8" and leaf["q8"].dtype != torch.int8:
            raise AssertionError(f"{engine.cfg.name}: cache codes are {leaf['q8'].dtype}")


@contextlib.contextmanager
def set_environ(env: dict):
    """``env`` set in the process environment for the block, then restored."""
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def cli_call(torch, counters: dict, env: dict, argv: list, stdin: str = "") -> dict:
    """One call of the port's CLI in this process, on the card, with ``env``
    set for the call (and restored after) and ``stdin`` as its input;
    ``counters`` (name → LaunchCounter) are set to 0 just before and read
    just after. Returns the exit code, stdout, stderr, wall, launches and
    peak device memory."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main

    with set_environ(env):
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.monotonic()
        rc = cli_main(argv, device=None, stdin=io.StringIO(stdin), stdout=out, stderr=err,
                      install_signal_handlers=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue(), "wall_s": wall,
            "launches": {name: c.count for name, c in counters.items()},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def read_run_dir(run_dir: str) -> dict:
    """A saved run directory: its listing and its JSON files."""
    files = {"listing": sorted(os.listdir(run_dir)), "run_dir": run_dir}
    for name in ("result.json", "run.json", "metrics.json", "trace.json"):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                files[name] = json.load(f)
    return files


def run_slice(torch, counters: dict, env: dict, label: str,
              models: str = "gpu:llama-3-8b,gpu:consensus-1b", events: bool = False,
              extra: tuple = (), data_dir: str = "", prompt: str = PROMPT,
              timing: bool = True, n_models: int = 0, judge: str = "gpu:llama-3-8b") -> dict:
    """One consensus run through the port's CLI (panel ``models``, ``judge``,
    ``extra`` flags) with ``env`` set for the call (and restored
    after); ``counters`` (name → LaunchCounter) are set to 0 just before and
    read just after. Returns the launches, the provider and its built
    engines, the wall, the peak device memory and the responses; with
    ``timing``, each engine's prefill of the prompt is timed after the run.
    ``events``: the run takes ``--events``. ``events`` or ``data_dir``: the
    run auto-saves (into ``data_dir``, else a temporary directory) instead of
    printing ``--json``, and the result also holds the run directory's
    listing and its JSON files. ``n_models``: the panel's size when
    ``models`` holds an alias."""
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.knobs import batch_settings, quant_modes

    with set_environ(env):
        modes = {**batch_settings(), **quant_modes()}
    save = events or bool(data_dir)
    files = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        root = data_dir or tmp
        before = set(os.listdir(root)) if os.path.isdir(root) else set()
        argv = [
            "--models", models, "--judge", judge, "--max-tokens", "64",
            *(["--events"] if events else []), *([] if save else ["--json"]),
            "--data-dir", root, *extra, prompt,
        ]
        call = cli_call(torch, counters, env, argv)
        rc, wall = call["rc"], call["wall_s"]
        if save and rc == 0:
            (run_id,) = set(os.listdir(root)) - before
            files = read_run_dir(os.path.join(root, run_id))
    launches, peak_gb = call["launches"], call["peak_gb"]
    if rc != 0:
        raise AssertionError(f"{label}: CLI exit {rc}: {call['err']}")
    doc = files["result.json"] if save else json.loads(call["out"])
    n_models = n_models or len(models.split(","))
    if (len(doc["responses"]) != n_models or doc.get("failed_models")
            or not doc["consensus"]):
        raise AssertionError(f"{label}: bad result: {json.dumps(doc)[:2000]}")
    log(f"{label}: CLI exit 0 in {wall:.2f} s wall, peak device memory {peak_gb:.2f} GB, "
        f"launches {launches}, consensus {len(doc['consensus'])} chars")
    for resp in doc["responses"]:
        # Per-response rate over the whole request (prefill, queueing and
        # decode): the one rate both the batched and the single-stream path
        # report (a remote answer counts no tokens).
        e2e = (f"{resp['tokens'] / (resp['latency_ms'] / 1e3):.2f}"
               if resp.get("tokens") is not None else "n/a")
        log(f"  {resp['model']}: {resp.get('tokens')} tokens, latency "
            f"{resp['latency_ms']:.1f} ms ({e2e} tokens/s over the request), decode "
            f"{resp.get('tokens_per_sec')} tok/s, mfu {resp.get('mfu')}, mbu {resp.get('mbu')}")

    provider = GPUProvider.shared(**modes)
    engines = provider.engines()
    ids = ByteTokenizer().encode(PROMPT)
    for preset, engine in sorted(engines.items()):
        check_devices(engine)
        if not timing:
            continue
        with torch.inference_mode():
            _, cache = engine._prefill_ids(ids)
            check_cache(engine, cache)
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                engine._prefill_ids(ids)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        times.sort()
        log(f"  {preset}: prefill of {len(ids)} tokens (bucket 512, flash kernel) "
            f"median {times[2]:.2f} ms (min {times[0]:.2f}, max {times[-1]:.2f}, 5 runs)")
    return {"launches": launches, "engines": engines, "wall_s": wall, "peak_gb": peak_gb,
            "modes": modes, "provider": provider, "responses": doc["responses"],
            "files": files, "doc": doc, "err": call["err"]}


def release_engines(torch, modes: dict) -> None:
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    GPUProvider.shared(**modes).release()
    release_memory(torch)


def run_chunked(torch, fa, da, engine, seed: int) -> None:
    from llm_consensus_tpu_torch.engine import SamplingParams

    gen = torch.Generator().manual_seed(seed)
    ids = [engine.tokenizer.bos_id] + torch.randint(32, 127, (1500,), generator=gen).tolist()
    fa.LAUNCHES.reset()
    da.LAUNCHES.reset()
    t0 = time.monotonic()
    res = engine.generate_ids(ids, SamplingParams(max_new_tokens=48, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if res.prompt_tokens <= engine.prefill_chunk or len(res.token_ids) != 48:
        raise AssertionError(f"chunked path: {res.prompt_tokens} prompt, "
                             f"{len(res.token_ids)} generated")
    if da.LAUNCHES.count <= 0 or fa.LAUNCHES.count != 0:
        raise AssertionError(f"chunked path routing: flash {fa.LAUNCHES.count}, "
                             f"decode {da.LAUNCHES.count}")
    rate = res.decode_tokens / res.decode_s if res.decode_s > 0 else float("nan")
    log(f"chunked: {res.prompt_tokens}-token prompt in {engine.prefill_chunk}-token chunks, "
        f"48 tokens, {wall:.2f} s wall, decode {rate:.1f} tok/s, "
        f"decode launches {da.LAUNCHES.count}, flash launches {fa.LAUNCHES.count}")


# The int8 decode's two launches before it became one (a partial kernel and
# a merge kernel): no profile may show them.
OLD_DECODE_SYMBOLS = ("decode_partial_q8_kernel", "decode_merge_kernel")


def check_one_launch_per_step(ours: dict, kernel: str, other: str, counter, n_layers: int,
                              label: str) -> None:
    """The profiled generate ran ``kernel`` once per (layer, decode step):
    as many launches as its wrapper counted, a whole number of steps, and
    none of ``other`` or of the old two-launch symbols."""
    n = ours[kernel][1]
    if (n != counter.count or n <= 0 or n % n_layers or ours[other][1] != 0
            or any(ours[s][1] for s in OLD_DECODE_SYMBOLS)):
        raise AssertionError(f"{label}: {ours}, wrapper launches {counter.count}")
    log(f"  {label}: {n} {kernel} launches = {n // n_layers} decode steps x {n_layers} layers, "
        f"one per call, no {other} or {'/'.join(OLD_DECODE_SYMBOLS)}")


def profile_decode(torch, engine, label: str = "profile", run=None, counter=None,
                   export: str = None, stats: dict = None) -> dict:
    """Where the time goes: torch.profiler over ``run()`` (by default one
    llama-3-8b generate, 350-token prompt, 48 tokens), run once before to
    warm; device busy share of the wall, the kernels with the most device
    time, and the sums of the matmul (GEMM/GEMV) kernels and of the copy
    kernels (which carry the int8 → bf16 weight conversion of the plain
    int8-weight matmul). Returns the port's kernels' (device ms, launches)
    by name, or {} when the profiler saw no device time. ``counter``, when
    given, is set to 0 just before the profiled run, so it holds that run's
    wrapper launches; ``export``, a path for the window's Chrome trace;
    ``stats`` gets the window's ``wall_ms`` and ``busy_ms``."""
    from torch.profiler import ProfilerActivity, profile

    from llm_consensus_tpu_torch.engine import SamplingParams

    if run is None:
        ids = engine.tokenizer.encode(PROMPT)
        sp = SamplingParams(max_new_tokens=48, ignore_eos=True)

        def run():
            engine.generate_ids(ids, sp)

    run()  # warm
    torch.cuda.synchronize()
    if counter is not None:
        counter.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # Kernel rows only: an operator row repeats the device time of the
    # kernels it launched.
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", "")) and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if export is not None:
        prof.export_chrome_trace(export)
    if stats is not None:
        stats.update(wall_ms=wall_ms, busy_ms=busy_ms)
    if busy_ms == 0:
        log(f"{label}: torch.profiler captured no device time (not measured)")
        return {}
    log(f"{label} (under torch.profiler): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall)")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    ours = {
        name: (sum(dev_us(e) for e in events if name in e.key) / 1e3,
               sum(e.count for e in events if name in e.key))
        for name in ("flash_prefill_kernel", "decode_bf16_kernel", "decode_q8_kernel",
                     *OLD_DECODE_SYMBOLS)
    }
    log("  port kernels: " + ", ".join(f"{k} {ms:.2f} ms in {n} launches"
                                       for k, (ms, n) in ours.items()))
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log("  host (self CPU time): " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms/{e.count}" for e in host))
    matmul = sum(dev_us(e) for e in events
                 if any(t in e.key.lower() for t in ("gemm", "nvjet", "gemv", "cutlass")))
    copies = sum(dev_us(e) for e in events if "copy" in e.key.lower())
    log(f"  matmul kernels {matmul / 1e3:.2f} ms, copy kernels {copies / 1e3:.2f} ms, "
        f"other {(busy_ms * 1e3 - matmul - copies) / 1e3:.2f} ms of device time")
    return ours


def run_long_context(torch, fa, da, seed: int) -> int:
    """llama-3.1-8b, int8 weights and the int8 cache at the full 131,072
    slots: an 8,000-token prompt through chunked prefill, then 64 decoded
    tokens (the int8 decode kernel at a frontier near 8k). Four chunks of
    16 tokens give the engine's decode clock (first to last fetch) three
    chunks to time."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.models import get_config

    cfg = get_config("llama-3.1-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = Engine(cfg, quant="int8", kv_quant="int8", seed=seed)
    build_s = time.monotonic() - t0
    check_devices(engine)
    slots = engine.max_seq
    codes = 2 * cfg.n_layers * slots * cfg.n_kv_heads * cfg.head_dim
    cache_gb = (codes + 2 * cfg.n_layers * slots * cfg.n_kv_heads * 2) / 1e9
    gen = torch.Generator().manual_seed(seed)
    ids = [engine.tokenizer.bos_id] + torch.randint(32, 127, (7999,), generator=gen).tolist()
    counters = (fa.LAUNCHES, da.LAUNCHES, da.LAUNCHES_INT8)
    for c in counters:
        c.reset()
    t0 = time.monotonic()
    res = engine.generate_ids(ids, SamplingParams(max_new_tokens=64, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = da.LAUNCHES_INT8.count
    if (res.prompt_tokens != 8000 or len(res.token_ids) != 64 or launches <= 0
            or fa.LAUNCHES.count or da.LAUNCHES.count or res.decode_s <= 0):
        raise AssertionError(
            f"long context: {res.prompt_tokens} prompt, {len(res.token_ids)} generated, "
            f"launches flash {fa.LAUNCHES.count} decode bf16 {da.LAUNCHES.count} "
            f"int8 {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rate = res.decode_tokens / res.decode_s
    log(f"long context: {cfg.name} int8 weights + int8 KV at {slots} slots (cache "
        f"{cache_gb:.2f} GB int8 vs {codes * 2 / 1e9:.2f} GB bf16), build {build_s:.2f} s; "
        f"{res.prompt_tokens}-token prompt in {engine.prefill_chunk}-token chunks + 64 tokens "
        f"in {wall:.2f} s wall, decode {rate:.1f} tok/s ({res.decode_tokens} tokens in "
        f"{res.decode_s:.3f} s by the engine's clock), int8 decode launches {launches}, "
        f"peak device memory {peak_gb:.2f} GB")
    del engine
    release_memory(torch)
    return launches


def run_engine_phase(torch, fa, da, label: str, counter, seed: int, **modes) -> int:
    """One llama-3-8b generate (350-token prompt, 48 tokens) with ``modes``;
    returns the launches of ``counter`` in it."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.models import get_config

    t0 = time.monotonic()
    engine = Engine(get_config("llama-3-8b"), seed=seed, **modes)
    build_s = time.monotonic() - t0
    check_devices(engine)
    ids = engine.tokenizer.encode(PROMPT)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.reset()
    counter.reset()
    t0 = time.monotonic()
    res = engine.generate_ids(ids, SamplingParams(max_new_tokens=48, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counter.count
    if len(res.token_ids) != 48 or launches <= 0 or fa.LAUNCHES.count <= 0:
        raise AssertionError(f"{label}: {len(res.token_ids)} generated, launches "
                             f"{launches}, flash {fa.LAUNCHES.count}")
    rate = res.decode_tokens / res.decode_s if res.decode_s > 0 else float("nan")
    log(f"{label}: llama-3-8b {modes}, build {build_s:.2f} s, {res.prompt_tokens}-token "
        f"prompt + 48 tokens in {wall:.2f} s wall, decode {rate:.1f} tok/s, decode "
        f"launches {launches}, flash launches {fa.LAUNCHES.count}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del engine
    release_memory(torch)
    return launches


# -- phase 8: the batched slice -------------------------------------------------

SUFFIXES = [f" Answer as panelist {i} of four, in one short paragraph with numbers."
            for i in range(4)]
UNRELATED = "Name three prime numbers."


def run_batched_slice(torch, fa, da, single_responses: list) -> dict:
    """The CLI run with 4 x llama-3-8b and a llama-3-8b judge under
    LLMC_MAX_BATCH=4: every answer comes from the one batcher, the panel's
    shared prompt is established as its prefix, and the panel decodes
    through the state kernel."""
    sl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                           "decode_attention_state": da.LAUNCHES_STATE},
                   {"LLMC_MAX_BATCH": "4"}, "batched slice",
                   models=",".join(["gpu:llama-3-8b"] * 4))
    stats = sl["provider"].batcher_stats()
    snap = stats.get("llama-3-8b", {})
    launches = sl["launches"]
    rate = snap["decode_tokens"] / snap["decode_s"] if snap.get("decode_s") else float("nan")
    log(f"batched slice: batcher {snap}; pool decode {rate:.1f} tokens/s "
        f"({snap.get('decode_tokens')} tokens in {snap.get('decode_s', 0):.3f} s of pure decode "
        f"intervals)")
    single = [r for r in single_responses if r["model"] == "gpu:llama-3-8b"]
    for label, resps in (("batched", sl["responses"]), ("single-stream", single)):
        rates = [r["tokens"] / (r["latency_ms"] / 1e3) for r in resps]
        log(f"  {label} llama-3-8b panel answers: {len(rates)}, tokens/s over each request "
            f"{[round(x, 2) for x in rates]}, decode tokens/s "
            f"{[r.get('tokens_per_sec') for r in resps]}")
    # Every panel answer and the judge's through the batcher; the panel
    # shared its prompt and decoded through the state kernel, the judge
    # (admitted alone, no prefix) through the bf16 kernel without state.
    if (list(stats) != ["llama-3-8b"] or snap["admitted"] != 5
            or snap["establish_tokens"] < 192 or launches["decode_attention_state"] <= 0
            or launches["decode_attention"] <= launches["decode_attention_state"]
            or launches["flash_attention"] <= 0):
        raise AssertionError(f"batched slice: stats {stats}, launches {launches}")
    sl["pool_rate"] = rate
    return sl


def check_batch_logits(torch, engine, prompts_ids: list, p: int) -> None:
    """The batcher's admission and first decode step against the
    single-stream engine on the same prompts: the suffix prefill's last
    logits (prefix merge, the plain op) and one decode step over the spliced
    rows (the state kernel at B = 4, merged with the shared prefix), both
    within BATCH_LOGIT_TOL of the single-stream logits."""
    from llm_consensus_tpu_torch.engine.batcher import extract_prefix, splice_rows
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    dev = engine.device
    k = len(prompts_ids)
    with torch.inference_mode():
        first, step, toks = [], [], []
        for ids in prompts_ids:
            lg, cache = engine._prefill_ids(ids)
            tok = lg.argmax(dim=-1)
            n = len(ids)
            lg1, _ = engine._forward(tok[:, None], cache,
                                     torch.full((), n, dtype=torch.int32, device=dev),
                                     attn_impl="flash", kv_width=engine._decode_width(n + 1))
            first.append(lg[0])
            step.append(lg1[0, -1])
            toks.append(tok)
        _, pcache = engine._prefill_ids(prompts_ids[0][:p])
        prefix = extract_prefix(pcache, -(-p // 128) * 128)
        sfx = [ids[p:] for ids in prompts_ids]
        lg_b, scache, width = engine._prefill_rows_suffix(sfx, prefix, p)
        pos = max(len(x) for x in sfx)
        pool = init_kv_cache(engine.cfg, k, 512, device=dev, dtype=engine.dtype)
        dsts = [pos - len(x) for x in sfx]
        splice_rows(pool, scache, range(k), range(k), dsts, width)
        lg1_b, _ = engine._forward(
            torch.cat(toks)[:, None], pool, torch.full((), pos, dtype=torch.int32, device=dev),
            attn_impl="flash", kv_width=engine._decode_width(pos + 1),
            row_start=engine.to_device(dsts, torch.int32), prefix=prefix, prefix_len=p,
            prefix_rows=torch.ones(k, dtype=torch.bool, device=dev))
        first_s, step_s = torch.stack(first), torch.stack(step)
        err0 = max_err(lg_b, first_s)
        err1 = max_err(lg1_b[:, -1], step_s)
        same = (lg1_b[:, -1].argmax(-1) == step_s.argmax(-1)).sum().item()
    log(f"batch logits: {k} rows sharing a {p}-token prefix, suffix prefill last logits max "
        f"|diff| {err0:.3e}, first decode step (state kernel + merge) {err1:.3e} (tol "
        f"{BATCH_LOGIT_TOL}; logit std {step_s.float().std().item():.3f}); greedy tokens of "
        f"that step equal in {same}/{k} rows")
    if not (err0 <= BATCH_LOGIT_TOL and err1 <= BATCH_LOGIT_TOL):
        raise AssertionError(f"batched logits: prefill {err0}, decode {err1}")

    # Where a batched decode step's time goes: the engine's decode chunk
    # alone (no batcher), wall per step over 32 steps after a warm chunk.
    rows = {"row_start": engine.to_device(dsts, torch.int32)}
    shared = {**rows, "prefix": prefix, "prefix_len": p,
              "prefix_rows": torch.ones(k, dtype=torch.bool, device=dev)}

    def step_ms(token, kv, pos0, **kw):
        with torch.inference_mode():
            width = engine._decode_width(pos0 + 48)
            start = torch.full((), pos0, dtype=torch.int32, device=dev)
            token, _, start = engine._decode_chunk(token, start, kv, 16, None, (0.0, None, None),
                                                   width, **kw)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            engine._decode_chunk(token, start, kv, 32, None, (0.0, None, None), width, **kw)
            torch.cuda.synchronize()
            return (time.monotonic() - t0) * 1e3 / 32

    on_thread = {}
    worker = threading.Thread(target=lambda: on_thread.update(
        ms=step_ms(torch.cat(toks), pool, pos, **shared)))
    times = {
        "B=1, one stream": step_ms(toks[-1], cache, len(prompts_ids[-1])),
        "B=4, row starts": step_ms(torch.cat(toks), pool, pos, **rows),
        "B=4, row starts + prefix": step_ms(torch.cat(toks), pool, pos, **shared),
    }
    worker.start()
    worker.join()
    times["B=4, row starts + prefix, second thread"] = on_thread["ms"]
    log("decode step wall (host launches + device, ms per step): "
        + ", ".join(f"{name} {ms:.2f}" for name, ms in times.items()))


def token_agreement(got: list, ref: list) -> int:
    """Leading tokens two greedy streams share."""
    n = 0
    for a, b in zip(got, ref):
        if a != b:
            break
        n += 1
    return n


def run_batched_engine(torch, fa, da, engine, state_recs: dict) -> None:
    """The batcher on llama-3-8b, driven directly."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    prompts = [PROMPT + sfx for sfx in SUFFIXES]
    ids = [tok.encode(p) for p in prompts]
    p = len(tok.encode(PROMPT))
    check_batch_logits(torch, engine, ids, p)
    s = SamplingParams(max_new_tokens=64, ignore_eos=True)

    def counted(b, submit, counters):
        for c in counters:
            c.reset()
        t0 = time.monotonic()
        results = submit(b)
        torch.cuda.synchronize()
        return results, time.monotonic() - t0, [c.count for c in counters]

    # A shared-prefix wave, with an unrelated prompt admitted beside it.
    def shared_wave(b):
        futs = [b.submit(pr, s) for pr in prompts]
        while not any(st is not None and st.out_ids for st in list(b._slots)):
            time.sleep(0.002)
        futs.append(b.submit(UNRELATED, s))
        return [f.result(timeout=600) for f in futs]

    b = ContinuousBatcher(engine, max_batch=5)
    try:
        results, wall, (state_n, bf16_n, flash_n) = counted(
            b, shared_wave, (da.LAUNCHES_STATE, da.LAUNCHES, fa.LAUNCHES))
        snap = b.snapshot()
    finally:
        b.close()
    agree = [token_agreement(r.token_ids, engine.generate(pr, s).token_ids)
             for pr, r in zip(prompts + [UNRELATED], results)]
    log(f"batched engine, shared prefix: {len(results)} streams x 64 tokens in {wall:.2f} s, "
        f"stats {snap}, pool decode {snap['decode_tokens'] / snap['decode_s']:.1f} tokens/s; "
        f"launches state {state_n}, bf16 decode {bf16_n} (state ones included), flash "
        f"{flash_n}; leading tokens equal to the single-stream engine's {agree} (of 64)")
    # Every decode step ran with the prefix: no bf16 launch without state.
    if (state_n <= 0 or bf16_n != state_n or snap["establish_tokens"] < 192
            or any(len(r.token_ids) != 64 for r in results)):
        raise AssertionError(f"batched engine shared wave: {snap}, state {state_n}, "
                             f"bf16 {bf16_n}")

    # Where a shared-prefix wave's time goes (4 streams x 48 tokens).
    s48 = SamplingParams(max_new_tokens=48, ignore_eos=True)
    b = ContinuousBatcher(engine, max_batch=4)
    try:
        profile_decode(torch, engine, "profile batched shared prefix", run=lambda: [
            f.result(timeout=600) for f in [b.submit(pr, s48) for pr in prompts]])
    finally:
        b.close()

    # A wave of 4 unrelated prompts: full-prompt admission, flash at B = 4.
    gen = torch.Generator().manual_seed(5)
    unrelated = [[tok.bos_id] + torch.randint(32, 127, (n,), generator=gen).tolist()
                 for n in (120, 200, 260, 333)]

    def unrelated_wave(b):
        futs = [b.submit_ids(x, s) for x in unrelated]
        return [f.result(timeout=600) for f in futs]

    b = ContinuousBatcher(engine, max_batch=4)
    try:
        results, wall, (state_n, plain_n, flash_n) = counted(
            b, unrelated_wave, (da.LAUNCHES_STATE, da.LAUNCHES, fa.LAUNCHES))
        snap = b.snapshot()
    finally:
        b.close()
    agree = [token_agreement(r.token_ids, engine.generate_ids(x, s).token_ids)
             for x, r in zip(unrelated, results)]
    log(f"batched engine, 4 unrelated prompts: {wall:.2f} s, stats {snap}, launches flash "
        f"{flash_n} (one wave at B = 4: {engine.cfg.n_layers}), plain decode {plain_n}, state "
        f"{state_n}; leading tokens equal to single-stream {agree}")
    if flash_n != engine.cfg.n_layers or plain_n <= 0 or state_n != 0 or snap["admitted"] != 4:
        raise AssertionError(f"unrelated wave: flash {flash_n}, plain {plain_n}, state {state_n}")

    # Short int8-KV and W8A8 shared-prefix runs on the same weights.
    s16 = SamplingParams(max_new_tokens=16, ignore_eos=True)
    for key, counter, modes in (("int8", da.LAUNCHES_INT8, {}),
                                ("w8a8", da.LAUNCHES_W8A8, {"decode_w8a8": True})):
        eng8 = Engine(engine.cfg, params=engine.params, kv_quant="int8", **modes)
        b = ContinuousBatcher(eng8, max_batch=4)
        try:
            results, wall, (state_n, variant_n) = counted(
                b, lambda b: [f.result(timeout=600) for f in
                              [b.submit(pr, s16) for pr in prompts]],
                (da.LAUNCHES_STATE, counter))
            snap = b.snapshot()
        finally:
            b.close()
        log(f"batched engine, int8 KV{' + W8A8 scores' if modes else ''}: {wall:.2f} s, "
            f"prefix {snap['establish_tokens']}, state launches {state_n}, {key} launches "
            f"{variant_n}")
        if state_n <= 0 or variant_n < state_n or snap["establish_tokens"] < 192:
            raise AssertionError(f"batched {key}: state {state_n}, {key} {variant_n}")
        state_recs[key]["launches"] = state_n
        del eng8
    release_memory(torch)


# -- the telemetry phase ----------------------------------------------------------

# No roofline share may read above the card's peak by more than this
# (the walls are stream intervals, so a share over 1 would mean the
# intervals undercount the device work).
SHARE_MAX = 1.05
RUN_FILES = ["consensus.md", "metrics.json", "panel", "prompt.txt", "result.json", "run.json",
             "trace.json"]
METRICS_KEYS = {"counters", "events", "models", "live", "attrib", "roofline"}


def fresh_planes() -> None:
    """Drop the shared providers and forget the telemetry planes: the next
    CLI run installs the planes from the environment again (on by default)
    and builds providers and engines that bind them."""
    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    for provider in GPUProvider._shared.values():
        provider.release()
    GPUProvider._shared.clear()
    obs.reset_planes()


def check_run_telemetry(sl: dict, label: str, spans: set, batcher_spans: set = frozenset()):
    """The run directory of an ``--events`` run: the JAX CLI's listing,
    metrics.json's blocks, the trace's spans and roofline counters."""
    files = sl["files"]
    if files.get("listing") != RUN_FILES:
        raise AssertionError(f"{label}: run directory {files.get('listing')}")
    metrics, trace = files["metrics.json"], files["trace.json"]
    if not METRICS_KEYS <= set(metrics):
        raise AssertionError(f"{label}: metrics.json keys {list(metrics)}")
    tids = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e["name"] == "thread_name"}
    rows = {(e["name"], tids[e["tid"]]) for e in trace["traceEvents"] if e["ph"] == "X"}
    names = {n for n, _ in rows}
    counters = {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"}
    want_c = {f"roofline_{k}/{f}" for k in ("flops", "bytes") for f in ("decode", "prefill")}
    if (not spans <= names or not batcher_spans <= {n for n, t in rows if t == "batcher"}
            or counters != want_c):
        raise AssertionError(f"{label}: trace spans {sorted(rows)}, counters {sorted(counters)}")
    kinds = {}
    for e in trace["traceEvents"]:
        kinds[e["ph"], e["name"]] = kinds.get((e["ph"], e["name"]), 0) + 1
    log(f"  {label}: run dir {files['listing']}; metrics.json {list(metrics)}; trace events "
        + ", ".join(f"{ph} {n} x{c}" for (ph, n), c in sorted(kinds.items())))
    return metrics


def check_roofline(metrics: dict, responses: list, label: str) -> None:
    """Every family's shares at or under SHARE_MAX, decode memory-bound, the
    cross-check ok; prints each family's rates and shares beside the
    responses' own MBU."""
    rl = metrics["roofline"]
    log(f"  {label} roofline: ridge {rl['ridge_flops_per_byte']} FLOP/B ({rl['ridge_source']}), "
        f"peaks {rl['peak_flops_per_s']} FLOP/s {rl['peak_bytes_per_s']} B/s, coverage "
        f"{rl['coverage']}")
    for fam, f in rl["families"].items():
        shares = (f.get("mfu_vs_peak"), f.get("mbu_vs_peak"))
        log(f"    {fam}: {f['programs']} programs, {f['dispatches']} dispatches, "
            f"{f['tokens']} tokens, wall {f['wall_s']} s, {f['flops']:.6g} FLOP, "
            f"{f['bytes']:.6g} B, intensity {f['intensity']:.6g} FLOP/B, {f['verdict']}, "
            f"achieved {f['achieved_flops_per_s']:.6g} FLOP/s {f['achieved_bytes_per_s']:.6g} "
            f"B/s, mfu_vs_peak {shares[0]}, mbu_vs_peak {shares[1]}")
        if any(v is None or v > SHARE_MAX for v in shares):
            raise AssertionError(f"{label}: {fam} shares {shares} (limit {SHARE_MAX})")
    if rl["families"]["decode"]["verdict"] != "memory_bound":
        raise AssertionError(f"{label}: decode verdict {rl['families']['decode']['verdict']}")
    for fam, c in rl["crosscheck"].items():
        log(f"    crosscheck {fam}: {c}")
    if not rl["crosscheck"] or not all(c["ok"] for c in rl["crosscheck"].values()):
        raise AssertionError(f"{label}: crosscheck {rl['crosscheck']}")
    log(f"    responses' own decode MBU: "
        + ", ".join(f"{r['model']} {r.get('mbu')}" for r in responses))
    att = metrics["attrib"]
    log(f"  {label} attrib: device_s {att['device_s']}, dispatches {att['dispatches']}, "
        f"tokens {att['tokens']}, gap_s {att['gap_s']} in {att['gaps']} gaps, compiles "
        f"{att['compiles']}")


def check_attrib_against_profiler(torch, engine) -> None:
    """One llama-3-8b generate inside profile_decode's window with the
    ledger bound: the ledger's decode device_s holds every decode kernel's
    time and fits in the window's wall."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    led = engine._attrib
    ids = engine.tokenizer.encode(PROMPT)
    sp = SamplingParams(max_new_tokens=48, ignore_eos=True)
    marks = []

    def run():
        marks.append(led.snapshot()["device_s"].get("decode", 0.0))
        engine.generate_ids(ids, sp)

    stats: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        path = os.path.join(tmp, "trace.json")
        profile_decode(torch, engine, "attribution profile", run=run, export=path, stats=stats)
        if not stats:
            log("attribution profile: no device time in the profiler (not measured)")
            return
        with open(path, encoding="utf-8") as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    decode_s = led.snapshot()["device_s"]["decode"] - marks[-1]
    prefill_end = max(e["ts"] + e["dur"] for e in kernels if "flash_prefill" in e["name"])
    decode_kernels_s = sum(e["dur"] for e in kernels if e["ts"] >= prefill_end) / 1e6
    wall_s = stats["wall_ms"] / 1e3
    log(f"attribution vs profiler: ledger decode device_s {decode_s:.6f} s, the decode "
        f"window's kernels {decode_kernels_s:.6f} s (ratio {decode_s / decode_kernels_s:.4f}), "
        f"window wall {wall_s:.6f} s; kernels / ledger = {decode_kernels_s / decode_s:.4f} "
        f"(the profiler's busy share of the ledger's decode interval)")
    if not decode_kernels_s <= decode_s <= wall_s:
        raise AssertionError(f"attribution: decode {decode_s} s against kernels "
                             f"{decode_kernels_s} s and wall {wall_s} s")


def check_capture_walls(torch, engine) -> None:
    """One llama-3-8b generate on keys the run has not met (the prompt cut
    to 200 tokens: a new prefill bucket and decode width), then the same
    generate again: the first runs each key's roofline capture, the second
    none. Prints the device time each booked per family beside the
    captures' counting time, which the intervals leave out."""
    from llm_consensus_tpu_torch.engine import SamplingParams

    led, rl = engine._attrib, engine._roofline
    ids = engine.tokenizer.encode(PROMPT)[:200]
    sp = SamplingParams(max_new_tokens=48, ignore_eos=True)
    arms = []
    for arm in ("captured", "uncaptured"):
        before, n0, held0 = led.snapshot()["device_s"], rl.captures, rl.capture_s
        engine.generate_ids(ids, sp)
        torch.cuda.synchronize()
        after = led.snapshot()["device_s"]
        booked = {f: after[f] - before.get(f, 0.0) for f in ("prefill", "decode")}
        arms.append(rl.captures - n0)
        log(f"capture walls, {arm}: prefill {booked['prefill']:.6f} s, decode "
            f"{booked['decode']:.6f} s booked; {rl.captures - n0} keys counted in "
            f"{(rl.capture_s - held0) * 1e3:.3f} ms of host time")
    if arms[0] == 0 or arms[1] != 0:
        raise AssertionError(f"capture walls: keys counted per generate {arms}")


# The slice's CLI in a fresh process: stderr's last line is the import
# and main() walls.
_FRESH_CLI = (
    "import json, sys, time\n"
    "t0 = time.monotonic()\n"
    "import torch\n"
    "from llm_consensus_tpu_torch.cli.main import main\n"
    "t1 = time.monotonic()\n"
    "rc = main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "print(json.dumps({'rc': rc, 'import_s': t1 - t0, 'main_s': time.monotonic() - t1}),\n"
    "      file=sys.stderr)\n"
)
PLANES_OFF = {"LLMC_LIVE": "0", "LLMC_ATTRIB": "0", "LLMC_ROOFLINE": "0", "LLMC_BLACKBOX": "0"}


def measure_fresh_cli_walls() -> None:
    """The slice's CLI run, auto-saved as a user runs it, each time in a
    fresh process, with the planes on (the default) and off (every plane's
    knob at 0), one of each: the process wall and main()'s own wall. The
    planes-on run writes metrics.json, the other does not."""
    repo = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items() if not k.startswith("LLMC_")}
    base["LLMC_CONFIG"] = "0"  # no ambient config file changes the slice
    walls: dict = {"on": [], "off": []}
    for arm in ("on", "off"):
        env = {**base, **(PLANES_OFF if arm == "off" else {})}
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as data_dir:
            argv = ["--models", "gpu:llama-3-8b,gpu:consensus-1b", "--judge", "gpu:llama-3-8b",
                    "--max-tokens", "64", "--data-dir", data_dir, PROMPT]
            t0 = time.monotonic()
            proc = subprocess.run([sys.executable, "-c", _FRESH_CLI, *argv], env=env, cwd=repo,
                                  capture_output=True, text=True, timeout=600)
            wall = time.monotonic() - t0
            lines = proc.stderr.strip().splitlines()
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"fresh CLI ({arm}): exit {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            rec = json.loads(lines[-1])
            (run_id,) = os.listdir(data_dir)
            listing = sorted(os.listdir(os.path.join(data_dir, run_id)))
        if rec["rc"] != 0 or ("metrics.json" in listing) != (arm == "on"):
            raise AssertionError(f"fresh CLI ({arm}): {rec}, run directory {listing}")
        walls[arm].append((wall, rec["main_s"]))
        log(f"fresh CLI, planes {arm}: process {wall:.3f} s, import {rec['import_s']:.3f} s, "
            f"main() {rec['main_s']:.3f} s; run directory {listing}")
    for arm, runs in walls.items():
        log(f"fresh CLI, planes {arm}: main() " + ", ".join(f"{m:.3f}" for _, m in runs)
            + " s; process " + ", ".join(f"{w:.3f}" for w, _ in runs) + " s")


def measure_overhead(torch, engine) -> None:
    """The same llama-3-8b generate with every plane bound and with none,
    in turns (off, on, on, off): both decode rates, the host time inside
    telemetry code per decode chunk, and the synchronizations per chunk,
    which must not differ."""
    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine import engine as engine_mod

    planes = (engine._obs, engine._attrib, engine._roofline)
    if any(p is None for p in planes):
        raise AssertionError(f"overhead: the engine bound {planes}")
    host_ns = [0]
    depth = threading.local()
    hooks = [(obs.Recorder, "complete"), (obs.Recorder, "count"),
             (obs.attrib.ChipTimeLedger, "observe_device"),
             (obs.attrib.ChipTimeLedger, "token_event"),
             (obs.roofline.RooflineLedger, "dispatch"), (obs.live.LiveMetrics, "observe"),
             (engine_mod.DeviceWall, "__init__"), (engine_mod.DeviceWall, "stop"),
             (engine_mod.DeviceWall, "seconds")]

    def timed(fn):
        def wrapper(*a, **kw):
            if getattr(depth, "n", 0):
                return fn(*a, **kw)
            depth.n = 1
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                host_ns[0] += time.perf_counter_ns() - t0
                depth.n = 0
        return wrapper

    syncs = [0]

    def counted(fn):
        def wrapper(*a, **kw):
            syncs[0] += 1
            return fn(*a, **kw)
        return wrapper

    chunks = [0]
    decode_chunk = engine._decode_chunk

    def chunk(*a, **kw):
        chunks[0] += 1
        return decode_chunk(*a, **kw)

    originals = [(cls, name, cls.__dict__[name]) for cls, name in hooks]
    sync_orig = (torch.cuda.synchronize, torch.cuda.Event.synchronize)
    ids = engine.tokenizer.encode(PROMPT)
    sp = SamplingParams(max_new_tokens=128, ignore_eos=True)
    engine.generate_ids(ids, sp)  # warm: every key of this shape counted already
    arms = {"off": [], "on": []}
    try:
        for cls, name, fn in originals:
            setattr(cls, name, timed(fn))
        torch.cuda.synchronize = counted(sync_orig[0])
        torch.cuda.Event.synchronize = counted(sync_orig[1])
        engine._decode_chunk = chunk
        for arm in ("off", "on", "on", "off"):
            engine._obs, engine._attrib, engine._roofline = (
                planes if arm == "on" else (None, None, None))
            host_ns[0] = syncs[0] = chunks[0] = 0
            res = engine.generate_ids(ids, sp)
            arms[arm].append((res.decode_tokens / res.decode_s, host_ns[0], syncs[0], chunks[0]))
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)
        torch.cuda.synchronize, torch.cuda.Event.synchronize = sync_orig
        del engine._decode_chunk
        engine._obs, engine._attrib, engine._roofline = planes
    for arm, runs in arms.items():
        log(f"overhead, planes {arm}: decode "
            + ", ".join(f"{r:.2f}" for r, _, _, _ in runs) + " tok/s; host in telemetry "
            + ", ".join(f"{h / 1e3 / c:.1f}" for _, h, _, c in runs) + " us/chunk; syncs "
            + ", ".join(f"{sy}/{c}" for _, _, sy, c in runs) + " per chunks")
    per_chunk = {arm: {sy / c for _, _, sy, c in runs} for arm, runs in arms.items()}
    if len(per_chunk["on"] | per_chunk["off"]) != 1 or any(h for _, h, _, _ in arms["off"]):
        raise AssertionError(f"overhead: syncs per chunk {per_chunk}, off-arm host time "
                             f"{[h for _, h, _, _ in arms['off']]}")


def check_trace_and_profile(torch) -> None:
    """``--trace DIR`` and ``--profile``, each on a short consensus-1b CLI
    run: a complete artifact with the card's kernels in its Chrome trace,
    no ``.partial`` left."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        profiles = os.path.join(tmp, "profiles")
        saved = os.environ.get("LLMC_PROFILE_DIR")
        os.environ["LLMC_PROFILE_DIR"] = profiles
        fresh_planes()
        try:
            for flag in (["--trace", os.path.join(tmp, "trace")], ["--profile"]):
                out, err = io.StringIO(), io.StringIO()
                t0 = time.monotonic()
                rc = cli_main(["--models", "gpu:consensus-1b", "--judge", "gpu:consensus-1b",
                               "--max-tokens", "16", "--json", *flag, PROMPT], device=None,
                              stdout=out, stderr=err, install_signal_handlers=False)
                if rc != 0:
                    raise AssertionError(f"{flag[0]}: exit {rc}: {err.getvalue()}")
                if flag[0] == "--trace":
                    artifact = flag[1]
                else:
                    (name,) = os.listdir(profiles)
                    artifact = os.path.join(profiles, name)
                listing = sorted(os.listdir(artifact))
                with open(os.path.join(artifact, "trace.json"), encoding="utf-8") as f:
                    events = json.load(f)["traceEvents"]
                kernels = [e for e in events if e.get("cat") == "kernel"]
                port = sum(1 for e in kernels if "decode_bf16" in e["name"]
                           or "flash_prefill" in e["name"])
                log(f"{flag[0]}: {time.monotonic() - t0:.2f} s, artifact {artifact} {listing}, "
                    f"{len(events)} events, {len(kernels)} CUDA kernel events ({port} of the "
                    f"port's kernels)")
                if listing != ["trace.json"] or not kernels or artifact.endswith(".partial"):
                    raise AssertionError(f"{flag[0]}: artifact {artifact} {listing}")
        finally:
            if saved is None:
                os.environ.pop("LLMC_PROFILE_DIR", None)
            else:
                os.environ["LLMC_PROFILE_DIR"] = saved
            release_engines(torch, {})
            fresh_planes()


def run_telemetry(torch, fa, da) -> None:
    """The telemetry phase: full-width CLI runs with ``--events``, single
    stream and batched, their roofline, attribution against the profiler,
    the planes' host cost, ``--trace`` and ``--profile``, device memory."""
    from llm_consensus_tpu_torch.obs import roofline

    t_phase = time.monotonic()
    a = torch.ones(8, 8, device="cuda")
    a @ a  # the process's cuBLAS set-up, outside the timing below
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with roofline.RooflineLedger().dispatch("warm", ()):
        a @ a
    log(f"telemetry: the dispatch mode's first use in the process "
        f"{time.monotonic() - t0:.3f} s")

    fresh_planes()
    sl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES},
                   {}, "telemetry slice", events=True)
    if min(sl["launches"].values()) <= 0:
        raise AssertionError(f"telemetry slice launches {sl['launches']}")
    metrics = check_run_telemetry(sl, "telemetry slice",
                                  {"prefill", "decode", "fetch", "engine_stream", "worker"})
    check_roofline(metrics, sl["responses"], "telemetry slice")
    engine = sl["engines"]["llama-3-8b"]
    led = engine._roofline
    log(f"  roofline captures: {led.captures} keys counted in {led.capture_s:.4f} s of host "
        f"time ({led.capture_s / max(1, led.captures) * 1e3:.2f} ms each)")
    dev = metrics["attrib"]["hbm"].get("device")
    log(f"  device memory (attrib.hbm.device): {dev}; torch.cuda.max_memory_allocated over "
        f"the run {sl['peak_gb'] * 1e9:.0f} B")
    if (not dev or not dev["bytes_in_use"]
            or not 0 < dev["peak_bytes_in_use"] <= sl["peak_gb"] * 1e9 + 1):
        raise AssertionError(f"telemetry: device memory {dev}, peak {sl['peak_gb']} GB")
    check_attrib_against_profiler(torch, engine)
    check_capture_walls(torch, engine)
    measure_overhead(torch, engine)
    del engine, led
    modes = sl["modes"]
    del sl
    release_engines(torch, modes)

    fresh_planes()
    bsl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                            "decode_attention_state": da.LAUNCHES_STATE},
                    {"LLMC_MAX_BATCH": "4"}, "telemetry batched slice",
                    models=",".join(["gpu:llama-3-8b"] * 4), events=True)
    if min(bsl["launches"].values()) <= 0:
        raise AssertionError(f"telemetry batched slice launches {bsl['launches']}")
    metrics = check_run_telemetry(bsl, "telemetry batched slice", {"worker", "engine_stream"},
                                  {"admit", "decode", "fetch"})
    check_roofline(metrics, bsl["responses"], "telemetry batched slice")
    modes = bsl["modes"]
    del bsl
    release_engines(torch, modes)
    check_trace_and_profile(torch)
    measure_fresh_cli_walls()
    log(f"telemetry phase: {time.monotonic() - t_phase:.1f} s")


# -- the modes phase: the CLI's consensus modes at the slice's width ----------

MODES_PANEL = "gpu:llama-3-8b,gpu:consensus-1b"
MODES_JUDGE = "gpu:llama-3-8b"
# The vote run names a judge outside the panel, so that "no judge engine is
# built" reads directly in the provider's engines().
VOTE_JUDGE = "gpu:llama-3.1-8b"
SYSTEM_PROMPT = ("You are a storage and networking engineer. Give numbers, name the "
                 "risks, and keep the answer short.")
FOLLOW_UPS = ("How would the answer change if the link were 1 Gbit/s?",
              "Which risks remain with the option you chose?")
# The only warnings a run on random weights may carry: random text holds
# no vote and no grade. Any other warning (a failed round, grading or
# model) fails the phase, so a kernel error can never pass as one.
RANDOM_WEIGHT_WARNINGS = ("no recognizable vote in response",
                          "confidence grading returned an unparseable reply")


class GenerateLog:
    """Every ``Engine.generate`` while installed (a context manager):
    (preset, prompt tokens, layers, path), the path "flash" for a prompt the
    engine prefills in one shot (the flash kernel), "chunked" for one it
    prefills in chunks (the plain attention op). ``reset`` and ``count``
    make it a counter beside the kernels' LaunchCounters."""

    def __init__(self) -> None:
        self.calls: list = []
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self) -> "GenerateLog":
        from llm_consensus_tpu_torch.engine import engine as engine_mod

        orig = self._orig = engine_mod.Engine.generate
        calls, lock = self.calls, self._lock

        def generate(engine, *args, **kwargs):
            res = orig(engine, *args, **kwargs)
            n, chunk = res.prompt_tokens, engine.prefill_chunk
            chunked = bool(chunk) and n > chunk and -(-n // chunk) * chunk <= engine.max_seq
            with lock:
                calls.append((engine.cfg.name, n, engine.cfg.n_layers,
                              "chunked" if chunked else "flash"))
            return res

        engine_mod.Engine.generate = generate
        return self

    def __exit__(self, *exc) -> None:
        from llm_consensus_tpu_torch.engine import engine as engine_mod

        engine_mod.Engine.generate = self._orig

    def reset(self) -> None:
        with self._lock:
            self.calls.clear()

    @property
    def count(self) -> int:
        return len(self.calls)


def check_mode(label: str, run: dict, gens: GenerateLog, docs: list, generates: int,
               min_flash: int = 0) -> dict:
    """One mode's run: the generates it made, the decode kernel launched
    whenever a model ran, flash launched exactly for the prompts that fit
    one prefill chunk (one launch per layer), no failed model and no
    warning but a random-weight one. Returns the mode's row."""
    launches, calls = run["launches"], list(gens.calls)
    flash_layers = sum(layers for _, _, layers, path in calls if path == "flash")
    n_flash = sum(1 for c in calls if c[3] == "flash")
    for preset, n, _, path in sorted(calls, key=lambda c: (c[3], c[1])):
        log(f"  {label}: {preset} prompt of {n} tokens -> {path}")
    problems = []
    if len(calls) != generates:
        problems.append(f"{len(calls)} generates, expected {generates}")
    if calls and launches["decode_attention"] <= 0:
        problems.append("the bf16 decode kernel never launched")
    if launches["flash_attention"] != flash_layers or n_flash < min_flash:
        problems.append(f"flash launches {launches['flash_attention']} for {n_flash} one-shot "
                        f"prompts of {flash_layers} layers (at least {min_flash} expected)")
    for doc in docs:
        if doc.get("failed_models"):
            problems.append(f"failed models {doc['failed_models']}")
        problems += [f"warning {w!r}" for w in doc.get("warnings", [])
                     if not w.endswith(RANDOM_WEIGHT_WARNINGS)]
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    row = {"wall_s": run["wall_s"], "generates": len(calls),
           "decode_bf16_kernel": launches["decode_attention"],
           "flash_attention": launches["flash_attention"],
           "prompts_flash": n_flash, "prompts_chunked": len(calls) - n_flash,
           "longest_prompt_tokens": max((c[1] for c in calls), default=0),
           "peak_gb": run["peak_gb"]}
    log(f"{label}: {json.dumps(row)}")
    return row


def saved_runs(data_dir: str) -> list:
    """The run directories of ``data_dir`` in start order (run.json's mtime)."""
    dirs = [os.path.join(data_dir, d) for d in os.listdir(data_dir)]
    return [read_run_dir(d) for d in
            sorted(dirs, key=lambda d: os.stat(os.path.join(d, "run.json")).st_mtime_ns)]


def crash_run(data_dir: str, log_path: str) -> str:
    """The slice's CLI, auto-saved, in a child process killed with SIGKILL
    once its first panel answer lands in ``panel/``. Returns the run id."""
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "llm_consensus_tpu_torch", "--models", MODES_PANEL,
            "--judge", MODES_JUDGE, "--max-tokens", "64", "--data-dir", data_dir, PROMPT]
    landed, t0 = [], time.monotonic()
    with open(log_path, "w", encoding="utf-8") as child_log:
        child = subprocess.Popen(argv, cwd=repo, env={**os.environ, "LLMC_CONFIG": "0"},
                                 stdout=child_log, stderr=subprocess.STDOUT)
        try:
            while not landed and child.poll() is None and time.monotonic() - t0 < 300:
                time.sleep(0.01)
                for run_id in os.listdir(data_dir) if os.path.isdir(data_dir) else ():
                    panel = os.path.join(data_dir, run_id, "panel")
                    if os.path.isdir(panel):
                        landed = [n for n in os.listdir(panel) if n.startswith("000-")]
        finally:
            child.kill()
            child.wait(60)
    with open(log_path, encoding="utf-8") as f:
        tail = f.read()[-2000:]
    if not landed:
        raise AssertionError(f"crash run: no panel answer landed (exit {child.returncode}): "
                             f"{tail}")
    (run_id,) = os.listdir(data_dir)
    listing = sorted(os.listdir(os.path.join(data_dir, run_id)))
    log(f"crash run: child killed (exit {child.returncode}) {time.monotonic() - t0:.2f} s "
        f"after its start, once {landed[0]} landed; run directory {listing}")
    if "result.json" in listing:
        raise AssertionError("crash run: the child finished before it was killed")
    return run_id


def run_modes(torch, fa, da, card: str) -> dict:
    """The modes phase: each consensus mode of the CLI through the port's
    CLI in this process over warm shared providers (panel llama-3-8b +
    consensus-1b, judge llama-3-8b, bf16, random weights, the 350-token
    prompt, 64 new tokens), the crash case in a child process. Returns the
    rows of the ``{"modes": ...}`` line."""
    from llm_consensus_tpu_torch.cli.main import install_planes, load_panel_journal
    from llm_consensus_tpu_torch.engine.tokenizer import ByteTokenizer
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    t_phase = time.monotonic()
    gens = GenerateLog()
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "generates": gens}
    env = {"LLMC_CONFIG": "0"}
    slice_kw = {"models": MODES_PANEL, "judge": MODES_JUDGE}
    second = MODES_PANEL.split(",")[1].split(":", 1)[1]
    rows: dict = {}
    # Warm shared providers: the panel's engines are built before the first
    # mode, so no mode's wall holds a build. The telemetry planes are
    # installed first, as the CLI does, since engines bind them when built.
    install_planes(False, sys.stderr)
    t0 = time.monotonic()
    warm = GPUProvider.shared()
    for model in MODES_PANEL.split(","):
        warm._engine_for(model)
    torch.cuda.synchronize()
    log(f"modes: engines {sorted(warm.engines())} built in {time.monotonic() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-modes-") as tmp, gens:
        # 1. --rounds 2 --confidence --system-file: panel 2 x 2, judge 3.
        sysfile = os.path.join(tmp, "system.txt")
        with open(sysfile, "w", encoding="utf-8") as f:
            f.write(SYSTEM_PROMPT + "\n")
        saved = os.path.join(tmp, "saved")
        sl = run_slice(torch, counters, env, "modes: --rounds 2 --confidence", **slice_kw,
                       extra=("--rounds", "2", "--confidence", "--system-file", sysfile),
                       data_dir=saved, timing=False)
        manifest, doc = sl["files"]["run.json"], sl["doc"]
        if (manifest["rounds"], manifest["confidence"], manifest["system"]) != (
                2, True, SYSTEM_PROMPT):
            raise AssertionError(f"rounds: run.json {manifest}")
        if "confidence" not in doc and doc.get("warnings") != [RANDOM_WEIGHT_WARNINGS[1]]:
            raise AssertionError(f"rounds: confidence {doc.get('confidence')}, warnings "
                                 f"{doc.get('warnings')}")
        log(f"  rounds: confidence {doc.get('confidence')}, warnings {doc.get('warnings')}")
        rows["rounds"] = check_mode("rounds", sl, gens, [doc], 7, min_flash=2)
        first_run = os.path.basename(sl["files"]["run_dir"])

        # 2. --vote: the panel's 2 generates, no judge provider or engine.
        provider = sl["provider"]
        sl = run_slice(torch, counters, env, "modes: --vote", models=MODES_PANEL, judge=VOTE_JUDGE,
                       extra=("--vote", "--options", "A,B,C"), timing=False)
        judge_preset = VOTE_JUDGE.split(":", 1)[1]
        if sl["doc"]["judge"] != "vote" or judge_preset in provider.engines():
            raise AssertionError(f"vote: judge {sl['doc']['judge']}, engines "
                                 f"{sorted(provider.engines())}")
        log(f"  vote: {sl['doc']['consensus'].splitlines()[0]!r}; engines built "
            f"{sorted(provider.engines())} (no {judge_preset})")
        rows["vote"] = check_mode("vote", sl, gens, [sl["doc"]], 2)

        # 3. --continue the first run: the panel prompts carry its exchange.
        sl = run_slice(torch, counters, env, "modes: --continue", **slice_kw,
                       extra=("--continue", first_run), data_dir=saved,
                       prompt=FOLLOW_UPS[0], timing=False)
        history = sl["doc"].get("history", [])
        raw = len(ByteTokenizer().encode(FOLLOW_UPS[0]))
        panel_tokens = [n for preset, n, _, _ in gens.calls if preset == second]
        log(f"  continue: history {len(history)}; follow-up {raw} tokens, {second}'s "
            f"panel prompt {panel_tokens} tokens (+{[n - raw for n in panel_tokens]} of "
            f"history)")
        if len(history) != 1 or not panel_tokens or panel_tokens[0] < raw + len(PROMPT):
            raise AssertionError(f"continue: history {history}, panel prompt {panel_tokens}")
        rows["continue"] = check_mode("continue", sl, gens, [sl["doc"]], 3)

        # 4. --resume: a completed run less its result.json and one panel
        # answer reruns that answer and the judge, and ends as a fresh run.
        resume = os.path.join(tmp, "resume")
        sl = run_slice(torch, counters, env, "modes: a plain run, then --resume", **slice_kw,
                       data_dir=resume, timing=False)
        # The plain run: this call's baseline for every mode's wall, with the
        # JAX CLI's run directory (metrics.json included: the engines bound
        # the planes).
        rows["plain"] = check_mode("plain", sl, gens, [sl["doc"]], 3, min_flash=2)
        run_dir, fresh = sl["files"]["run_dir"], sl["files"]["listing"]
        if fresh != [name for name in RUN_FILES if name != "trace.json"]:
            raise AssertionError(f"plain run: run directory {fresh}")
        os.remove(os.path.join(run_dir, "result.json"))
        (answer,) = [n for n in os.listdir(os.path.join(run_dir, "panel"))
                     if n.endswith(f"_{second}.json")]
        os.remove(os.path.join(run_dir, "panel", answer))
        run = cli_call(torch, counters, env,
                       ["--data-dir", resume, "--resume", os.path.basename(run_dir)])
        files = read_run_dir(run_dir)
        if run["rc"] != 0 or files["listing"] != fresh or len(
                files["result.json"]["responses"]) != 2:
            raise AssertionError(f"resume: exit {run['rc']} {run['err'][-2000:]}; listing "
                                 f"{files['listing']} against a fresh run's {fresh}")
        log(f"  resume: exit 0 in {run['wall_s']:.2f} s; listing {files['listing']} = a "
            f"fresh run's; panel {sorted(os.listdir(os.path.join(run_dir, 'panel')))}")
        rows["resume"] = check_mode("resume", run, gens, [files["result.json"]], 2,
                                    min_flash=1)

        # 4b. A run SIGKILL'd after its first panel answer, finished by
        # --resume.
        crash = os.path.join(tmp, "crash")
        run_id = crash_run(crash, os.path.join(tmp, "child.log"))
        reused = len(load_panel_journal(os.path.join(crash, run_id)))
        run = cli_call(torch, counters, env, ["--data-dir", crash, "--resume", run_id])
        files = read_run_dir(os.path.join(crash, run_id))
        rerun = len(gens.calls) - 1  # less the judge's
        log(f"  crash resume: exit {run['rc']}, {reused} answers reused, {rerun} rerun; "
            f"listing {files['listing']}")
        if run["rc"] != 0 or reused + rerun != 2 or len(
                files.get("result.json", {}).get("responses", [])) != 2:
            raise AssertionError(f"crash resume: exit {run['rc']}, reused {reused}, rerun "
                                 f"{rerun}: {run['err'][-2000:]}")
        rows["resume_crash"] = check_mode("resume after SIGKILL", run, gens,
                                          [files["result.json"]], 1 + rerun)
        rows["resume_crash"].update(reused=reused, rerun=rerun)

        # 5. -i: two queries, drop consensus-1b, a third, /reset, /exit.
        session = os.path.join(tmp, "interactive")
        stdin = "\n".join([PROMPT, FOLLOW_UPS[0], f"/models -gpu:{second}",
                           FOLLOW_UPS[1], "/reset", "/exit"]) + "\n"
        run = cli_call(torch, counters, env,
                       ["--models", MODES_PANEL, "--judge", MODES_JUDGE, "--max-tokens",
                        "64", "--data-dir", session, "-i"], stdin=stdin)
        runs = saved_runs(session) if os.path.isdir(session) else []
        docs = [r.get("result.json", {}) for r in runs]
        shape = [(len(d.get("history", [])), len(d.get("responses", []))) for d in docs]
        log(f"  interactive: exit {run['rc']}, runs (history, responses) {shape}; stderr "
            f"{run['err'].strip()!r}")
        if (run["rc"] != 0 or "error:" in run["err"] or shape != [(0, 2), (1, 2), (2, 1)]
                or docs[2]["consensus"] != docs[2]["responses"][0]["content"]):
            raise AssertionError(f"interactive: exit {run['rc']}, runs {shape}: "
                                 f"{run['err'][-2000:]}")
        rows["interactive"] = check_mode("interactive", run, gens, docs, 7, min_flash=2)

        # 6. The config file through LLMC_CONFIG: an alias and rounds 2.
        config = os.path.join(tmp, "llm-consensus.json")
        with open(config, "w", encoding="utf-8") as f:
            json.dump({"aliases": {"@panel": MODES_PANEL}, "rounds": 2}, f)
        sl = run_slice(torch, counters, {"LLMC_CONFIG": config}, "modes: config file",
                       judge=MODES_JUDGE, models="@panel", n_models=2, data_dir=os.path.join(tmp, "config"),
                       timing=False)
        manifest = sl["files"]["run.json"]
        if manifest["models"] != MODES_PANEL.split(",") or manifest["rounds"] != 2:
            raise AssertionError(f"config: run.json {manifest}")
        rows["config"] = check_mode("config", sl, gens, [sl["doc"]], 6, min_flash=2)

        # 7. --version: no model runs.
        run = cli_call(torch, counters, env, ["--version"])
        log(f"  version: exit {run['rc']}, {run['out'].strip()!r}")
        if run["rc"] != 0 or not run["out"].startswith("llm-consensus-torch "):
            raise AssertionError(f"version: exit {run['rc']}: {run['out']} {run['err']}")
        rows["version"] = check_mode("version", run, gens, [], 0)
    log(f"modes phase: {time.monotonic() - t_phase:.1f} s")
    print(json.dumps({"modes": rows, "card": card}), flush=True)
    release_engines(torch, {})
    return rows


# -- phase 8c: prefix reuse, the overlapped judge, the retry ladder, a mixed panel --

SESSION_PANEL = "gpu:llama-3-8b,gpu:consensus-1b"
SESSION_JUDGE = "gpu:llama-3-8b"
REMOTE_MODEL = "gpt-5.2-2025-12-11"
REMOTE_ANSWER = ("Ship encrypted drives by courier: 400 TB over a 10 Gbit/s link takes "
                 "about four days at full rate, and the drives arrive in two.")
# The retry ladder's injected failures run on consensus-1b: a rebuild of it
# costs seconds, and its weights bound the check that the failed engine was
# freed before the new one allocated.
LADDER_MODEL = "gpu:consensus-1b"


def random_ids(torch, seed: int, n: int, bos=None) -> list:
    """``n`` printable byte tokens from ``seed`` (after ``bos`` when given)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(32, 127, (n,), generator=gen).tolist()
    return ([bos] if bos is not None else []) + ids


def cuda_ms(torch, fn) -> float:
    """Device-stream milliseconds of ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(torch, fn, n: int = 5) -> float:
    return sorted(cuda_ms(torch, fn) for _ in range(n))[n // 2]


def session_reuse(torch, provider, seed: int) -> dict:
    """(a) Prefix snapshot reuse on llama-3-8b: the 1,501-token prompt and
    48 tokens, then that prompt, its answer and a 200-token follow-up on an
    engine holding the snapshot and on a fresh one (both on the provider's
    weights): the reused length from the prefill span, the follow-up's
    prefill ms, the first-step logits, the greedy tokens, the peak memory;
    then a full-prompt wave of 4 rows sharing 1,100 tokens, with and without
    a snapshot to fork."""
    from llm_consensus_tpu_torch import obs
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams

    warm = provider._engine_for(SESSION_JUDGE)
    kw = dict(device=warm.device, max_seq=warm.max_seq, tokenizer=warm.tokenizer)
    rec, prev = obs.Recorder(), obs.recorder()
    obs.install(rec)  # the reusing engine binds it: its prefill spans say `reused`
    try:
        eng = Engine(warm.cfg, warm.params, **kw)
    finally:
        obs.install(prev)
    fresh = Engine(warm.cfg, warm.params, prefix_cache=False, **kw)
    for e in provider.engines().values():
        e.drop_prefix()
    s48 = SamplingParams(max_new_tokens=48, ignore_eos=True)
    ids = random_ids(torch, seed, 1500, bos=warm.tokenizer.bos_id)
    follow_up = random_ids(torch, seed + 1, 200)
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()

    first = eng.generate_ids(ids, s48)
    torch.cuda.synchronize()
    snapshot_gb = (torch.cuda.memory_allocated() - a0) / 1e9
    follow = ids + first.token_ids + follow_up
    reusable = eng._reusable_prefix(follow)[0]
    with torch.inference_mode():
        lg_reuse, _ = eng._prefill_ids(follow)
        lg_fresh, _ = fresh._prefill_ids(follow)
        logit_err = max_err(lg_reuse, lg_fresh)
        reuse_ms = median_ms(torch, lambda: eng._prefill_ids(follow))
        fresh_ms = median_ms(torch, lambda: fresh._prefill_ids(follow))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = eng.generate_ids(follow, s48)
    torch.cuda.synchronize()
    peak_with = torch.cuda.max_memory_allocated() / 1e9
    eng.drop_prefix()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = fresh.generate_ids(follow, s48)
    torch.cuda.synchronize()
    peak_without = torch.cuda.max_memory_allocated() / 1e9
    reused = [e.args["reused"] for e in rec.events() if e.name == "prefill"]
    same = sum(a == b for a, b in zip(got.token_ids, ref.token_ids))
    row = {"prompt_tokens": len(follow), "reused": reused[-1] if reused else None,
           "reusable": reusable, "follow_up_prefill_ms_reuse": reuse_ms,
           "follow_up_prefill_ms_fresh": fresh_ms, "first_logits_max_abs_diff": logit_err,
           "greedy_equal": same, "greedy_of": len(ref.token_ids),
           "leading_equal": token_agreement(got.token_ids, ref.token_ids),
           "snapshot_gb": snapshot_gb, "peak_gb_with_snapshot": peak_with,
           "peak_gb_without": peak_without}
    log(f"session reuse: prefill spans reused {reused}; follow-up of {len(follow)} tokens "
        f"prefilled in {reuse_ms:.2f} ms reusing {row['reused']} against {fresh_ms:.2f} ms "
        f"fresh (CUDA events, median of 5); first-step logits max |diff| {logit_err:.3e} "
        f"(tol {BATCH_LOGIT_TOL}); greedy tokens equal {same}/{len(ref.token_ids)} "
        f"({row['leading_equal']} leading); snapshot {snapshot_gb:.3f} GB; peak "
        f"{peak_with:.2f} GB with it, {peak_without:.2f} GB without")
    if not (row["reused"] is not None and row["reused"] >= 1501 and logit_err <= BATCH_LOGIT_TOL
            and len(got.token_ids) == 48):
        raise AssertionError(f"session reuse: {row}")

    # The batcher's full-prompt wave: 4 rows sharing 1,100 tokens (bucket
    # 2,048, four 512-token chunks); with a snapshot holding the shared
    # tokens the wave forks two chunks and prefills two.
    shared = ids[:1100]
    rows = [shared + random_ids(torch, seed + 2 + i, 40 + 8 * i) for i in range(4)]
    with torch.inference_mode():
        eng.generate_ids(shared + follow_up[:60], SamplingParams(max_new_tokens=16,
                                                                 ignore_eos=True))
        lg_fork, _, width = eng._prefill_rows(rows)  # retains row 0
        lg_plain, _, _ = fresh._prefill_rows(rows)
        wave_err = max_err(lg_fork, lg_plain)
        fork_ms = median_ms(torch, lambda: eng._prefill_rows(rows), 3)
        plain_ms = median_ms(torch, lambda: fresh._prefill_rows(rows), 3)
    row.update(wave_rows=4, wave_shared=len(shared), wave_width=width, wave_ms_fork=fork_ms,
               wave_ms_no_snapshot=plain_ms, wave_logits_max_abs_diff=wave_err)
    log(f"session wave: 4 rows sharing {len(shared)} tokens, width {width}: prefill "
        f"{fork_ms:.2f} ms forking the snapshot against {plain_ms:.2f} ms without (median of "
        f"3); last logits max |diff| {wave_err:.3e}")
    if wave_err > BATCH_LOGIT_TOL:
        raise AssertionError(f"session wave: logits {wave_err}")
    del eng, fresh
    release_memory(torch)
    return row


class JudgeClock:
    """While installed (a context manager), each CLI run's judge synthesis:
    the time from the panel's end (``Runner.run`` returning) to the judge's
    first token reaching the host (the decode loop's first fetch, whatever
    text the tokens make), the path (overlap or classic), the session's
    prefilled tokens and the overlap judge's fallbacks, and the judge
    prompt's tokens. ``reset`` starts a run."""

    def __init__(self, tokenizer) -> None:
        self.rows: list = []
        self._tok = tokenizer
        self._t_panel = None
        self._t_token = None
        self._local = threading.local()
        self._saved: list = []

    def reset(self) -> None:
        self.rows.clear()
        self._t_panel = self._t_token = None

    def __enter__(self) -> "JudgeClock":
        from llm_consensus_tpu_torch.consensus.judge import Judge, render_judge_prompt
        from llm_consensus_tpu_torch.consensus.overlap import OverlapJudge
        from llm_consensus_tpu_torch.engine.engine import Engine
        from llm_consensus_tpu_torch.runner.runner import Runner

        clock = self
        orig_run = Runner.run
        orig_decode = Engine._decode_stream

        def decode_stream(engine, prompt_ids, last_logits, cache, sampling, ctx, on_token,
                          *args, **kwargs):
            # Only the judge decodes once the panel has ended.
            if clock._t_panel is not None and clock._t_token is None:
                def first_token(tok_id, _inner=on_token):
                    if clock._t_token is None:
                        clock._t_token = time.monotonic()
                    if _inner is not None:
                        _inner(tok_id)

                return orig_decode(engine, prompt_ids, last_logits, cache, sampling, ctx,
                                   first_token, *args, **kwargs)
            return orig_decode(engine, prompt_ids, last_logits, cache, sampling, ctx, on_token,
                               *args, **kwargs)

        def run(runner, *args, **kwargs):
            res = orig_run(runner, *args, **kwargs)
            if clock._t_panel is None:
                clock._t_panel = time.monotonic()
            return res

        def wrap(orig, kind):
            def synthesize_stream(judge, ctx, prompt, responses, callback):
                if getattr(clock._local, "inside", False):  # the overlap judge's fallback
                    return orig(judge, ctx, prompt, responses, callback)
                clock._local.inside = True
                try:
                    return orig(judge, ctx, prompt, responses, callback)
                finally:
                    clock._local.inside = False
                    ttft = (clock._t_token - clock._t_panel
                            if clock._t_token is not None and clock._t_panel is not None
                            else None)
                    clock.rows.append({
                        "path": kind, "ttft_s": ttft,
                        "prefilled": getattr(judge, "prefilled", 0),
                        "fallbacks": getattr(judge, "fallbacks", 0),
                        "prompt_tokens": len(clock._tok.encode(
                            render_judge_prompt(prompt, responses)))})
            return synthesize_stream

        self._saved = [(Runner, "run", orig_run), (Engine, "_decode_stream", orig_decode),
                       (Judge, "synthesize_stream", Judge.synthesize_stream),
                       (OverlapJudge, "synthesize_stream", OverlapJudge.synthesize_stream)]
        Runner.run = run
        Engine._decode_stream = decode_stream
        Judge.synthesize_stream = wrap(Judge.synthesize_stream, "classic")
        OverlapJudge.synthesize_stream = wrap(OverlapJudge.synthesize_stream, "overlap")
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)


def session_overlap(torch, fa, da, provider) -> dict:
    """(b) The slice's CLI run with ``--judge-overlap`` and without, one of
    each: wall, the judge's time to first token after the panel's end, the
    session's prefilled tokens, the judge prompt's tokens; the overlap run
    must make no classic fallback."""
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    tok = provider._engine_for(SESSION_JUDGE).tokenizer
    runs = []
    with JudgeClock(tok) as clock:
        for overlap in (True, False):
            clock.reset()
            sl = run_slice(torch, counters, {}, f"session overlap={overlap}",
                           models=SESSION_PANEL, judge=SESSION_JUDGE, timing=False,
                           extra=("--judge-overlap",) if overlap else ())
            (judge,) = clock.rows
            run = {"overlap": overlap, "wall_s": sl["wall_s"], **judge,
                   "peak_gb": sl["peak_gb"], "launches": sl["launches"]}
            log(f"  judge: {json.dumps(run)}")
            if judge["path"] != ("overlap" if overlap else "classic") or (
                    overlap and (judge["fallbacks"] != 0 or judge["prefilled"] <= 0)):
                raise AssertionError(f"session overlap: {run}")
            if judge["ttft_s"] is None or min(sl["launches"].values()) <= 0:
                raise AssertionError(f"session overlap: no judge token or a kernel idle: {run}")
            runs.append(run)
    return {"runs": runs, "fallbacks": sum(r["fallbacks"] for r in runs)}


def session_ladder(torch) -> dict:
    """(c) The retry ladder on a built provider (consensus-1b): an injected
    RuntimeError on the first generate (one eviction, one rebuild, the
    answer returned, peak memory under the old and the new engine's weights
    together), an injected torch.cuda.OutOfMemoryError (rebuilt), and an
    injected KernelLaunchError (propagates, no rebuild)."""
    from llm_consensus_tpu_torch.engine import engine as engine_mod
    from llm_consensus_tpu_torch.ops.kernels.build import KernelLaunchError
    from llm_consensus_tpu_torch.providers import Request
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider, parse_model_name
    from llm_consensus_tpu_torch.utils.context import Context

    preset = parse_model_name(LADDER_MODEL)
    provider = GPUProvider()
    req = Request(model=LADDER_MODEL, prompt=PROMPT, max_tokens=48)
    ref = provider.query(Context.background(), req).content  # builds the engine
    events: list = []
    orig_evict, orig_build = provider._evict, provider._build_engine

    def evict(*args):
        t0 = time.monotonic()
        orig_evict(*args)
        events.append(("evict", time.monotonic() - t0))

    def build(*args):
        t0 = time.monotonic()
        out = orig_build(*args)
        torch.cuda.synchronize()
        events.append(("build", time.monotonic() - t0))
        return out

    provider._evict, provider._build_engine = evict, build
    orig_generate = engine_mod.Engine.generate
    rows = {}
    try:
        for label, err in (
                ("runtime", lambda: RuntimeError("injected transient failure")),
                ("oom", lambda: torch.cuda.OutOfMemoryError("injected: CUDA out of memory")),
                ("kernel", lambda: KernelLaunchError("injected: decode_bf16_kernel launch "
                                                     "failed"))):
            # The error is made inside the wrapper: one held here would pin
            # the failed engine through its traceback.
            armed = [err]

            def generate(engine, *args, **kwargs):
                if armed and engine.cfg.name == preset:
                    raise armed.pop()()
                return orig_generate(engine, *args, **kwargs)

            weights = sum(w.numel() * w.element_size() for w in
                          provider.engines()[preset].params["layers"].values())
            events.clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            engine_mod.Engine.generate = generate
            raised = None
            try:
                answer = provider.query(Context.background(), req).content
            except KernelLaunchError as exc:
                raised, answer = exc, None
            finally:
                engine_mod.Engine.generate = orig_generate
            torch.cuda.synchronize()
            over = (torch.cuda.max_memory_allocated() - base) / 1e9
            row = {"events": [[name, round(s, 4)] for name, s in events],
                   "raised": type(raised).__name__ if raised else None,
                   "answer_equal": answer == ref if answer is not None else None,
                   "peak_over_start_gb": over, "weights_gb": weights / 1e9}
            log(f"session ladder {label}: {json.dumps(row)}")
            names = [name for name, _ in events]
            if label == "kernel":
                ok = raised is not None and names == []
            else:
                ok = (raised is None and names == ["evict", "build"] and answer
                      and over < weights / 1e9)
            if not ok:
                raise AssertionError(f"session ladder {label}: {row}")
            rows[label] = row
    finally:
        engine_mod.Engine.generate = orig_generate
        provider.release()
        release_memory(torch)
    return rows


@contextlib.contextmanager
def openai_mock():
    """A local stand-in for the OpenAI Responses API on 127.0.0.1 (SSE),
    reached through OPENAI_BASE_URL for the block; yields the request
    bodies it received."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    bodies: list = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for word in REMOTE_ANSWER.split(" "):
                event = {"type": "response.output_text.delta", "delta": word + " "}
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")

        def log_message(self, *args):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with set_environ({"OPENAI_API_KEY": "sk-local-mock",
                          "OPENAI_BASE_URL": f"http://127.0.0.1:{server.server_address[1]}"}):
            yield bodies
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def session_mixed(torch, fa, da) -> dict:
    """(d) A mixed panel through the CLI: the remote model (the local mock)
    and gpu:consensus-1b, the gpu:llama-3-8b judge under --judge-overlap,
    auto-saved: exit 0, both answers, the JAX CLI's run directory."""
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES}
    with openai_mock() as bodies, tempfile.TemporaryDirectory(prefix="chip-smoke-mixed-") as tmp:
        sl = run_slice(torch, counters, {}, "session mixed panel",
                       models=f"{REMOTE_MODEL},gpu:consensus-1b", judge=SESSION_JUDGE,
                       extra=("--judge-overlap",), data_dir=tmp, timing=False)
    doc, listing = sl["doc"], sl["files"]["listing"]
    answers = {r["model"]: r for r in doc["responses"]}
    row = {"wall_s": sl["wall_s"], "listing": listing, "models": sorted(answers),
           "remote_requests": len(bodies), "launches": sl["launches"]}
    log(f"session mixed: {json.dumps(row)}")
    if (listing != [n for n in RUN_FILES if n != "trace.json"]
            or answers.get(REMOTE_MODEL, {}).get("content", "").strip() != REMOTE_ANSWER
            or answers[REMOTE_MODEL]["provider"] != "openai"
            or not answers.get("gpu:consensus-1b", {}).get("content")
            or len(bodies) != 1 or doc.get("warnings")):
        raise AssertionError(f"session mixed: {row}; {json.dumps(doc)[:2000]}")
    return row


def run_session(torch, fa, da, card: str, seed: int) -> dict:
    """Phase 8c over warm shared providers (llama-3-8b and consensus-1b,
    bf16, random weights from the seed): (a) reuse, (b) overlap, (c) the
    ladder, (d) the mixed panel. Prints a ``{"session": ...}`` line."""
    from llm_consensus_tpu_torch.cli.main import install_planes
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    t_phase = time.monotonic()
    install_planes(False, sys.stderr)
    provider = GPUProvider.shared()
    for model in SESSION_PANEL.split(","):
        provider._engine_for(model)
    torch.cuda.synchronize()
    log(f"session: engines {sorted(provider.engines())} built in "
        f"{time.monotonic() - t_phase:.2f} s")
    rows = {"reuse": session_reuse(torch, provider, seed)}
    rows["overlap"] = session_overlap(torch, fa, da, provider)
    rows["ladder"] = session_ladder(torch)
    rows["mixed"] = session_mixed(torch, fa, da)
    log(f"session phase: {time.monotonic() - t_phase:.1f} s")
    print(json.dumps({"session": rows, "card": card}), flush=True)
    release_engines(torch, {})
    return rows


# -- phase 8d: serving (the batcher's scheduling remainder) --------------------

SERVING_MODEL = "llama-3-8b"
# A batched stream against the single-stream engine in bf16: the two run
# other matmul shapes (B rows against 1) and other attention split orders,
# so a greedy choice between two logits closer than this may flip. A
# stream that differs must have every token within this of the reference
# model's best logit, the model fed the stream's own tokens (teacher
# forcing). On an H100 at llama-3-8b's width the sound streams' largest gap
# is 0.054 and a stream fed another row's prompt reads 1.2 at least
# (PERF.md, §6); every run reads both again (fault_readings) and fails
# unless this lies between them.
NEAR_TIE_TOL = BATCH_LOGIT_TOL


_TEACHER: dict = {}  # (prompt, tokens) -> teacher_gaps' result, within one phase


def teacher_gaps(torch, engine, prompt_ids: list, got: list) -> tuple[list, float]:
    """For each token of ``got``: the best logit minus the logit of that
    token, the model fed ``prompt_ids + got`` in one flash prefill; and the
    logits' standard deviation over those positions. A stream repeated
    across runs is read once."""
    key = (tuple(prompt_ids), tuple(got))
    if key not in _TEACHER:
        _TEACHER[key] = _teacher_gaps(torch, engine, prompt_ids, got)
    return _TEACHER[key]


def _teacher_gaps(torch, engine, prompt_ids: list, got: list) -> tuple[list, float]:
    from llm_consensus_tpu_torch.engine.engine import _bucket
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    ids = list(prompt_ids) + list(got)
    n = len(ids)
    with torch.inference_mode():
        cache = init_kv_cache(engine.cfg, batch=1, max_seq=engine.max_seq,
                              device=engine.device, dtype=engine.dtype)
        tokens = engine._ids_tensor(ids + [0] * (_bucket(n, engine.max_seq) - n))
        logits, _ = engine._forward(tokens, cache, 0, attn_impl="flash")
        lg = logits[0, len(prompt_ids) - 1:n - 1].float()
        chosen = lg.gather(1, torch.tensor(got, device=lg.device)[:, None])[:, 0]
        gaps = (lg.max(-1).values - chosen).tolist()
        std = lg.std(dim=-1).mean().item()
    del cache, logits, lg
    return gaps, std


def greedy_check(torch, engine, label: str, prompt_ids: list, got: list, ref: list) -> dict:
    """A batched stream's greedy tokens against the single-stream engine's:
    equal, or (bf16 near-ties) every token within NEAR_TIE_TOL of the
    reference model's best logit under teacher forcing. Anything else
    fails."""
    row = {"equal": got == ref, "agree": token_agreement(got, ref), "n": len(ref)}
    if got != ref:
        gaps, row["logit_std"] = teacher_gaps(torch, engine, prompt_ids, got)
        row["max_gap"] = max(gaps)
        row["first_gap"] = gaps[row["agree"]] if row["agree"] < len(gaps) else None
    log(f"  {label}: {len(got)} tokens, equal to single-stream {row['equal']}"
        + ("" if row["equal"] else
           f" (first {row['agree']} equal; at the first difference the batched token is "
           f"{row['first_gap']:.4f} below the best logit, at most {row['max_gap']:.4f} over "
           f"the stream, tol {NEAR_TIE_TOL}; logit std {row['logit_std']:.3f})"))
    if len(got) != len(ref) or (not row["equal"] and row["max_gap"] > NEAR_TIE_TOL):
        raise AssertionError(f"{label}: batched tokens not the model's greedy ones: {row}")
    return row


def fault_readings(torch, engine, label: str, prompts: list, streams: list) -> dict:
    """What the near-tie rule reads on two planted faults of this part's
    own streams, each as the stream's largest teacher-forced gap: stream
    i's tokens under stream i+1's prompt (a row fed another row's context;
    none where the two streams' tokens are the same, as the fault then
    changes nothing), and under its own prompt with one token dropped (a
    lost token; the first token from the middle on that differs from its
    successor, since dropping one of a run of equal tokens leaves the
    sequence as it was; none for a stream of one repeated token). The
    phase fails unless every swap reads above NEAR_TIE_TOL (run_serving,
    after all parts): a rule that passes a misplaced row cannot tell a
    sound batcher from a broken one. A lost token is only recorded: with
    random weights the next token hardly depends on the last one, so it
    reads 0.03-1.3 at full width (PERF.md, §6) and the exact checks
    (the resize's carried rows, the residents across (b)'s runs, the CPU
    tests) hold it instead."""
    swapped, lost, stds = [], [], []
    for i, got in enumerate(streams):
        j = (i + 1) % len(prompts)
        gaps, std = teacher_gaps(torch, engine, prompts[j], got)
        swapped.append(None if got == streams[j][:len(got)] else max(gaps))
        stds.append(std)
        half = len(got) // 2
        ks = [k for k in range(len(got) - 1) if got[k] != got[k + 1]]
        k = next((k for k in ks if k >= half), ks[-1] if ks else None)
        lost.append(None if k is None else
                    max(teacher_gaps(torch, engine, prompts[i], got[:k] + got[k + 1:])[0]))
    seen = [g for g in swapped if g is not None]
    row = {"swapped": swapped, "lost": lost, "min": min(seen, default=None),
           "logit_std": sum(stds) / len(stds)}
    log(f"  {label} planted faults (largest teacher-forced gap per stream; tol {NEAR_TIE_TOL}): "
        f"another row's prompt {[None if g is None else round(g, 3) for g in swapped]}, a "
        f"lost token {[None if g is None else round(g, 3) for g in lost]}; logit std "
        f"{row['logit_std']:.3f}")
    return row


class BatcherTrace:
    """One part's batcher spans, read from the batcher's own recorder: a
    Recorder is installed while the part runs (a batcher binds it at
    construction) and its ``tid="batcher"`` spans give the resizes, fetch
    arrivals (with the waves' first tokens), admissions (with resumed
    streams) and interleaved credits. What the spans do not hold is added
    by wrapping ``_resize_to``: ``memory_allocated`` around it, and each
    live stream's row state (its cache up to the frontier, token, row
    starts and prefix flag) before and after, which a move must carry bit
    for bit; and by timestamping the flash counter's ``add``."""

    def __init__(self, torch, fa) -> None:
        from llm_consensus_tpu_torch import obs

        self.torch, self.fa = torch, fa
        self.rec = obs.Recorder()
        self.t0_ns = time.monotonic_ns()
        self.memory: list = []  # (before, after) bytes of each resize
        self.carried: list = []  # (moved, bit-equal) of each live row of each resize
        self.flash_ns: list = []
        self._undo: list = []

    def __enter__(self) -> "BatcherTrace":
        from llm_consensus_tpu_torch import obs
        from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher as CB

        torch, tr = self.torch, self
        prev, real_resize, counter = obs.recorder(), CB._resize_to, self.fa.LAUNCHES
        real_add = counter.add

        def row_state(b, i):
            return ([b._cache[side][:, i, :b._pos].clone() for side in ("k", "v")],
                    [int(t[i]) for t in (b._token, b._row_start, b._prefix_rows)]
                    + [b._row_start_host[i]])

        def resize(b, target):
            live = [(i, s, row_state(b, i)) for i, s in enumerate(b._slots[:b._rows_cap])
                    if s is not None]
            before = torch.cuda.memory_allocated()
            real_resize(b, target)
            tr.memory.append((before, torch.cuda.memory_allocated()))
            for i, s, (kv, scalars) in live:
                j = next(j for j, x in enumerate(b._slots) if x is s)
                kv2, scalars2 = row_state(b, j)
                tr.carried.append((i != j, scalars == scalars2 and all(
                    torch.equal(a, c) for a, c in zip(kv, kv2))))
            del live

        def add():
            tr.flash_ns.append(time.monotonic_ns())
            real_add()

        obs.install(self.rec)
        CB._resize_to = resize
        counter.add = add
        self._undo = [lambda: obs.install(prev), lambda: setattr(CB, "_resize_to", real_resize),
                      lambda: vars(counter).pop("add")]
        return self

    def __exit__(self, *exc) -> None:
        for undo in self._undo:
            undo()

    def now(self) -> float:
        return (time.monotonic_ns() - self.t0_ns) / 1e9

    def spans(self, name: str) -> list:
        """``(start_s, end_s, args)`` of the batcher's ``name`` spans, in
        seconds since the trace began."""
        return [((e.ts_ns - self.t0_ns) / 1e9, (e.ts_ns + e.dur_ns - self.t0_ns) / 1e9, e.args)
                for e in self.rec.events()
                if e.tid == "batcher" and e.ph == "X" and e.name == name]

    def resizes(self) -> list:
        return [{"t_s": t1, "from": a["before"], "to": a["rows"], "before_gb": m0 / 1e9,
                 "after_gb": m1 / 1e9}
                for (_, t1, a), (m0, m1) in zip(self.spans("resize"), self.memory)]

    def flash_in(self, t0_s: float, t1_s: float) -> int:
        lo, hi = self.t0_ns + int(t0_s * 1e9), self.t0_ns + int(t1_s * 1e9)
        return sum(1 for t in self.flash_ns if lo <= t <= hi)


def step_wall_ms(torch, engine, rows: int, frontier: int, windows: int = 5,
                 steps: int = 8) -> list:
    """Wall per decode step (host launches + device) of ``engine``'s decode
    chunk at ``rows`` rows and the attention width of ``frontier``: after a
    warm 16-step chunk, ``windows`` windows of ``steps`` steps, each ending
    in a synchronize; the per-step wall of each window."""
    from llm_consensus_tpu_torch.models.transformer import init_kv_cache

    dev = engine.device
    out = []
    with torch.inference_mode():
        cache = init_kv_cache(engine.cfg, batch=rows, max_seq=frontier + 128, device=dev,
                              dtype=engine.dtype)
        token = torch.randint(32, 127, (rows,), device=dev)
        kw = {"row_start": torch.zeros(rows, dtype=torch.int32, device=dev)}
        width = engine._decode_width(frontier + 112)
        start = torch.full((), frontier, dtype=torch.int32, device=dev)
        token, _, start = engine._decode_chunk(token, start, cache, 16, None,
                                               (0.0, None, None), width, **kw)
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            token, _, start = engine._decode_chunk(token, start, cache, steps, None,
                                                   (0.0, None, None), width, **kw)
            torch.cuda.synchronize()
            out.append((time.monotonic() - t0) * 1e3 / steps)
    del cache
    return out


def serving_rows(torch, fa, engine, seed: int) -> dict:
    """(a) Row bucketing: a 32-row pool takes 32 random 350-token prompts
    (28 x 32 tokens, 4 x 160), shrinks to 8 rows once the short ones
    retire, then a burst of 12 prompts sharing the slice's prompt regrows it
    to 16 (their shared prefix: the state kernel). Resizes with their
    memory, rows over time, the step wall at 32, 8 and 16 rows (median and
    spread of 5 windows), and the 4 long streams' greedy tokens against
    single-stream, with the planted-fault readings on them."""
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    prompts = [random_ids(torch, seed + 100 + i, 349, tok.bos_id) for i in range(32)]
    short = SamplingParams(max_new_tokens=32, ignore_eos=True)
    long = SamplingParams(max_new_tokens=160, ignore_eos=True)
    burst = [PROMPT + f" Panelist {i} of twelve, answer in one line." for i in range(12)]
    gb_row = (2 * engine.cfg.n_layers * engine.max_seq * engine.cfg.n_kv_heads
              * engine.cfg.head_dim * engine.dtype.itemsize) / 1e9
    with BatcherTrace(torch, fa) as tr:
        b = ContinuousBatcher(engine, max_batch=32)
        try:
            cap0 = b._rows_cap
            t0 = time.monotonic()
            futs = [b.submit_ids(ids, long if i >= 28 else short)
                    for i, ids in enumerate(prompts)]
            first = [f.result(timeout=600) for f in futs]
            t_first = time.monotonic() - t0
            futs = [b.submit(p, short) for p in burst]
            second = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
            snap, cap_end = b.snapshot(), b._rows_cap
        finally:
            b.close()
    release_memory(torch)
    resizes = tr.resizes()
    rows_seen = [(0.0, cap0)] + [(round(r["t_s"], 3), r["to"]) for r in resizes]
    log(f"serving (a): 32 streams in {t_first:.2f} s, 12 more (shared prefix "
        f"{snap['prefix_len']} tokens) in {wall - t_first:.2f} s; rows over time (s, rows) "
        f"{rows_seen}; stats {snap}")
    for r in resizes:
        log(f"  resize {r['from']} -> {r['to']} rows at {r['t_s']:.3f} s: memory_allocated "
            f"{r['before_gb']:.3f} -> {r['after_gb']:.3f} GB "
            f"({r['after_gb'] - r['before_gb']:+.3f}; {r['to'] - r['from']} rows x "
            f"{gb_row:.3f} GB = {(r['to'] - r['from']) * gb_row:+.3f})")
    moved = sum(1 for m, _ in tr.carried if m)
    log(f"  the resizes carried {len(tr.carried)} live rows ({moved} moved to another slot), "
        f"bit for bit equal {sum(1 for _, eq in tr.carried if eq)} of {len(tr.carried)}")
    moves = [(r["from"], r["to"]) for r in resizes]
    if moves[:2] != [(32, 8), (8, 16)] or cap_end not in (8, 16):
        raise AssertionError(f"serving (a): resizes {moves}")
    if not moved or not all(eq for _, eq in tr.carried):
        raise AssertionError(f"serving (a): a resize did not carry its rows: {tr.carried}")
    drop = resizes[0]["before_gb"] - resizes[0]["after_gb"]
    if abs(drop - 24 * gb_row) > 0.05 * 24 * gb_row:
        raise AssertionError(f"serving (a): the shrink freed {drop:.3f} GB, not 24 rows")
    if any(len(r.token_ids) != (160 if i >= 28 else 32) for i, r in enumerate(first)) or any(
            len(r.token_ids) != 32 for r in second):
        raise AssertionError("serving (a): a stream ended short")
    checks = [greedy_check(torch, engine, f"long stream {i} (moved in the shrink)", prompts[i],
                           first[i].token_ids, engine.generate_ids(prompts[i], long).token_ids)
              for i in range(28, 32)]
    faults = fault_readings(torch, engine, "serving (a)", prompts[28:],
                            [r.token_ids for r in first[28:]])
    steps = {rows: step_wall_ms(torch, engine, rows, 512) for rows in (32, 8, 16)}
    release_memory(torch)
    med = {rows: sorted(v)[len(v) // 2] for rows, v in steps.items()}
    log("  decode step wall at frontier 512 (host launches + device, ms per step; median of "
        "5 windows of 8 steps [min-max]): "
        + ", ".join(f"{rows} rows {med[rows]:.2f} [{min(v):.2f}-{max(v):.2f}]"
                    for rows, v in steps.items())
        + f"; 32 rows / 8 rows {med[32] / med[8]:.2f}x (extremes "
        f"{min(steps[32]) / max(steps[8]):.2f}-{max(steps[32]) / min(steps[8]):.2f}x)")
    return {"wall_s": wall, "resizes": resizes, "rows_over_time": rows_seen,
            "step_ms": steps, "step_ms_median": med, "greedy": checks, "faults": faults,
            "stats": snap}


def serving_interleave(torch, fa, engine, seed: int) -> dict:
    """(b) Interleaved admission: four residents (random 1,501-token
    prompts, 128 tokens) decode; once each has 32 tokens a wave of four
    other 1,501-token prompts (32 tokens) arrives. Budget 2048, 0, 0, 2048:
    the residents' longest gap between fetches while the wave fills and the
    wave's time to its first token; every stream against single-stream."""
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher

    tok = engine.tokenizer
    residents = [random_ids(torch, seed + 200 + i, 1500, tok.bos_id) for i in range(4)]
    wave = [random_ids(torch, seed + 300 + i, 1500, tok.bos_id) for i in range(4)]
    s_res = SamplingParams(max_new_tokens=128, ignore_eos=True)
    s_wave = SamplingParams(max_new_tokens=32, ignore_eos=True)
    runs = []
    for budget in (2048, 0, 0, 2048):
        with BatcherTrace(torch, fa) as tr:
            b = ContinuousBatcher(engine, max_batch=8, prefill_budget=budget)
            try:
                f_res = [b.submit_ids(ids, s_res) for ids in residents]
                deadline = time.monotonic() + 600
                while not all(st is not None and len(st.out_ids) >= 32
                              for st in list(b._slots)[:4]):
                    if time.monotonic() > deadline:
                        raise AssertionError("serving (b): residents never decoded")
                    time.sleep(0.002)
                t_wave = tr.now()
                f_wave = [b.submit_ids(ids, s_wave) for ids in wave]
                r_wave = [f.result(timeout=600) for f in f_wave]
                r_res = [f.result(timeout=600) for f in f_res]
                snap = b.snapshot()
            finally:
                b.close()
        fetches = tr.spans("fetch")
        # The wave's first tokens ride the first fetch after its splice;
        # until then every fetch is the residents' alone.
        t_first = next(t1 for _, t1, a in fetches if t1 > t_wave and a["firsts"])
        ends = [t1 for _, t1, _ in fetches]
        gaps = [b2 - a for a, b2 in zip(ends, ends[1:]) if t_wave < b2 <= t_first]
        credits = len(tr.spans("prefill_interleave"))
        row = {"budget": budget, "longest_gap_ms": 1e3 * max(gaps), "ttft_ms":
               1e3 * (t_first - t_wave), "fetches_during_wave": len(gaps),
               "res": [r.token_ids for r in r_res], "wave": [r.token_ids for r in r_wave],
               "admit_s": snap["admit_s"], "credits": credits}
        runs.append(row)
        log(f"serving (b) budget {budget}: residents' longest gap between fetches while the "
            f"wave filled {row['longest_gap_ms']:.1f} ms over {len(gaps)} fetches; wave time "
            f"to first token {row['ttft_ms']:.1f} ms; admit_s {snap['admit_s']:.3f}; paced "
            f"credits {credits}")
        if (credits >= 2) != bool(budget):
            raise AssertionError(f"serving (b): budget {budget} ran {credits} credits")
    base = runs[0]
    same = [sum(int(r["res"][i] == base["res"][i]) for r in runs) for i in range(4)] + [
        sum(int(r["wave"][i] == base["wave"][i]) for r in runs) for i in range(4)]
    log(f"  streams equal to the first run's in each of the 4 runs (4 residents, 4 wave): {same}")
    if same[:4] != [4] * 4:
        # The residents decode at the same rows and widths in every run.
        raise AssertionError(f"serving (b): residents differ across the runs: {same}")
    checks = []
    for label, prompts_, key, sp in (("resident", residents, "res", s_res),
                                     ("wave", wave, "wave", s_wave)):
        for i, ids in enumerate(prompts_):
            ref = engine.generate_ids(ids, sp).token_ids
            for r in runs:
                checks.append(greedy_check(torch, engine, f"{label} {i}, budget {r['budget']}",
                                           ids, r[key][i], ref))
    faults = fault_readings(torch, engine, "serving (b)", residents + wave,
                            base["res"] + base["wave"])
    on = [r for r in runs if r["budget"]]
    off = [r for r in runs if not r["budget"]]
    ratio_gap = [a["longest_gap_ms"] / c["longest_gap_ms"] for a in on for c in off]
    ratio_ttft = [a["ttft_ms"] / c["ttft_ms"] for a in on for c in off]
    log(f"  budget 2048 against 0: longest gap {min(ratio_gap):.2f}-{max(ratio_gap):.2f}x, "
        f"wave time to first token {min(ratio_ttft):.2f}-{max(ratio_ttft):.2f}x")
    return {"runs": [{k: v for k, v in r.items() if k not in ("res", "wave")} for r in runs],
            "equal_runs": same, "greedy": checks, "faults": faults}


def serving_preempt(torch, fa, engine, seed: int) -> dict:
    """(c) Preempt and resume: a 2-row pool, two LOW residents (random
    350-token prompts, 128 tokens) and a HIGH latecomer (64 tokens) once
    both decode. At least one preemption, the resume prefilled through
    flash, all three streams against single-stream. The latecomer is retried
    (at most 3 times) if the residents finished before it arrived."""
    from llm_consensus_tpu_torch.engine import SamplingParams
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
    from llm_consensus_tpu_torch.pressure import PRIORITY_HIGH, PRIORITY_LOW

    tok = engine.tokenizer
    lows = [random_ids(torch, seed + 400 + i, 349, tok.bos_id) for i in range(2)]
    high = random_ids(torch, seed + 402, 349, tok.bos_id)
    s_low = SamplingParams(max_new_tokens=128, ignore_eos=True)
    s_high = SamplingParams(max_new_tokens=64, ignore_eos=True)
    with BatcherTrace(torch, fa) as tr:
        b = ContinuousBatcher(engine, max_batch=2)
        try:
            for attempt in range(3):
                f_low = [b.submit_ids(ids, s_low, priority=PRIORITY_LOW) for ids in lows]
                deadline = time.monotonic() + 600
                while sum(1 for st in list(b._slots) if st is not None and len(st.out_ids) >= 16) < 2:
                    if time.monotonic() > deadline:
                        raise AssertionError("serving (c): residents never decoded")
                    time.sleep(0.002)
                r_high = b.submit_ids(high, s_high, priority=PRIORITY_HIGH).result(timeout=600)
                r_low = [f.result(timeout=600) for f in f_low]
                snap = b.snapshot()
                if snap["preemptions"]:
                    break
        finally:
            b.close()
    resumes = [tr.flash_in(t0, t1) for t0, t1, a in tr.spans("admit")
               if a["resumed"] and a["ok"]]
    log(f"serving (c): attempt {attempt + 1}, preemptions {snap['preemptions']}, victims "
        f"{[r.preempted for r in r_low]}, flash launches per resume admission {resumes}, "
        f"stats {snap}")
    if snap["preemptions"] < 1 or not resumes or min(resumes) < engine.cfg.n_layers:
        raise AssertionError(f"serving (c): preemptions {snap['preemptions']}, resume flash "
                             f"{resumes}")
    checks = [greedy_check(torch, engine, f"low {i}{' (preempted)' if r.preempted else ''}",
                           lows[i], r.token_ids, engine.generate_ids(lows[i], s_low).token_ids)
              for i, r in enumerate(r_low)]
    checks.append(greedy_check(torch, engine, "high", high, r_high.token_ids,
                               engine.generate_ids(high, s_high).token_ids))
    faults = fault_readings(torch, engine, "serving (c)", lows + [high],
                            [r.token_ids for r in r_low] + [r_high.token_ids])
    return {"preemptions": snap["preemptions"], "resume_flash": resumes, "greedy": checks,
            "faults": faults, "attempts": attempt + 1}


def serving_cli(torch, fa, da) -> dict:
    """(d) The batched slice through the CLI: panel 4 x llama-3-8b, judge
    llama-3-8b, ``LLMC_MAX_BATCH=16 --priority low --prefill-budget 2048``:
    exit 0, every answer, a consensus, no warning but the random-weight
    ones, and the batcher sees class 2 for the panel, 1 for the judge."""
    from llm_consensus_tpu_torch.engine.batcher import ContinuousBatcher
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.knobs import batch_settings

    classes, lock = [], threading.Lock()
    real = ContinuousBatcher.submit

    def submit(b, prompt, sampling, ctx=None, on_text=None, *, priority=1):
        with lock:
            classes.append((priority, "You are a synthesis judge" in prompt))
        return real(b, prompt, sampling, ctx, on_text, priority=priority)

    # LLMC_PREFILL_BUDGET is set to 0 for the call and restored after it:
    # the flag sets it inside the call (flag and knob are one setting).
    env = {"LLMC_MAX_BATCH": "16", "LLMC_PREFILL_BUDGET": "0"}
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_state": da.LAUNCHES_STATE}
    argv = ["--models", ",".join([f"gpu:{SERVING_MODEL}"] * 4), "--judge",
            f"gpu:{SERVING_MODEL}", "--max-tokens", "64", "--priority", "low",
            "--prefill-budget", "2048", "--json", PROMPT]
    ContinuousBatcher.submit = submit
    try:
        call = cli_call(torch, counters, env, argv)
    finally:
        ContinuousBatcher.submit = real
    if call["rc"] != 0:
        raise AssertionError(f"serving (d): CLI exit {call['rc']}: {call['err']}")
    doc = json.loads(call["out"])
    with set_environ({"LLMC_MAX_BATCH": "16", "LLMC_PREFILL_BUDGET": "2048"}):
        provider = GPUProvider.shared(**batch_settings())
    stats = provider.batcher_stats()
    warn = [w for w in doc.get("warnings", []) if not w.endswith(RANDOM_WEIGHT_WARNINGS)]
    log(f"serving (d): CLI exit 0 in {call['wall_s']:.2f} s wall, peak {call['peak_gb']:.2f} "
        f"GB, launches {call['launches']}, classes (class, judge) {sorted(classes)}, batcher "
        f"{stats}, consensus {len(doc['consensus'])} chars")
    if (len(doc["responses"]) != 4 or doc.get("failed_models") or not doc["consensus"] or warn
            or sorted(classes) != [(1, True)] + [(2, False)] * 4 or list(stats) != [SERVING_MODEL]
            or min(call["launches"].values()) <= 0):
        raise AssertionError(f"serving (d): classes {classes}, warnings {warn}, stats {stats}, "
                             f"launches {call['launches']}, doc {json.dumps(doc)[:1500]}")
    provider.release()
    release_memory(torch)
    return {"wall_s": call["wall_s"], "peak_gb": call["peak_gb"], "classes": sorted(classes),
            "launches": call["launches"], "stats": stats[SERVING_MODEL]}


def run_serving(torch, fa, da, card: str, seed: int, recs: dict) -> dict:
    """Phase 8d on llama-3-8b (bf16, random weights from the seed): (a) row
    bucketing, (b) interleaved admission, (c) preempt and resume, (d) the
    CLI with ``--priority`` and ``--prefill-budget``. The decode kernels'
    launches over (a) to (c) go to the B = 16 rows of the kernel line. Any
    RuntimeWarning fails the phase. Prints a ``{"serving": ...}`` line."""
    import warnings

    from llm_consensus_tpu_torch.engine import Engine
    from llm_consensus_tpu_torch.models import get_config

    t_phase = time.monotonic()
    engine = Engine(get_config(SERVING_MODEL), seed=seed)
    torch.cuda.synchronize()
    log(f"serving: {SERVING_MODEL} built in {time.monotonic() - t_phase:.2f} s")
    _TEACHER.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for c in (fa.LAUNCHES, da.LAUNCHES, da.LAUNCHES_STATE):
            c.reset()
        rows, part_s = {}, {}
        for key, part in (("rows", serving_rows), ("interleave", serving_interleave),
                          ("preempt", serving_preempt)):
            t_part = time.monotonic()
            rows[key] = part(torch, fa, engine, seed)
            part_s[key] = time.monotonic() - t_part
        launches = {"flash_attention": fa.LAUNCHES.count, "decode_attention": da.LAUNCHES.count,
                    "decode_attention_state": da.LAUNCHES_STATE.count}
        log(f"serving (a)-(c) launches {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"serving: a kernel of the path never launched: {launches}")
        for key, name in (("decode_attention_b16", "decode_attention"),
                          ("decode_attention_state_b16", "decode_attention_state")):
            recs[key]["launches"] = launches[name]
        del engine
        release_memory(torch)
        t_part = time.monotonic()
        rows["cli"] = serving_cli(torch, fa, da)
        part_s["cli"] = time.monotonic() - t_part
    bad = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if bad:
        raise AssertionError(f"serving: warnings {bad}")
    worst = max((c.get("max_gap", 0.0) for key in ("rows", "interleave", "preempt")
                 for c in rows[key]["greedy"]), default=0.0)
    faults = [rows[key]["faults"]["min"] for key in ("rows", "interleave", "preempt")]
    lost = [g for key in ("rows", "interleave", "preempt")
            for g in rows[key]["faults"]["lost"] if g is not None]
    log(f"serving near-tie rule: sound streams' largest gap {worst:.4f}, a misplaced row's "
        f"smallest reading per part {faults}, a lost token's {min(lost):.4f}-{max(lost):.4f} "
        f"(recorded only), tol {NEAR_TIE_TOL}")
    if any(f is None or f <= NEAR_TIE_TOL for f in faults) or worst > NEAR_TIE_TOL:
        raise AssertionError(f"serving: the near-tie tolerance {NEAR_TIE_TOL} does not separate "
                             f"the sound streams ({worst}) from a misplaced row ({faults})")
    rows["launches"], rows["part_s"] = launches, part_s
    log(f"serving phase: {time.monotonic() - t_phase:.1f} s (by part, checks included: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()) + ")")
    print(json.dumps({"serving": rows, "card": card}, default=str), flush=True)
    return rows


# -- phases 12 to 16: Mixtral and the checkpoint loader ------------------------

MIXTRAL = "mixtral-8x7b"
# moe_block in float32 on the card (TF32 off) against float32 on the CPU at
# Mixtral's widths: sums of 4,096 and 14,336 products in another order, on
# outputs of magnitude ~1.
MOE_TOL = 1e-4


def check_moe_block(torch, seed: int) -> None:
    """One Mixtral layer's moe_block (d 4096, d_ff 14336, 8 experts, top-2)
    in float32 on the card against float32 on the CPU, at n = 1, 4 and 512
    tokens: identical top-2 indices and outputs within MOE_TOL of the
    largest output."""
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.ops.moe import moe_block, route

    cfg = get_config(MIXTRAL)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: routing would not be float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, std):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    dev = [rnd((d, e), d ** -0.5), rnd((e, d, f), d ** -0.5), rnd((e, d, f), d ** -0.5),
           rnd((e, f, d), f ** -0.5)]
    cpu = [w.cpu() for w in dev]
    for n in (1, 4, 512):
        x = rnd((1, n, d), 1.0)
        _, idx_dev = route(x.reshape(n, d), dev[0], cfg.experts_per_token)
        _, idx_cpu = route(x.cpu().reshape(n, d), cpu[0], cfg.experts_per_token)
        t0 = time.monotonic()
        got = moe_block(x, *dev, top_k=cfg.experts_per_token)
        torch.cuda.synchronize()
        card_ms = (time.monotonic() - t0) * 1e3
        want = moe_block(x.cpu(), *cpu, top_k=cfg.experts_per_token)
        err = (got.cpu() - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        same = torch.equal(idx_dev.cpu(), idx_cpu)
        log(f"moe_block {MIXTRAL} layer, n {n}: float32 card vs CPU max |diff| {err:.3e} "
            f"(tol {MOE_TOL * scale:.3e}), top-2 indices identical {same}, card wall "
            f"{card_ms:.2f} ms (first call at this n)")
        if not same or err > MOE_TOL * scale or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"moe_block n {n}: err {err}, indices same {same}")
    del dev, cpu
    release_memory(torch)


def check_decode_mixtral_cache(torch) -> None:
    """The int8 decode kernel over the cache shape the Mixtral slice gives
    it ([32, 1, 32768, 8, 128], its full context), against its plain
    version at the slice's decode widths."""
    from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
    from llm_consensus_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(7)
    L, S, hq, hkv, dh, layer = 32, 32768, 32, 8, 128, 31
    side = []
    for _ in range(2):
        q8 = torch.zeros((L, 1, S, hkv, dh), dtype=torch.int8, device="cuda")
        sc = torch.zeros((L, 1, hkv, S), dtype=torch.bfloat16, device="cuda")
        codes, scale = quantize_kv(torch.randn(1, 1024, hkv, dh, generator=gen,
                                               device="cuda", dtype=torch.bfloat16))
        q8[layer, :, :1024].copy_(codes)
        sc[layer, :, :, :1024].copy_(scale[..., 0].transpose(1, 2))
        side.append({"q8": q8, "s": sc})
    q = torch.randn(1, 1, hq, dh, generator=gen, device="cuda", dtype=torch.bfloat16)
    rs = torch.zeros(1, dtype=torch.int32, device="cuda")
    for pos, w in ((397, 512), (1023, 1024)):
        for w8a8 in (False, True):
            kw = dict(kv_width=w, w8a8=w8a8)
            got = da.decode_attention(q, *side, torch.full((), pos, dtype=torch.int32,
                                                           device="cuda"),
                                      torch.full((), layer, dtype=torch.int32, device="cuda"),
                                      rs, **kw)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q, *side, pos, layer, rs, **kw)
            err, tol = max_err(got, want), decode_tol(want)
            log(f"decode {'w8a8' if w8a8 else 'int8'} {MIXTRAL} cache{list(side[0]['q8'].shape)}"
                f" pos {pos} width {w}: max_abs_err {err:.3e} (tol {tol:.3e})")
            if err > tol or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode over the Mixtral cache: err {err}")
    del side
    release_memory(torch)


def run_mixtral_slice(torch, fa, da, seed: int) -> dict:
    """The CLI run with a gpu:mixtral-8x7b + gpu:consensus-1b panel and a
    gpu:mixtral-8x7b judge, int8 weights and cache, auto-saved: every
    response, a consensus, ``agreement`` in result.json, ``run.json`` and
    one ``panel/`` file per answer; flash and the int8 decode kernel
    launched on its path, the bf16 decode kernel not. The Mixtral engine is
    built first (timed), then the CLI builds consensus-1b and runs."""
    from llm_consensus_tpu_torch.cli.main import main as cli_main
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider
    from llm_consensus_tpu_torch.utils.flops import param_count
    from llm_consensus_tpu_torch.utils.knobs import batch_settings, checkpoint_dir, quant_modes

    env = {"LLMC_QUANT": "int8", "LLMC_KV_QUANT": "int8"}
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    counters = {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                "decode_attention_int8": da.LAUNCHES_INT8}
    try:
        modes = {**batch_settings(), **quant_modes(), **checkpoint_dir()}
        provider = GPUProvider.shared(**modes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        engine = provider._engine_for(f"gpu:{MIXTRAL}")
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        build_peak = torch.cuda.max_memory_allocated() / 1e9
        check_devices(engine)
        resident = torch.cuda.memory_allocated() / 1e9
        out, err = io.StringIO(), io.StringIO()
        with tempfile.TemporaryDirectory(prefix="chip-smoke-mixtral-") as data_dir:
            argv = ["--models", f"gpu:{MIXTRAL},gpu:consensus-1b", "--judge", f"gpu:{MIXTRAL}",
                    "--max-tokens", "48", "--data-dir", data_dir, PROMPT]
            for c in counters.values():
                c.reset()
            t0 = time.monotonic()
            rc = cli_main(argv, device=None, stdout=out, stderr=err,
                          install_signal_handlers=False)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {name: c.count for name, c in counters.items()}
            if rc != 0:
                raise AssertionError(f"mixtral slice: CLI exit {rc}: {err.getvalue()}")
            (run_id,) = os.listdir(data_dir)
            run_dir = os.path.join(data_dir, run_id)
            listing = sorted(os.listdir(run_dir))
            panel = sorted(os.listdir(os.path.join(run_dir, "panel")))
            with open(os.path.join(run_dir, "result.json"), encoding="utf-8") as fh:
                doc = json.load(fh)
            with open(os.path.join(run_dir, "run.json"), encoding="utf-8") as fh:
                manifest = json.load(fh)
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"mixtral slice: {MIXTRAL} int8 weights + int8 KV ({engine.max_seq} slots), engine "
        f"build {build_s:.2f} s (peak {build_peak:.2f} GB, resident {resident:.2f} GB); CLI "
        f"exit 0 in {wall:.2f} s wall, peak device memory {peak:.2f} GB of {total:.2f} GB, "
        f"launches {launches}; run dir {listing}, panel {panel}, agreement "
        f"{doc.get('agreement')}")
    cfg = engine.cfg
    active, whole = param_count(cfg, active_only=True), param_count(cfg)
    log(f"  {MIXTRAL} int8 weight bytes a decode step: {active / 1e9:.2f} GB active (top-2 "
        f"of 8, what Response.mbu counts) against {whole / 1e9:.2f} GB all experts (what "
        f"the dense dispatch reads)")
    for resp in doc["responses"]:
        log(f"  {resp['model']}: {resp.get('tokens')} tokens, latency {resp['latency_ms']:.1f} "
            f"ms, decode {resp.get('tokens_per_sec')} tok/s, mfu {resp.get('mfu')}, mbu "
            f"{resp.get('mbu')}")
        if resp["model"] == f"gpu:{MIXTRAL}" and resp.get("tokens_per_sec"):
            log(f"  {MIXTRAL}: the same rate over all experts' int8 bytes: "
                f"{resp['tokens_per_sec'] * whole / PEAK_BYTES_PER_S:.4f} of "
                f"{PEAK_BYTES_PER_S / 1e12} TB/s")
    # The JAX CLI's run directory, metrics.json included (the planes are on).
    want_listing = ["consensus.md", "metrics.json", "panel", "prompt.txt", "result.json",
                    "run.json"]
    if (len(doc["responses"]) != 2 or doc.get("failed_models") or not doc["consensus"]
            or "agreement" not in doc or listing != want_listing or len(panel) != 2
            or manifest["models"] != [f"gpu:{MIXTRAL}", "gpu:consensus-1b"]
            or launches["flash_attention"] <= 0 or launches["decode_attention_int8"] <= 0
            or launches["decode_attention"] != 0 or peak >= total):
        raise AssertionError(f"mixtral slice: launches {launches}, listing {listing}, "
                             f"panel {panel}, result {json.dumps(doc)[:1500]}")
    ids = engine.tokenizer.encode(PROMPT)
    with torch.inference_mode():
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine._prefill_ids(ids)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    times.sort()
    log(f"  {MIXTRAL}: prefill of {len(ids)} tokens (bucket 512, flash kernel) median "
        f"{times[2]:.2f} ms (min {times[0]:.2f}, max {times[-1]:.2f}, 5 runs)")
    return {"launches": launches, "engine": engine, "modes": modes, "peak_gb": peak}


def run_mixtral_w8a8(torch, fa, da, engine) -> int:
    """One 48-token Mixtral generate with W8A8 matmuls (one
    ``torch._int_mm`` per expert) and W8A8 decode scores, on the int8
    slice's weights; returns the W8A8 decode launches."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams

    w8 = Engine(engine.cfg, params=engine.params, quant="int8", kv_quant="int8", w8a8=True,
                decode_w8a8=True)
    if not (w8.w8a8 and w8.decode_w8a8):
        raise AssertionError("mixtral W8A8: modes not taken")
    ids = w8.tokenizer.encode(PROMPT)
    for c in (fa.LAUNCHES, da.LAUNCHES_INT8, da.LAUNCHES_W8A8):
        c.reset()
    t0 = time.monotonic()
    res = w8.generate_ids(ids, SamplingParams(max_new_tokens=48, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = da.LAUNCHES_W8A8.count
    rate = res.decode_tokens / res.decode_s if res.decode_s > 0 else float("nan")
    log(f"mixtral w8a8: {res.prompt_tokens}-token prompt + 48 tokens in {wall:.2f} s wall, "
        f"decode {rate:.2f} tok/s, W8A8 decode launches {n}, int8 {da.LAUNCHES_INT8.count}, "
        f"flash {fa.LAUNCHES.count}")
    if (len(res.token_ids) != 48 or n <= 0 or da.LAUNCHES_INT8.count != 0
            or fa.LAUNCHES.count <= 0):
        raise AssertionError(f"mixtral w8a8: {len(res.token_ids)} tokens, launches w8a8 {n}")
    return n


SAFETENSORS_DTYPES = {"F32": "float32", "F16": "float16", "BF16": "bfloat16"}


def write_safetensors(path: str, tensors: dict) -> None:
    """A safetensors file: an 8-byte little-endian header length, a JSON
    header of dtype, shape and byte offsets, then the raw bytes (written
    here, since the card's machine has no safetensors package)."""
    import struct

    import torch

    names = {getattr(torch, v): k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def synthetic_hf_tensors(torch, cfg, seed: int) -> dict:
    """Seeded random weights of ``cfg`` in the HF layout ([out, in] linear
    weights, one tensor per layer and per expert), as bf16."""
    gen = torch.Generator().manual_seed(seed)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff

    def w(*shape, std=0.05):
        return (torch.randn(*shape, generator=gen) * std).to(torch.bfloat16)

    def norm():
        return (1.0 + 0.1 * torch.randn(d, generator=gen)).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": w(cfg.vocab_size, d, std=0.2), "model.norm.weight": norm()}
    if not cfg.tie_embeddings:
        t["lm_head.weight"] = w(cfg.vocab_size, d, std=0.2)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = norm()
        t[f"{p}.post_attention_layernorm.weight"] = norm()
        for name, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
            t[f"{p}.self_attn.{name}_proj.weight"] = w(heads * dh, d)
            if cfg.qkv_bias:
                t[f"{p}.self_attn.{name}_proj.bias"] = w(heads * dh)
        t[f"{p}.self_attn.o_proj.weight"] = w(d, cfg.n_heads * dh)
        if cfg.is_moe:
            t[f"{p}.block_sparse_moe.gate.weight"] = w(cfg.n_experts, d, std=1.0)
            for e in range(cfg.n_experts):
                ep = f"{p}.block_sparse_moe.experts.{e}"
                t[f"{ep}.w1.weight"] = w(f, d)
                t[f"{ep}.w2.weight"] = w(d, f)
                t[f"{ep}.w3.weight"] = w(f, d)
        else:
            t[f"{p}.mlp.gate_proj.weight"] = w(f, d)
            t[f"{p}.mlp.up_proj.weight"] = w(f, d)
            t[f"{p}.mlp.down_proj.weight"] = w(d, f)
    return t


def check_checkpoint_load(torch, seed: int) -> None:
    """Synthetic HF-layout checkpoints of tiny-mixtral and tiny-qwen2 (qkv
    biases) written into a temp dir, loaded through
    GPUProvider(checkpoint_dir=...) on the card: the tree equals a CPU load
    of the same directory, and greedy tokens equal an engine on the card
    over that CPU load (the same computation, so exactly); the CPU's own
    greedy tokens (bf16 on the CPU, another computation order) are
    reported beside them."""
    from llm_consensus_tpu_torch.engine import Engine, SamplingParams
    from llm_consensus_tpu_torch.engine.checkpoint import load_hf_safetensors
    from llm_consensus_tpu_torch.models import get_config
    from llm_consensus_tpu_torch.models.transformer import param_leaves
    from llm_consensus_tpu_torch.providers.gpu import GPUProvider

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    sp = SamplingParams(max_new_tokens=24, ignore_eos=True)
    prompt = "a checkpoint loaded on the card"
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as root:
        for i, preset in enumerate(("tiny-mixtral", "tiny-qwen2")):
            cfg = get_config(preset)
            os.makedirs(os.path.join(root, preset))
            write_safetensors(os.path.join(root, preset, "model.safetensors"),
                              synthetic_hf_tensors(torch, cfg, seed + i))
        provider = GPUProvider(checkpoint_dir=root)
        try:
            for preset in ("tiny-mixtral", "tiny-qwen2"):
                cfg = get_config(preset)
                t0 = time.monotonic()
                engine = provider._engine_for(f"gpu:{preset}")
                load_s = time.monotonic() - t0
                cpu_tree = load_hf_safetensors(cfg, os.path.join(root, preset),
                                               device=torch.device("cpu"))
                for (name, a), (_, b) in zip(param_leaves(engine.params),
                                             param_leaves(cpu_tree)):
                    if not a.is_cuda or not torch.equal(a.cpu(), b):
                        raise AssertionError(f"{preset}: card load differs at {name}")
                got = engine.generate(prompt, sp).token_ids
                moved = Engine(cfg, to(cpu_tree, "cuda")).generate(prompt, sp).token_ids
                on_cpu = Engine(cfg, cpu_tree, device="cpu").generate(prompt, sp).token_ids
                log(f"checkpoint {preset}: loaded on the card through GPUProvider in "
                    f"{load_s:.2f} s, tree equal to the CPU load; greedy tokens equal to the "
                    f"CPU load on the card {got == moved}; leading tokens equal to the CPU's "
                    f"own run {token_agreement(got, on_cpu)} of {len(got)}")
                if got != moved or len(got) != 24:
                    raise AssertionError(f"{preset}: {got} vs {moved}")
        finally:
            provider.release()
    release_memory(torch)


def run_mixtral(torch, fa, da, seed: int, records: dict) -> None:
    """Phases 12 to 16: moe_block and the int8 decode kernel at Mixtral's
    shapes, the Mixtral CLI slice, its profile, its W8A8 generate, and the
    checkpoint loader on the card."""
    t0 = time.monotonic()
    check_moe_block(torch, seed)
    check_decode_mixtral_cache(torch)
    log(f"mixtral shape checks: {time.monotonic() - t0:.1f} s")
    sl = run_mixtral_slice(torch, fa, da, seed)
    records["flash"]["launches_mixtral"] = sl["launches"]["flash_attention"]
    records["int8"]["launches_mixtral"] = sl["launches"]["decode_attention_int8"]
    engine = sl["engine"]
    ours = profile_decode(torch, engine, "profile mixtral int8", counter=da.LAUNCHES_INT8)
    if ours:
        check_one_launch_per_step(ours, "decode_q8_kernel", "decode_bf16_kernel",
                                  da.LAUNCHES_INT8, engine.cfg.n_layers,
                                  "mixtral int8 decode profile")
    records["w8a8"]["launches_mixtral"] = run_mixtral_w8a8(torch, fa, da, engine)
    del engine
    modes = sl["modes"]
    del sl
    release_engines(torch, modes)
    check_checkpoint_load(torch, seed)
    log(f"mixtral phases: {time.monotonic() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "mixtral", "telemetry", "modes",
                                        "session", "serving"), default="all")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible to torch", file=sys.stderr)
        return 2
    try:
        from llm_consensus_tpu_torch.ops.kernels import build
        from llm_consensus_tpu_torch.ops.kernels import decode_attention as da
        from llm_consensus_tpu_torch.ops.kernels import flash_attention as fa
    except ImportError as err:
        print(f"error: run from the repository root ({err})", file=sys.stderr)
        return 2

    # Only the modes phase's config-file run reads a config file: no ambient
    # ~/.llm-consensus.json changes any other phase.
    os.environ["LLMC_CONFIG"] = "0"
    t_start = time.monotonic()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.monotonic()
    build.ensure_built()
    log(f"build: {time.monotonic() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    flash_rec: dict = {}
    decode_rec: dict = {}
    int8_rec: dict = {}
    w8a8_rec: dict = {}
    state_recs: dict = {key: {} for key, _, _ in STATE_VARIANTS}
    rows16_recs: dict = {"decode_attention_b16": {}, "decode_attention_state_b16": {}}
    records = [flash_rec, decode_rec, int8_rec, w8a8_rec, *state_recs.values(),
               *rows16_recs.values()]
    mixtral_recs = {"flash": flash_rec, "int8": int8_rec, "w8a8": w8a8_rec}
    if args.phase == "mixtral":
        # The Mixtral phases alone: no ok line.
        run_mixtral(torch, fa, da, args.seed, mixtral_recs)
        print(card, flush=True)
        return 0
    if args.phase == "telemetry":
        # The telemetry phase alone: no ok line.
        run_telemetry(torch, fa, da)
        print(card, flush=True)
        return 0
    if args.phase == "modes":
        # The modes phase alone: no ok line.
        run_modes(torch, fa, da, card)
        print(card, flush=True)
        return 0
    if args.phase == "session":
        # The session phase alone: no ok line.
        run_session(torch, fa, da, card, args.seed)
        print(card, flush=True)
        return 0
    if args.phase == "serving":
        # The B = 16 kernel rows and the serving phase: no ok line.
        check_decode_rows16(torch, rows16_recs)
        run_serving(torch, fa, da, card, args.seed, rows16_recs)
        print(json.dumps({"kernels": list(rows16_recs.values())}), flush=True)
        print(card, flush=True)
        return 0
    check_flash(torch, flash_rec)
    check_decode(torch, decode_rec)
    check_decode_int8(torch, int8_rec, w8a8_rec)
    check_decode_state(torch, state_recs)
    check_decode_rows16(torch, rows16_recs)
    check_int8_matmul(torch)
    if args.phase == "kernels":
        # Kernel checks only: the main path did not run, so no ok line.
        print(json.dumps({"kernels": records}), flush=True)
        print(card, flush=True)
        return 0

    check_small_model(torch, args.seed)
    sl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES},
                   {}, "slice")
    flash_rec["launches"] = sl["launches"]["flash_attention"]
    decode_rec["launches"] = sl["launches"]["decode_attention"]
    if min(sl["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the slice never launched: {sl['launches']}")
    run_chunked(torch, fa, da, sl["engines"]["llama-3-8b"], args.seed)
    engine = sl["engines"]["llama-3-8b"]
    ours = profile_decode(torch, engine, counter=da.LAUNCHES)
    # The bf16 decode is one launch per call: no merge kernel beside it.
    if ours:
        check_one_launch_per_step(ours, "decode_bf16_kernel", "decode_q8_kernel", da.LAUNCHES,
                                  engine.cfg.n_layers, "bf16 decode profile")
    del engine
    single_responses = sl["responses"]
    del sl
    release_engines(torch, {})

    bsl = run_batched_slice(torch, fa, da, single_responses)
    state_recs["bf16"]["launches"] = bsl["launches"]["decode_attention_state"]
    run_batched_engine(torch, fa, da, bsl["engines"]["llama-3-8b"], state_recs)
    modes = bsl["modes"]
    del bsl
    release_engines(torch, modes)
    run_telemetry(torch, fa, da)
    run_modes(torch, fa, da, card)
    run_session(torch, fa, da, card, args.seed)
    run_serving(torch, fa, da, card, args.seed, rows16_recs)

    qsl = run_slice(torch, {"flash_attention": fa.LAUNCHES, "decode_attention": da.LAUNCHES,
                            "decode_attention_int8": da.LAUNCHES_INT8},
                    {"LLMC_QUANT": "int8", "LLMC_KV_QUANT": "int8"}, "quantized slice")
    int8_rec["launches"] = qsl["launches"]["decode_attention_int8"]
    if (qsl["launches"]["flash_attention"] <= 0 or int8_rec["launches"] <= 0
            or qsl["launches"]["decode_attention"] != 0):
        raise AssertionError(f"quantized slice routing: {qsl['launches']}")
    engine = qsl["engines"]["llama-3-8b"]
    ours = profile_decode(torch, engine, "profile int8", counter=da.LAUNCHES_INT8)
    # The int8 decode is one launch per call too: one q8 kernel a (layer, step).
    if ours:
        check_one_launch_per_step(ours, "decode_q8_kernel", "decode_bf16_kernel",
                                  da.LAUNCHES_INT8, engine.cfg.n_layers, "int8 decode profile")
    del engine
    modes = qsl["modes"]
    del qsl
    release_engines(torch, modes)

    run_long_context(torch, fa, da, args.seed)
    w8a8_rec["launches"] = run_engine_phase(
        torch, fa, da, "w8a8", da.LAUNCHES_W8A8, args.seed, quant="int8", kv_quant="int8",
        w8a8=True, decode_w8a8=True)
    run_engine_phase(torch, fa, da, "int4", da.LAUNCHES, args.seed, quant="int4")
    run_mixtral(torch, fa, da, args.seed, mixtral_recs)
    log(f"all phases: {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
